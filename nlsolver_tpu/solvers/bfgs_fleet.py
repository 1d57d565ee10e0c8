"""Batch-minor BFGS fleet: B independent minimizations as one lane-parallel
program.

The vmapped ``solvers.bfgs`` path stores the fleet as [B, n] / [B, n, n]
and contracts over the short trailing n.  This driver keeps the FLEET on
the trailing (lane) axis end-to-end — points [n, B], inverse Hessians
[n, n, B] — so the direction matvec, the More-Thuente recurrence, and the
rank-2 update are B-wide elementwise ops for any n (the same layout rule
as solvers/de_batched.py and ops/smallchol.py).

Algorithm parity with the reference ``BFGS`` (nlsolver.h:3169-3286), with
one loop rotation: the next search direction d' = -H'g is computed in the
same pass that applies the rank-2 update (ops/rank2.py batch-minor update),
so the O(n^2 B) tensor is read once per iteration instead of twice.  The
curvature self-heal (H=I, d=-g on <g,d> > 0 / NaN / grad-norm increase;
nlsolver.h:3253-3260) becomes a per-lane ``pending_reset`` flag consumed
inside the next update — the identity substitution costs no extra
memory pass.

Termination per lane on max_iter, ||g|| < eps, |delta ||g||| < eps, or inf
(nlsolver.h:3239-3241); finished lanes are frozen in the shared while_loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core import make_result
from ..linesearch.more_thuente import more_thuente_fleet
from ..linesearch.speculative import DEFAULT_GRID, speculative_fleet
from ..ops.rank2 import rank2_direction_batchminor


@dataclass(frozen=True)
class BFGSFleetConfig:
    """Defaults from nlsolver.h:3181-3184."""

    max_iter: int = 100
    grad_eps: float = 5e-3
    alpha: float = 1.0
    # "more_thuente" (reference cvsrch recurrence, depth <= 20 dependent
    # evaluations) or "speculative" (one batched K-trial grid evaluation
    # per iteration — depth 1; the latency-bound-fleet redesign,
    # linesearch/speculative.py)
    linesearch: str = "more_thuente"
    ls_grid: tuple = DEFAULT_GRID


class BFGSFleetState(NamedTuple):
    x: jax.Array              # [n, B]
    gradient: jax.Array       # [n, B]
    inv_hessian: jax.Array    # [n, n, B]
    direction: jax.Array      # [n, B] — next search direction (carried)
    pending_reset: jax.Array  # [B] bool — substitute H=I in the next update
    prev_grad_norm: jax.Array  # [B]
    grad_norm: jax.Array       # [B]
    iteration: jax.Array       # [B] int32
    nfev: jax.Array            # [B] int32
    gfev: jax.Array            # [B] int32
    done: jax.Array            # [B] bool
    converged: jax.Array       # [B] bool


def lane_where(pred, on_true, on_false):
    """tree_where with the predicate aligned to the TRAILING (lane) axis."""

    def pick(a, b):
        a = jnp.asarray(a)
        p = pred.reshape((1,) * (a.ndim - 1) + (-1,))
        return jnp.where(p, a, b)

    return jax.tree_util.tree_map(pick, on_true, on_false)


def colwise(fn):
    """Lift a scalar objective ``[n] -> ()`` to columns ``[n, B] -> [B]``."""
    return jax.vmap(fn, in_axes=1, out_axes=0)


def grad_colwise(fn_cols):
    """Per-column gradients ``[n, B] -> [n, B]`` of a column objective.

    Columns are independent, so grad of the lane-sum is the per-lane
    gradient — one reverse pass over the whole fleet, no vmap axis moves.
    """
    return jax.grad(lambda X: jnp.sum(fn_cols(X)))


def init(fn_cols, X0, config: BFGSFleetConfig) -> BFGSFleetState:
    n, B = X0.shape
    G0 = grad_colwise(fn_cols)(X0)
    return BFGSFleetState(
        x=X0,
        gradient=G0,
        inv_hessian=jnp.broadcast_to(
            jnp.eye(n, dtype=X0.dtype)[:, :, None], (n, n, B)
        ),
        direction=-G0,
        pending_reset=jnp.zeros((B,), bool),
        prev_grad_norm=jnp.full((B,), 1e9, X0.dtype),
        grad_norm=jnp.full((B,), 1e8, X0.dtype),
        iteration=jnp.zeros((B,), jnp.int32),
        nfev=jnp.full((B,), 2, jnp.int32),  # g0 costs 1 f + 1 g (autodiff)
        gfev=jnp.ones((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
        converged=jnp.zeros((B,), bool),
    )


def step(fn_cols, state: BFGSFleetState, config: BFGSFleetConfig) -> BFGSFleetState:
    grad_cols = grad_colwise(fn_cols)

    hit_tol = state.grad_norm < config.grad_eps
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | (jnp.abs(state.grad_norm - state.prev_grad_norm) < config.grad_eps)
        | jnp.isinf(state.grad_norm)
    )
    halted = state._replace(
        done=jnp.ones_like(state.done), converged=hit_tol
    )

    g, d = state.gradient, state.direction
    f0 = fn_cols(state.x)
    if config.linesearch == "speculative":
        ls = speculative_fleet(
            fn_cols, grad_cols, state.x, f0, g, d, config.alpha,
            grid=config.ls_grid,
        )
    elif config.linesearch == "more_thuente":
        ls = more_thuente_fleet(
            fn_cols, grad_cols, state.x, f0, g, d, config.alpha
        )
    else:
        raise ValueError(
            f"unknown linesearch {config.linesearch!r}; "
            f"'more_thuente' or 'speculative'"
        )
    s = ls.alpha * d
    new_x = state.x + s
    new_g = grad_cols(new_x)
    new_norm = jnp.sqrt(jnp.sum(new_g * new_g, axis=0))

    y = new_g - g
    # curvature guard (advisor finding, round 4): a failed line search
    # (alpha=0 => s=y=0) or negative curvature would make rho infinite and
    # store a non-finite inv_hessian; rho=0 makes the rank-2 update a
    # no-op and the explicit reset below restores steepest descent
    sy = jnp.sum(y * s, axis=0)
    # strictly-positive is not enough: a positive SUBNORMAL sy (possible
    # when alpha ~ 1e-20) still overflows 1/sy to inf; the smallest
    # normal keeps the reciprocal finite (1/tiny ~ 8.5e37 < f32 max)
    curv_ok = sy > jnp.asarray(jnp.finfo(sy.dtype).tiny, sy.dtype)
    rho = jnp.where(curv_ok, 1.0 / jnp.where(curv_ok, sy, 1.0), 0.0)
    new_H, d_raw = rank2_direction_batchminor(
        state.inv_hessian,
        s,
        y,
        new_g,
        rho,
        state.pending_reset,
    )
    phi = jnp.sum(new_g * d_raw, axis=0)
    need_reset = (
        (phi > 0) | jnp.isnan(phi) | (new_norm > state.grad_norm) | ~curv_ok
    )
    d_next = jnp.where(need_reset[None, :], -new_g, d_raw)

    worked = BFGSFleetState(
        x=new_x,
        gradient=new_g,
        inv_hessian=new_H,
        direction=d_next,
        pending_reset=need_reset,
        prev_grad_norm=state.grad_norm,
        grad_norm=new_norm,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + 2 * ls.nfev + 1,  # trials cost f+g each; +f0 +g_new
        gfev=state.gfev + ls.nfev + 1,
        done=jnp.zeros_like(state.done),
        converged=jnp.zeros_like(state.converged),
    )
    return lane_where(done_now, halted, worked)


def drive_fleet(step_fn, state: BFGSFleetState) -> BFGSFleetState:
    return lax.while_loop(
        lambda s: jnp.any(~s.done),
        lambda s: lane_where(s.done, s, step_fn(s)),
        state,
    )


def minimize_fleet(fn_cols, X0, config: BFGSFleetConfig = BFGSFleetConfig()):
    """Minimize B independent instances; ``fn_cols: [n, B] -> [B]``.

    ``X0`` is [n, B] (batch-minor).  Returns a SolverResult whose fields are
    per-lane arrays and whose ``x`` stays [n, B].
    """
    state = init(fn_cols, X0, config)
    state = drive_fleet(lambda s: step(fn_cols, s, config), state)
    return make_result(
        x=state.x,
        f_value=fn_cols(state.x),
        iterations=state.iteration,
        function_calls=state.nfev + 1,
        gradient_calls=state.gfev,
        converged=state.converged,
    )
