"""Batch-minor nonlinear least-squares fleet (Levenberg-Marquardt).

``solvers.nlls.fit_batched`` vmaps the scalar fit — the whole fleet rides
the LEADING axis, so the per-iteration small-matrix work ([m, n] QR or
[n, n] Cholesky per instance) leaves XLA a batch of tiny factorizations.
This driver keeps the fleet on the TRAILING (lane) axis end-to-end
(residuals [m, B], Jacobians [m, n, B], normal matrices [n, n, B] — the
repo's batch-minor layout rule, CLAUDE.md "performance layouts") and
plugs in the lane-native factorizations:

  * ``solve="cholesky"`` — damped normal equations via the unrolled
    batch-minor Cholesky (ops/smallchol.py); J^T J and J^T r are taken at
    ``Precision.HIGHEST`` (a TF32 product would cost the normal equations
    their f32 accuracy on GPUs);
  * ``solve="qr"`` — the augmented system [J; sqrt(lam) I] through the
    Sameh-Kuck wavefront least squares (linalg/qr_parallel.py) —
    avoids squaring the condition number.

Algorithm identical to ``solvers.nlls`` (Gauss-Newton J^T J with the
lambda accept/reject schedule; the reference's damped-Hessian intent,
nlsolver.h:296-330, :3529-3533): a rejected step keeps x and raises
lambda.  Per-lane termination on cost-delta / gradient-norm / max_iter;
finished lanes are frozen in the shared while_loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import make_result
from ..core.utils import HIGHEST
from ..ops.smallchol import solve_spd_batchminor


@dataclass(frozen=True)
class NLLSFleetConfig:
    lambda0: float = 10.0
    upward_mult: float = 10.0
    downward_mult: float = 10.0
    max_iter: int = 100
    f_delta: float = 1e-12
    grad_eps: float = 1e-12
    # stall ceiling (advisor finding, round 4): a lane whose steps are all
    # rejected after its last improvement keeps a fixed |prev_cost-cost|
    # and would spin (2 fleet-wide evaluations/iter) until max_iter; every
    # rejection multiplies lam by upward_mult, so a ceiling halts the lane
    # after ~log(lambda_max/lambda0)/log(upward_mult) rejections,
    # converged=False
    lambda_max: float = 1e12
    solve: str = "cholesky"          # cholesky | qr


class NLLSFleetState(NamedTuple):
    x: jax.Array          # [n, B]
    cost: jax.Array       # [B]
    prev_cost: jax.Array  # [B]
    lam: jax.Array        # [B]
    iteration: jax.Array  # [B] int32
    nfev: jax.Array       # [B] int32
    jev: jax.Array        # [B] int32
    done: jax.Array       # [B] bool
    converged: jax.Array  # [B] bool


def _lane_where(pred, a, b):
    def pick(x, y):
        x = jnp.asarray(x)
        p = pred.reshape((1,) * (x.ndim - 1) + (-1,))
        return jnp.where(p, x, y)

    return jax.tree_util.tree_map(pick, a, b)


def _residuals_bm(residual_fn, X, data):
    """Per-lane residuals/Jacobians in batch-minor layout.

    residual_fn(x [n], data_i) -> [m]; X [n, B]; data leaves lead with B.
    Returns r [m, B], J [m, n, B] via one vmapped jacfwd (m >= n fits).
    """
    if data is None:
        r = jax.vmap(residual_fn, in_axes=1, out_axes=1)(X)
        J = jax.vmap(jax.jacfwd(residual_fn), in_axes=1, out_axes=2)(X)
    else:
        r = jax.vmap(residual_fn, in_axes=(1, 0), out_axes=1)(X, data)
        J = jax.vmap(
            jax.jacfwd(residual_fn, argnums=0), in_axes=(1, 0), out_axes=2
        )(X, data)
    return r, J


def _cost_bm(residual_fn, X, data):
    if data is None:
        r = jax.vmap(residual_fn, in_axes=1, out_axes=1)(X)
    else:
        r = jax.vmap(residual_fn, in_axes=(1, 0), out_axes=1)(X, data)
    return jnp.sum(r * r, axis=0)


def _delta(r, J, lam, config: NLLSFleetConfig):
    """Solve the damped LM system for every lane, [n, B] out."""
    m, n, B = J.shape
    if config.solve == "qr":
        eye = jnp.eye(n, dtype=J.dtype)[:, :, None]
        damp = jnp.sqrt(lam)[None, None, :] * eye              # [n, n, B]
        A_aug = jnp.concatenate([J, damp], axis=0)             # [m+n, n, B]
        y_aug = jnp.concatenate(
            [r, jnp.zeros((n, B), r.dtype)], axis=0
        )
        from ..linalg.qr_parallel import least_squares_parallel

        return least_squares_parallel(A_aug, y_aug)
    if config.solve != "cholesky":
        raise ValueError(
            f"unknown solve {config.solve!r}; cholesky | qr"
        )
    JtJ = jnp.einsum("mi...,mj...->ij...", J, J, precision=HIGHEST)  # [n, n, B]
    g = jnp.einsum("mi...,m...->i...", J, r, precision=HIGHEST)      # [n, B]
    eye = jnp.eye(n, dtype=J.dtype)[:, :, None]
    return solve_spd_batchminor(JtJ + lam[None, None, :] * eye, g)


def init(residual_fn, X0, config: NLLSFleetConfig, data=None) -> NLLSFleetState:
    n, B = X0.shape
    cost = _cost_bm(residual_fn, X0, data)
    return NLLSFleetState(
        x=X0,
        cost=cost,
        prev_cost=jnp.full((B,), jnp.inf, X0.dtype),
        lam=jnp.full((B,), config.lambda0, X0.dtype),
        iteration=jnp.zeros((B,), jnp.int32),
        nfev=jnp.ones((B,), jnp.int32),
        jev=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
        converged=jnp.zeros((B,), bool),
    )


def step(
    residual_fn, state: NLLSFleetState, config: NLLSFleetConfig, data=None
) -> NLLSFleetState:
    r, J = _residuals_bm(residual_fn, state.x, data)
    g = jnp.einsum("mi...,m...->i...", J, r, precision=HIGHEST)      # [n, B]
    gnorm = jnp.sqrt(jnp.sum(g * g, axis=0))

    hit_tol = (jnp.abs(state.prev_cost - state.cost) < config.f_delta) | (
        gnorm < config.grad_eps
    )
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | jnp.isnan(state.cost)
        | (state.lam > config.lambda_max)
    )
    halted = state._replace(
        done=jnp.ones_like(state.done), converged=hit_tol
    )

    delta = _delta(r, J, state.lam, config)
    x_try = state.x - delta
    cost_try = _cost_bm(residual_fn, x_try, data)
    improved = cost_try < state.cost

    worked = NLLSFleetState(
        x=jnp.where(improved[None, :], x_try, state.x),
        cost=jnp.where(improved, cost_try, state.cost),
        prev_cost=jnp.where(improved, state.cost, state.prev_cost),
        lam=jnp.where(
            improved,
            state.lam / config.downward_mult,
            state.lam * config.upward_mult,
        ),
        iteration=state.iteration + 1,
        nfev=state.nfev + 2,
        jev=state.jev + 1,
        done=jnp.zeros_like(state.done),
        converged=jnp.zeros_like(state.converged),
    )
    return _lane_where(done_now, halted, worked)


def fit_fleet(
    residual_fn: Callable,
    X0: jax.Array,                    # [n, B] batch-minor start points
    config: NLLSFleetConfig = NLLSFleetConfig(),
    data: Optional[jax.Array] = None,  # per-instance pytree, leading dim B
):
    """Minimize ``||residual_fn(x_b, data_b)||^2`` for every lane b.

    Returns a SolverResult with per-lane fields; ``x`` stays [n, B]."""
    state = init(residual_fn, X0, config, data)
    state = lax.while_loop(
        lambda s: jnp.any(~s.done),
        lambda s: _lane_where(s.done, s, step(residual_fn, s, config, data)),
        state,
    )
    return make_result(
        x=state.x,
        f_value=state.cost,
        iterations=state.iteration,
        function_calls=state.nfev,
        gradient_calls=state.jev,
        converged=state.converged,
    )
