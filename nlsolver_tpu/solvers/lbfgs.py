"""Limited-memory BFGS with optional box projection.

The reference lists "L-BFGS-B/BFGS-B" as a TODO (changelist.txt:1-8); this
implements L-BFGS with the standard two-loop recursion over a fixed-size
history ring (static shapes — jit/vmap friendly), More-Thuente line search,
and an optional projected-gradient box mode (iterates and search clipped to
bounds; the simple projection scheme, not the full Byrd-Lu-Nocedal-Zhu
active-set algorithm).

History is stored as [m, n] rings with a validity mask, so the two-loop
recursion is a ``lax.fori_loop`` over static m with masked contributions —
no dynamic shapes, vmaps over thousands of instances.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import Bounds, Objective, SolverResult, drive, make_result, signed
from ..core.utils import HIGHEST
from ..deriv import Deriv, make_grad
from ..linesearch import more_thuente


@dataclass(frozen=True)
class LBFGSConfig:
    memory: int = 10
    max_iter: int = 200
    grad_eps: float = 1e-8
    alpha: float = 1.0
    deriv: Deriv = field(default_factory=Deriv)


class LBFGSState(NamedTuple):
    x: jax.Array
    gradient: jax.Array
    s_hist: jax.Array      # [m, n]
    y_hist: jax.Array      # [m, n]
    rho_hist: jax.Array    # [m]
    valid: jax.Array       # [m] bool
    head: jax.Array        # ring insert position
    iteration: jax.Array
    nfev: jax.Array
    gfev: jax.Array
    done: jax.Array
    converged: jax.Array


def two_loop_direction(g, s_hist, y_hist, rho_hist, valid, head):
    """Two-loop recursion d = -H g with ring-ordered masked history."""
    m = s_hist.shape[0]

    # iterate newest -> oldest: index head-1, head-2, ...
    def first_loop(i, carry):
        q, alphas = carry
        idx = (head - 1 - i) % m
        ok = valid[idx]
        alpha = jnp.where(ok, rho_hist[idx] * jnp.dot(s_hist[idx], q, precision=HIGHEST), 0.0)
        q = q - alpha * y_hist[idx]
        return q, alphas.at[idx].set(alpha)

    q, alphas = lax.fori_loop(
        0, m, first_loop, (g, jnp.zeros(m, g.dtype))
    )

    # initial Hessian scaling gamma = s.y / y.y of the newest pair
    newest = (head - 1) % m
    ys = jnp.dot(s_hist[newest], y_hist[newest], precision=HIGHEST)
    yy = jnp.dot(y_hist[newest], y_hist[newest], precision=HIGHEST)
    gamma = jnp.where(valid[newest] & (yy > 0), ys / yy, 1.0)
    r = gamma * q

    # oldest -> newest
    def second_loop(i, r):
        idx = (head + i) % m
        ok = valid[idx]
        beta = jnp.where(ok, rho_hist[idx] * jnp.dot(y_hist[idx], r, precision=HIGHEST), 0.0)
        return r + (alphas[idx] - beta) * s_hist[idx]

    r = lax.fori_loop(0, m, second_loop, r)
    return -r


def init(fn: Objective, x0: jax.Array, config: LBFGSConfig) -> LBFGSState:
    n = x0.shape[-1]
    m = config.memory
    grad_fn, g_cost = make_grad(fn, n, config.deriv)
    g = grad_fn(x0)
    return LBFGSState(
        x=x0,
        gradient=g,
        s_hist=jnp.zeros((m, n), x0.dtype),
        y_hist=jnp.zeros((m, n), x0.dtype),
        rho_hist=jnp.zeros((m,), x0.dtype),
        valid=jnp.zeros((m,), bool),
        head=jnp.int32(0),
        iteration=jnp.int32(0),
        nfev=jnp.int32(g_cost),
        gfev=jnp.int32(1),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(
    fn: Objective,
    state: LBFGSState,
    config: LBFGSConfig,
    lower=None,
    upper=None,
) -> LBFGSState:
    n = state.x.shape[-1]
    m = config.memory
    grad_fn, g_cost = make_grad(fn, n, config.deriv)
    bounded = lower is not None

    g = state.gradient
    if bounded:
        # projected gradient: zero components pushing outside the active box
        at_lo = (state.x <= lower) & (g > 0)
        at_hi = (state.x >= upper) & (g < 0)
        pg = jnp.where(at_lo | at_hi, 0.0, g)
    else:
        pg = g
    grad_norm = jnp.linalg.norm(pg)

    hit_tol = grad_norm < config.grad_eps
    done_now = (state.iteration >= config.max_iter) | hit_tol | jnp.isinf(grad_norm)
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol)

    d = two_loop_direction(
        pg, state.s_hist, state.y_hist, state.rho_hist, state.valid, state.head
    )
    # safeguard: fall back to steepest descent on loss of descent
    descent = jnp.dot(pg, d, precision=HIGHEST) < 0
    d = jnp.where(descent, d, -pg)

    f0 = fn(state.x)
    ls = more_thuente(fn, grad_fn, state.x, f0, g, d, config.alpha)
    s = ls.alpha * d
    new_x = state.x + s
    if bounded:
        new_x = jnp.clip(new_x, lower, upper)
        s = new_x - state.x
    new_g = grad_fn(new_x)
    y = new_g - g

    ys = jnp.dot(y, s, precision=HIGHEST)
    good_pair = ys > 1e-10
    idx = state.head % m
    s_hist = state.s_hist.at[idx].set(jnp.where(good_pair, s, state.s_hist[idx]))
    y_hist = state.y_hist.at[idx].set(jnp.where(good_pair, y, state.y_hist[idx]))
    rho_hist = state.rho_hist.at[idx].set(
        jnp.where(good_pair, 1.0 / ys, state.rho_hist[idx])
    )
    valid = state.valid.at[idx].set(good_pair | state.valid[idx])
    head = jnp.where(good_pair, state.head + 1, state.head)

    worked = LBFGSState(
        x=new_x,
        gradient=new_g,
        s_hist=s_hist,
        y_hist=y_hist,
        rho_hist=rho_hist,
        valid=valid,
        head=head,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev * (1 + g_cost) + g_cost,
        gfev=state.gfev + ls.nfev + 1,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: LBFGSConfig = LBFGSConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,
    _minimize: bool = True,
) -> SolverResult:
    sfn = signed(fn, _minimize)
    if bounds is not None:
        lower = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape)
        upper = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape)
        x0 = jnp.clip(x0, lower, upper)
    else:
        lower = upper = None
    state = init(sfn, x0, config)
    state = drive(lambda s: step(sfn, s, config, lower, upper), state)
    f_val = sfn(state.x)
    return make_result(
        x=state.x,
        f_value=-f_val if not _minimize else f_val,
        iterations=state.iteration,
        function_calls=state.nfev + 1,
        gradient_calls=state.gfev,
        converged=state.converged,
    )


def maximize(fn, x0, config: LBFGSConfig = LBFGSConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
