"""BFGS (inverse-Hessian form) with More-Thuente line search.

Re-creation of the reference's ``BFGS`` class (nlsolver.h:3169-3286):

  * search direction d = -H^-1 g as one matvec (the reference's row-dot
    loop, nlsolver.h:3248-3251);
  * self-healing reset H=I, d=-g when curvature is lost (<g,d> > 0), NaN
    appears, or the gradient norm increased (nlsolver.h:3253-3260);
  * More-Thuente search from alpha=1 (nlsolver.h:3262-3264);
  * termination on max_iter, ||g|| < eps, |Δ||g||| < eps, or inf
    (nlsolver.h:3239-3241);
  * the rank-2 inverse-Hessian update is the CORRECT BFGS formula
      H' = H - rho (s (y^T H) + (H y) s^T) + rho (1 + rho y^T H y) s s^T
    in fused matrix form.  The reference's hand-rolled loop
    (update_inverse_hessian, nlsolver.h:3151-3163) subtracts the final
    s s^T term instead of adding it — a sign bug its reset path papers
    over; reproduce it with ``reference_update=True`` if trajectory parity
    is ever needed.

This step vmaps over thousands of problem instances; solvers/bfgs_fleet.py
is the batch-minor layout of the same algorithm for large fleets.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import Bounds, Objective, SolverResult, drive, make_result, signed
from ..core.utils import HIGHEST
from ..deriv import Deriv, make_grad
from ..linesearch import more_thuente


@dataclass(frozen=True)
class BFGSConfig:
    """Defaults from nlsolver.h:3181-3184."""

    max_iter: int = 100
    grad_eps: float = 5e-3
    alpha: float = 1.0
    deriv: Deriv = field(default_factory=Deriv)
    reference_update: bool = False  # reproduce the reference's sign quirk


class BFGSState(NamedTuple):
    x: jax.Array
    gradient: jax.Array
    inv_hessian: jax.Array   # [n, n]
    prev_grad_norm: jax.Array
    grad_norm: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    gfev: jax.Array
    done: jax.Array
    converged: jax.Array


def init(fn: Objective, x0: jax.Array, config: BFGSConfig) -> BFGSState:
    n = x0.shape[-1]
    grad_fn, g_cost = make_grad(fn, n, config.deriv)
    g = grad_fn(x0)
    return BFGSState(
        x=x0,
        gradient=g,
        inv_hessian=jnp.eye(n, dtype=x0.dtype),
        prev_grad_norm=jnp.asarray(1e9, x0.dtype),
        grad_norm=jnp.asarray(1e8, x0.dtype),
        iteration=jnp.int32(0),
        nfev=jnp.int32(g_cost),
        gfev=jnp.int32(1),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def rank2_update(H, s, y, rho, reference_quirk: bool = False):
    """BFGS inverse-Hessian rank-2 update (batched-friendly pure form)."""
    Hy = jnp.matmul(H, y, precision=HIGHEST)
    yHy = jnp.dot(y, Hy, precision=HIGHEST)
    if reference_quirk:
        # nlsolver.h:3143-3163, reproduced with the reference's exact
        # arithmetic order for trajectory parity: denom = (yHy*rho) + 1,
        # H[j,i] -= rho*((s[i]*Hy[j] + Hy[i]*s[j]) + denom*s[i]*s[j]) —
        # all three terms subtracted (the s s^T term has the wrong sign
        # relative to the Sherman-Morrison form).
        denom = yHy * rho + 1.0
        T = (jnp.outer(Hy, s) + jnp.outer(s, Hy)) + jnp.outer(s, denom * s)
        return H - rho * T
    coef = rho * (1.0 + rho * yHy)
    sym = jnp.outer(s, Hy) + jnp.outer(Hy, s)
    return H - rho * sym + coef * jnp.outer(s, s)


def step(fn: Objective, state: BFGSState, config: BFGSConfig) -> BFGSState:
    n = state.x.shape[-1]
    grad_fn, g_cost = make_grad(fn, n, config.deriv)

    hit_tol = state.grad_norm < config.grad_eps
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | (jnp.abs(state.grad_norm - state.prev_grad_norm) < config.grad_eps)
        | jnp.isinf(state.grad_norm)
    )
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol)

    g = state.gradient
    d = -jnp.matmul(state.inv_hessian, g, precision=HIGHEST)
    phi = jnp.dot(g, d, precision=HIGHEST)
    need_reset = (
        (phi > 0) | jnp.isnan(phi) | (state.grad_norm > state.prev_grad_norm)
    )
    H = jnp.where(need_reset, jnp.eye(n, dtype=state.x.dtype), state.inv_hessian)
    d = jnp.where(need_reset, -g, d)

    f0 = fn(state.x)
    ls = more_thuente(fn, grad_fn, state.x, f0, g, d, config.alpha)
    s = ls.alpha * d
    new_x = state.x + s
    new_grad = grad_fn(new_x)
    new_norm = jnp.linalg.norm(new_grad)

    y = new_grad - g
    rho = 1.0 / jnp.dot(y, s, precision=HIGHEST)
    new_H = rank2_update(H, s, y, rho, config.reference_update)

    worked = BFGSState(
        x=new_x,
        gradient=new_grad,
        inv_hessian=new_H,
        prev_grad_norm=state.grad_norm,
        grad_norm=new_norm,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev * (1 + g_cost) + g_cost,
        gfev=state.gfev + ls.nfev + 1,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(fn, state: BFGSState, flip_sign: bool) -> SolverResult:
    f_val = fn(state.x)
    return make_result(
        x=state.x,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev + 1,
        gradient_calls=state.gfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: BFGSConfig = BFGSConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,
    _minimize: bool = True,
) -> SolverResult:
    # the reference static_asserts minimize-only (nlsolver.h:3199); here
    # maximization is simply minimization of -f
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config)
    state = drive(lambda s: step(sfn, s, config), state)
    return _finalize(sfn, state, flip_sign=not _minimize)


def maximize(fn, x0, config: BFGSConfig = BFGSConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
