"""Levenberg-Marquardt (damped-Hessian form on a scalar objective).

Re-creation of the reference's ``LevenbergMarquardt`` (nlsolver.h:3428-3545).
Note this is NOT the residual-Jacobian Gauss-Newton LM (that variant lives
in ``solvers/nlls.py``); like the reference it damps the full Hessian of a
scalar objective:

  * solve (H + lambda I) u = g each iteration (nlsolver.h:3529-3533; the
    reference dispatches between a diagonal fast path and an in-place
    Cholesky — here one Cholesky solve covers both, and a non-PD system
    yields NaNs which terminate exactly like the reference's garbage-solve
    path);
  * x <- x - u; lambda /= down on improvement, *= up otherwise
    (nlsolver.h:3534-3542);
  * termination on max_iter, |f_prev - f| < f_delta, or NaN
    (nlsolver.h:3520-3527);
  * default derivative provider is autodiff (jax.grad / jax.hessian); the
    reference burns 16 n^2 objective evaluations per FD Hessian.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import Bounds, Objective, SolverResult, drive, make_result, signed
from ..deriv import Deriv, make_grad, make_hessian
from ..linalg.solve import damped_solve as _damped_solve


@dataclass(frozen=True)
class LMConfig:
    """Defaults from nlsolver.h:3443-3447."""

    lambda0: float = 10.0
    upward_mult: float = 10.0
    downward_mult: float = 10.0
    max_iter: int = 100
    f_delta: float = 1e-12
    deriv: Deriv = field(default_factory=Deriv)
    # "default": damped Cholesky solve (damped_solve).  "reference":
    # trajectory parity with get_update_with_hessian (nlsolver.h:296-330):
    #   * its diagonality test has no abs() (`A[i*n+j] > eps*1e12`, :301-302),
    #     so a Hessian whose off-diagonals are all <= ~2.2e-4 — including
    #     large NEGATIVE ones (e.g. Rosenbrock's -400x cross term for x > 0) —
    #     takes the elementwise g_i/H_ii fast path, silently ignoring the
    #     off-diagonal terms;
    #   * otherwise an in-place Cholesky + forward/back solve in the
    #     reference's exact arithmetic order (:252-294).
    variant: str = "default"
    # diagonal-Hessian dispatch for the default variant (see
    # linalg.solve.damped_solve): True = separable objective, always the
    # O(n) elementwise divide; False = always factorize; None = runtime
    # lax.cond mirroring the reference's is_diagonal dispatch
    # (nlsolver.h:310-322, with the missing abs() fixed).
    diagonal: Optional[bool] = None


class LMState(NamedTuple):
    x: jax.Array
    gradient: jax.Array
    hessian: jax.Array
    lam: jax.Array
    prev_f: jax.Array
    cur_f: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    gfev: jax.Array
    hfev: jax.Array
    done: jax.Array
    converged: jax.Array


def damped_solve(hessian: jax.Array, gradient: jax.Array, lam, *, diagonal=None) -> jax.Array:
    """(H + lam I) u = g (reference: get_update_with_hessian,
    nlsolver.h:310-330).  Delegates to :func:`linalg.solve.damped_solve`,
    which carries the diagonal fast path and the small-n unrolled solve."""
    return _damped_solve(hessian, gradient, lam, diagonal=diagonal)


def _reference_damped_solve(H, g, lam):
    """(H + lam I) u = g exactly as the reference computes it
    (nlsolver.h:296-330; see LMConfig.variant docstring).  The static-n
    Python loops unroll at trace time — this path exists for parity testing
    and small n; production fleets use :func:`damped_solve` / ops.smallchol.
    """
    n = g.shape[-1]
    dtype = g.dtype
    Hd = H + lam * jnp.eye(n, dtype=dtype)
    # signed diagonality test (:301-302): no abs()
    thr = float(jnp.finfo(dtype).eps) * 1e12
    off = ~jnp.eye(n, dtype=bool)
    is_diag = ~jnp.any(off & (Hd > thr))
    diag_update = g / jnp.diagonal(Hd)

    # in-place Cholesky (:252-270) with the reference's exact op order,
    # including its (1/A_jj) * (A_ij - sum) reciprocal-then-multiply; the
    # barrier keeps XLA from rewriting it back into a divide
    A = [[Hd[i, j] for j in range(n)] for i in range(n)]
    zero = jnp.asarray(0.0, dtype)
    for i in range(n):
        for j in range(i):
            s = zero
            for k in range(j):
                s = s + A[i][k] * A[j][k]
            rcp = 1.0 / A[j][j]
            A[i][j] = rcp * (A[i][j] - s)
        s = zero
        for k in range(i):
            s = s + A[i][k] * A[i][k]
        # barrier the diagonal: stops XLA from fusing downstream 1/sqrt and
        # y/sqrt into (non-correctly-rounded) rsqrt forms
        A[i][i] = jax.lax.optimization_barrier(jnp.sqrt(A[i][i] - s))
    # forwardsolve_inplace (:283-294)
    u = [None] * n
    for i in range(n):
        s = zero
        for j in range(i):
            s = s + A[i][j] * u[j]
        u[i] = (g[i] - s) / A[i][i]
    # backsolve_inplace_t (:271-282)
    for i in range(n - 1, -1, -1):
        s = zero
        for j in range(i + 1, n):
            s = s + A[j][i] * u[j]
        u[i] = (u[i] - s) / A[i][i]
    chol_update = jnp.stack(u)
    return jnp.where(is_diag, diag_update, chol_update)


def init(fn: Objective, x0: jax.Array, config: LMConfig) -> LMState:
    n = x0.shape[-1]
    grad_fn, g_cost = make_grad(fn, n, config.deriv)
    hess_fn, h_cost = make_hessian(fn, n, config.deriv)
    g = grad_fn(x0)
    H = hess_fn(x0)
    f0 = fn(x0)
    return LMState(
        x=x0,
        gradient=g,
        hessian=H,
        lam=jnp.asarray(config.lambda0, x0.dtype),
        prev_f=jnp.asarray(0.0, x0.dtype),  # reference starts prev at 0 (:3515)
        cur_f=f0,
        iteration=jnp.int32(0),
        nfev=jnp.int32(1 + g_cost + h_cost),
        gfev=jnp.int32(1),
        hfev=jnp.int32(1),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(fn: Objective, state: LMState, config: LMConfig) -> LMState:
    n = state.x.shape[-1]
    grad_fn, g_cost = make_grad(fn, n, config.deriv)
    hess_fn, h_cost = make_hessian(fn, n, config.deriv)

    f_delta = jnp.abs(state.prev_f - state.cur_f)
    hit_tol = f_delta < config.f_delta
    done_now = (
        (state.iteration >= config.max_iter) | hit_tol | jnp.isnan(state.prev_f)
    )
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol)

    if config.variant == "reference":
        update = _reference_damped_solve(state.hessian, state.gradient, state.lam)
    else:
        update = damped_solve(
            state.hessian, state.gradient, state.lam, diagonal=config.diagonal
        )
    new_x = state.x - update
    new_f = fn(new_x)
    new_g = grad_fn(new_x)
    new_H = hess_fn(new_x)
    improved = new_f < state.cur_f
    new_lam = jnp.where(
        improved,
        state.lam / config.downward_mult,
        state.lam * config.upward_mult,
    )

    worked = LMState(
        x=new_x,
        gradient=new_g,
        hessian=new_H,
        lam=new_lam,
        prev_f=state.cur_f,
        cur_f=new_f,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + g_cost + h_cost,
        gfev=state.gfev + 1,
        hfev=state.hfev + 1,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: LMState, flip_sign: bool) -> SolverResult:
    f_val = state.cur_f
    return make_result(
        x=state.x,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        gradient_calls=state.gfev,
        hessian_calls=state.hfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: LMConfig = LMConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,
    _minimize: bool = True,
) -> SolverResult:
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config)
    state = drive(lambda s: step(sfn, s, config), state)
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: LMConfig = LMConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
