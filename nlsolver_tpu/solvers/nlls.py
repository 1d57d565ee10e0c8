"""Nonlinear least squares: residual-Jacobian Levenberg-Marquardt.

The reference's ``LevenbergMarquardt`` damps the full Hessian of a scalar
objective (see ``solvers/lm.py``); for actual least-squares fits the proper
formulation is Gauss-Newton on the residual Jacobian (SURVEY.md §3.4,
"Gauss-Newton J^T J"; BASELINE.json config #5: "Levenberg-
Marquardt batched nonlinear least-squares fits").

    r(x) in R^m,  cost = ||r(x)||^2
    solve (J^T J + lambda I) delta = J^T r,  x <- x - delta on improvement

with true accept/reject (a failed step keeps x and raises lambda — unlike
the reference's always-accept scalar LM).  The Jacobian comes from
``jax.jacfwd`` (forward mode: m >= n is the common fit shape).

``fit_batched`` vmaps thousands of independent fits; ``curve_fit`` is the
scipy-style sugar.  The multi-host path shards the fit batch over the mesh
dp axis (see parallel/nlls_sharded.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import SolverResult, drive, make_result
from ..core.utils import HIGHEST
from ..linalg import damped_solve


@dataclass(frozen=True)
class NLLSConfig:
    lambda0: float = 10.0
    upward_mult: float = 10.0
    downward_mult: float = 10.0
    max_iter: int = 100
    f_delta: float = 1e-12
    grad_eps: float = 1e-12
    # stall ceiling (advisor finding, round 4; same semantics as
    # NLLSFleetConfig.lambda_max): an all-rejections tail spins at fixed
    # |prev_cost-cost| until max_iter; the ceiling halts it after
    # ~log(lambda_max/lambda0)/log(upward_mult) rejections, converged=False
    lambda_max: float = 1e12
    # "cholesky": damped normal equations (J^T J + lam I, linalg.damped_solve
    # — the reference's get_update_with_hessian path, nlsolver.h:296-330);
    # "qr": least-squares on the augmented system [J; sqrt(lam) I] via the
    # batched parallel Givens QR (linalg/qr_parallel.py) — avoids squaring
    # the condition number on near-rank-deficient Jacobians
    solve: str = "cholesky"


class NLLSState(NamedTuple):
    x: jax.Array
    cost: jax.Array
    prev_cost: jax.Array
    lam: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    jev: jax.Array
    done: jax.Array
    converged: jax.Array


def _cost(residual_fn, x):
    r = residual_fn(x)
    return jnp.sum(r * r)


def init(residual_fn: Callable, x0: jax.Array, config: NLLSConfig) -> NLLSState:
    return NLLSState(
        x=x0,
        cost=_cost(residual_fn, x0),
        prev_cost=jnp.asarray(jnp.inf, x0.dtype),
        lam=jnp.asarray(config.lambda0, x0.dtype),
        iteration=jnp.int32(0),
        nfev=jnp.int32(1),
        jev=jnp.int32(0),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(residual_fn: Callable, state: NLLSState, config: NLLSConfig) -> NLLSState:
    r = residual_fn(state.x)
    J = jax.jacfwd(residual_fn)(state.x)      # [m, n]
    g = jnp.matmul(J.T, r, precision=HIGHEST)    # gradient of 0.5*cost
    JtJ = jnp.matmul(J.T, J, precision=HIGHEST)

    hit_tol = (jnp.abs(state.prev_cost - state.cost) < config.f_delta) | (
        jnp.linalg.norm(g) < config.grad_eps
    )
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | jnp.isnan(state.cost)
        | (state.lam > config.lambda_max)
    )
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol)

    if config.solve == "qr":
        from ..linalg.qr_parallel import least_squares_parallel

        n = J.shape[1]
        A_aug = jnp.concatenate(
            [J, jnp.sqrt(state.lam) * jnp.eye(n, dtype=J.dtype)], axis=0
        )
        y_aug = jnp.concatenate([r, jnp.zeros((n,), r.dtype)])
        delta = least_squares_parallel(A_aug, y_aug)
    else:
        delta = damped_solve(JtJ, g, state.lam)
    x_try = state.x - delta
    cost_try = _cost(residual_fn, x_try)
    improved = cost_try < state.cost

    worked = NLLSState(
        x=jnp.where(improved, x_try, state.x),
        cost=jnp.where(improved, cost_try, state.cost),
        # only accepted steps advance the cost-delta criterion; a rejected
        # step would otherwise make |prev-cur| = 0 and fake convergence
        prev_cost=jnp.where(improved, state.cost, state.prev_cost),
        lam=jnp.where(
            improved,
            state.lam / config.downward_mult,
            state.lam * config.upward_mult,
        ),
        iteration=state.iteration + 1,
        nfev=state.nfev + 2,
        jev=state.jev + 1,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: NLLSState) -> SolverResult:
    return make_result(
        x=state.x,
        f_value=state.cost,
        iterations=state.iteration,
        function_calls=state.nfev,
        gradient_calls=state.jev,
        converged=state.converged,
    )


def fit(residual_fn: Callable, x0: jax.Array, config: NLLSConfig = NLLSConfig()) -> SolverResult:
    """Minimize ||residual_fn(x)||^2 from x0."""
    state = init(residual_fn, x0, config)
    state = drive(lambda s: step(residual_fn, s, config), state)
    return _finalize(state)


def fit_batched(
    residual_fn: Callable,
    x0s: jax.Array,             # [B, n]
    config: NLLSConfig = NLLSConfig(),
    data: Optional[tuple] = None,  # optional per-instance pytree, leading dim B
) -> SolverResult:
    """vmap a fleet of independent fits.

    If ``data`` is given, ``residual_fn(x, data_i)`` receives each
    instance's slice — the batched curve-fitting shape.
    """
    if data is None:
        return jax.vmap(lambda x0: fit(residual_fn, x0, config))(x0s)
    return jax.vmap(lambda x0, d: fit(lambda x: residual_fn(x, d), x0, config))(
        x0s, data
    )


def curve_fit(
    model: Callable,            # model(params, t) -> y_hat
    t: jax.Array,
    y: jax.Array,
    p0: jax.Array,
    config: NLLSConfig = NLLSConfig(),
) -> SolverResult:
    """scipy.optimize.curve_fit-style sugar on top of :func:`fit`."""
    return fit(lambda p: model(p, t) - y, p0, config)
