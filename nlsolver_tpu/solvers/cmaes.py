"""CMA-ES (covariance matrix adaptation evolution strategy).

The reference ships only a non-compiling skeleton
(``nlsolver::experimental::CMAES``, nlsolver.h:4321-4579 — uses nonexistent
tinyqr methods and Eigen-style expressions on std::vector; excluded from all
build targets).  Per SURVEY.md §2 it is a *specification of intent*; this is
a real implementation of the standard algorithm (Hansen, "The CMA Evolution
Strategy: A Tutorial", arXiv:1604.00772):

  * the population is one ``[lambda, n]`` matrix; sampling, ranking and the
    rank-mu update are matrix products at ``Precision.HIGHEST``;
  * the eigendecomposition C = B diag(D^2) B^T uses ``jnp.linalg.eigh``
    (the reference's tinyqr iterated-QR eigensolver's role);
  * default hyperparameters follow the tutorial: lambda = 4 + 3 ln n,
    mu = lambda/2 with log-weights, standard cc/cs/c1/cmu/damps.

Termination: max_iter, stagnation of the best value, condition-number
explosion, or step-size collapse (the reference's intent, nlsolver.h:
4566-4574).

Bounds are honored by projection repair: sampled candidates are clamped
into the box before evaluation and the *repaired* step feeds the mean /
path / covariance updates, so the distribution tracks the feasible
region (same clamp-to-bounds semantics as the reference's simplex/PSO
``bound`` paths, nlsolver.h:1986-2007, :2701-2715).

Restart variance kick (reference intent nlsolver.h:4566-4568): when the
top-mu costs collapse within ``kick_tol``, sigma is multiplied by
``exp(0.2 + cs/damps)`` to re-inflate the search distribution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import (
    Bounds,
    Objective,
    SolverResult,
    batch_eval,
    drive,
    make_result,
    signed,
)
from ..core.utils import HIGHEST


@dataclass(frozen=True)
class CMAESConfig:
    pop_size: int = 0          # 0 => 4 + floor(3 ln n)
    sigma0: float = 0.5
    max_iter: int = 500
    f_tol: float = 1e-12       # stagnation tolerance on best value
    best_value_no_change: int = 50
    cond_max: float = 1e14
    # restart variance kick (nlsolver.h:4566-4568): if the top-mu costs
    # span less than kick_tol, sigma *= exp(0.2 + cs/damps).  <= 0 disables.
    kick_tol: float = 1e-6
    # generations of best-value stagnation required before the kick may
    # fire.  The reference kicks on raw collapse, which fights final
    # convergence (late healthy generations also have tiny spread); gating
    # on sustained stagnation keeps the kick for genuine premature
    # collapse (plateaus, needle-in-haystack landscapes).
    kick_patience: int = 10
    # "xla" (jnp.linalg.eigh — best single-instance) or "jacobi" (the
    # batched parallel-order Jacobi, linalg/jacobi.py — use when this
    # solver is vmapped over many instances: XLA's batched eigh is the
    # many-small-matrix case; for large fleets prefer
    # solvers/cmaes_fleet.py outright)
    eigh_method: str = "xla"


class CMAESState(NamedTuple):
    mean: jax.Array          # [n]
    sigma: jax.Array
    C: jax.Array             # [n, n] covariance
    p_sigma: jax.Array       # [n] step-size path
    p_c: jax.Array           # [n] covariance path
    best_x: jax.Array
    best_value: jax.Array
    prev_best: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    no_change: jax.Array
    key: jax.Array
    done: jax.Array
    converged: jax.Array


@lru_cache(maxsize=None)
def _params(n: int, pop_size: int):
    """Strategy constants for (n, pop_size) — computed once per
    configuration with numpy (hoisted out of step, VERDICT r2; plain host
    values, so caching across traces is safe — jnp here would cache
    tracers)."""
    import numpy as np

    lam = pop_size if pop_size > 0 else 4 + int(3 * math.log(n))
    mu = lam // 2
    w_raw = np.log((lam + 1) / 2.0) - np.log(np.arange(1, mu + 1))
    weights = w_raw / np.sum(w_raw)
    mu_eff = float(1.0 / np.sum(weights**2))
    cc = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    cs = (mu_eff + 2) / (n + mu_eff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (n + 1)) - 1) + cs
    chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
    return lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n


def init(fn: Objective, x0: jax.Array, config: CMAESConfig, key: jax.Array) -> CMAESState:
    n = x0.shape[-1]
    f0 = fn(x0)
    return CMAESState(
        mean=x0,
        sigma=jnp.asarray(config.sigma0, x0.dtype),
        C=jnp.eye(n, dtype=x0.dtype),
        p_sigma=jnp.zeros((n,), x0.dtype),
        p_c=jnp.zeros((n,), x0.dtype),
        best_x=x0,
        best_value=f0,
        prev_best=jnp.asarray(jnp.inf, x0.dtype),
        iteration=jnp.int32(0),
        nfev=jnp.int32(1),
        no_change=jnp.int32(0),
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(
    fn: Objective,
    state: CMAESState,
    config: CMAESConfig,
    bounds: Optional[Bounds] = None,
) -> CMAESState:
    n = state.mean.shape[-1]
    dtype = state.mean.dtype
    lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n = _params(
        n, config.pop_size
    )
    weights = weights.astype(dtype)

    # eigendecomposition C = B D^2 B^T
    if config.eigh_method == "jacobi":
        from ..linalg.jacobi import eigh_jacobi

        eigvals, B = eigh_jacobi(state.C)
    else:
        eigvals, B = jnp.linalg.eigh(state.C)
    eigvals = jnp.maximum(eigvals, 1e-20)
    D = jnp.sqrt(eigvals)
    cond = eigvals[-1] / eigvals[0]

    improved = state.best_value < state.prev_best - config.f_tol
    no_change = jnp.where(improved, 0, state.no_change + 1)
    hit_tol = no_change >= config.best_value_no_change
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | (cond > config.cond_max)
        | (state.sigma < 1e-18)
    )
    halted = state._replace(
        no_change=no_change, done=jnp.asarray(True), converged=hit_tol
    )

    key, k_z = jax.random.split(state.key)
    z = jax.random.normal(k_z, (lam, n), dtype)            # [lam, n]
    y = jnp.matmul(z * D[None, :], B.T, precision=HIGHEST)  # ~ N(0, C)
    xs = state.mean[None, :] + state.sigma * y
    if bounds is not None:
        # projection repair: clamp into the box and let the repaired steps
        # drive every update (mean stays feasible: it is a convex
        # combination of repaired candidates)
        xs = jnp.clip(xs, bounds.lower, bounds.upper)
        y = (xs - state.mean[None, :]) / state.sigma
    values = batch_eval(fn, xs)

    order = jnp.argsort(values)
    top = order[:mu]
    y_w = jnp.matmul(weights, y[top], precision=HIGHEST)   # [n] weighted step
    new_mean = state.mean + state.sigma * y_w

    # step-size path: C^{-1/2} y_w = B D^-1 B^T y_w
    c_inv_sqrt_yw = jnp.matmul(
        B, jnp.matmul(B.T, y_w, precision=HIGHEST) / D, precision=HIGHEST
    )
    p_sigma = (1 - cs) * state.p_sigma + jnp.sqrt(
        cs * (2 - cs) * mu_eff
    ) * c_inv_sqrt_yw
    ps_norm = jnp.linalg.norm(p_sigma)
    sigma = state.sigma * jnp.exp((cs / damps) * (ps_norm / chi_n - 1))
    if config.kick_tol > 0:
        # restart variance kick (nlsolver.h:4566-4568): top-mu costs
        # collapsed AND the best value stagnant for kick_patience
        # generations => re-inflate the step size (see CMAESConfig).
        collapsed = (
            jnp.abs(values[order[0]] - values[order[mu - 1]]) < config.kick_tol
        ) & (no_change >= config.kick_patience)
        sigma = jnp.where(
            collapsed, sigma * jnp.exp(0.2 + cs / damps), sigma
        )

    # covariance path + rank-1 / rank-mu update
    hsig = (
        ps_norm
        / jnp.sqrt(1 - (1 - cs) ** (2 * (state.iteration.astype(dtype) + 1)))
        / chi_n
    ) < (1.4 + 2 / (n + 1))
    p_c = (1 - cc) * state.p_c + hsig * jnp.sqrt(cc * (2 - cc) * mu_eff) * y_w
    rank1 = jnp.outer(p_c, p_c)
    rank_mu = jnp.matmul(
        (y[top] * weights[:, None]).T, y[top], precision=HIGHEST
    )
    delta_hsig = (1 - hsig) * cc * (2 - cc)
    C = (
        (1 - c1 - cmu) * state.C
        + c1 * (rank1 + delta_hsig * state.C)
        + cmu * rank_mu
    )
    C = (C + C.T) / 2

    gen_best = values[order[0]]
    better = gen_best < state.best_value
    best_x = jnp.where(better, xs[order[0]], state.best_x)
    best_value = jnp.where(better, gen_best, state.best_value)

    worked = CMAESState(
        mean=new_mean,
        sigma=sigma,
        C=C,
        p_sigma=p_sigma,
        p_c=p_c,
        best_x=best_x,
        best_value=best_value,
        prev_best=state.best_value,
        iteration=state.iteration + 1,
        nfev=state.nfev + lam,
        no_change=no_change,
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: CMAESState, flip_sign: bool) -> SolverResult:
    f_val = state.best_value
    return make_result(
        x=state.best_x,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: CMAESConfig = CMAESConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    _minimize: bool = True,
) -> SolverResult:
    if key is None:
        key = jax.random.key(0)
    sfn = signed(fn, _minimize)
    x0 = jnp.asarray(x0)
    if bounds is not None:
        x0 = jnp.clip(x0, bounds.lower, bounds.upper)
    state = init(sfn, x0, config, key)
    state = drive(lambda s: step(sfn, s, config, bounds), state)
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: CMAESConfig = CMAESConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)


def minimize_ipop(
    fn: Objective,
    x0: jax.Array,
    config: CMAESConfig = CMAESConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    max_restarts: int = 4,
    pop_mult: float = 2.0,
) -> SolverResult:
    """IPOP-CMA-ES: restart with an INCREASING population (Auger & Hansen
    2005; the massively-parallel formulation of arXiv:2409.11765 is the
    retrieved reference, PAPERS.md).  Each restart multiplies lambda by
    ``pop_mult`` and re-launches from a fresh keyed start — larger
    populations progressively trade local convergence speed for global
    exploration, which is the canonical cure for CMA-ES stalling on
    multimodal landscapes.

    Stages run as a Python loop (lambda changes the compiled shapes, so
    each population size compiles once and is cached); the returned
    result carries the best stage's solution with counters SUMMED across
    every stage (``solver_status.add`` semantics, nlsolver.h:2084-2091).
    Set ``max_restarts=0`` for plain CMA-ES.
    """
    import dataclasses
    import math as _math

    if key is None:
        key = jax.random.key(0)
    x0 = jnp.asarray(x0)
    n = x0.shape[-1]
    lam0 = config.pop_size if config.pop_size > 0 else 4 + int(
        3 * _math.log(n)
    )

    best: Optional[SolverResult] = None
    for stage in range(max_restarts + 1):
        lam = max(int(round(lam0 * pop_mult**stage)), lam0 + stage)
        cfg = dataclasses.replace(config, pop_size=lam)
        key, k_start, k_run = jax.random.split(key, 3)
        if stage == 0:
            start = x0
        else:
            # fresh start inside the box (or a keyed perturbation of x0)
            if bounds is not None:
                lo = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape)
                hi = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape)
                start = lo + (hi - lo) * jax.random.uniform(
                    k_start, x0.shape, x0.dtype
                )
            else:
                start = x0 + 2.0 * config.sigma0 * jax.random.normal(
                    k_start, x0.shape, x0.dtype
                )
        res = minimize(fn, start, cfg, bounds, key=k_run)
        if best is None:
            best = res
        else:
            # a NaN stage (e.g. stage 0 sampling into a NaN region) must
            # never stick: any finite result beats NaN
            keep_new = jnp.asarray(res.f_value < best.f_value) | (
                jnp.isnan(jnp.asarray(best.f_value))
                & ~jnp.isnan(jnp.asarray(res.f_value))
            )
            merged = jax.tree_util.tree_map(
                lambda new, old: jnp.where(keep_new, new, old), res, best
            )
            # counters accumulate across stages regardless of the winner
            best = merged._replace(
                iterations=best.iterations + res.iterations,
                function_calls=best.function_calls + res.function_calls,
                gradient_calls=best.gradient_calls + res.gradient_calls,
                hessian_calls=best.hessian_calls + res.hessian_calls,
            )
    return best
