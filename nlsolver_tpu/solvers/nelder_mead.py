"""Nelder-Mead simplex solver.

Re-creation of the reference's ``NelderMead`` class (nlsolver.h:2099-2300)
as a pure init/step state machine:

  * the simplex lives as one ``[n+1, n]`` array (not a vector-of-vectors),
    scored with a single vmapped objective call;
  * the reference's 4-way accept/expand/contract/shrink branch
    (nlsolver.h:2251-2296) becomes a ``lax.switch`` whose branches each
    evaluate at most one candidate point (plus a nested shrink rescore),
    so the single-instance jit path does the same work as the reference
    while the whole step stays traceable under ``vmap``;
  * termination is the reference's composite rule (nlsolver.h:2233-2237):
    max_iter, sample-std of scores below a rescaled eps, or best vertex
    unchanged for ``no_change_best_tol`` iterations.

Simplex initialization follows Gao/Han exactly as the reference does
(nlsolver.h:1910-1947): scale = clamp(||x||_inf, 1, 10), vertex i = x +
scale*e_i, vertex 0 = x + (1-sqrt(n+1))/n * scale (or a fixed user step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import (
    Bounds,
    Objective,
    SolverResult,
    batch_eval,
    drive,
    make_result,
    resolve_bounds,
    signed,
    std_err,
)


@dataclass(frozen=True)
class NelderMeadConfig:
    """Hyperparameters with the reference's defaults (nlsolver.h:2110-2115)."""

    step: float = -1.0          # <0 => Gao/Han auto-initialization
    alpha: float = 1.0          # reflection
    gamma: float = 2.0          # expansion
    rho: float = 0.5            # contraction
    sigma: float = 0.5          # shrink
    eps: float = 1e-6
    max_iter: int = 500
    no_change_best_tol: int = 20
    restarts: int = 0
    # "textbook" (default): standard Nelder-Mead branch logic.
    # "reference": trajectory-level parity with the reference's quirks —
    #   * its "second worst" is the previous running-max index at the last
    #     worst-update (nlsolver.h:2217-2219);
    #   * its contraction computes c + rho*(c - point) (nlsolver.h:2266-2275),
    #     the opposite orientation from the textbook method;
    #   * its simplex init is off by one: vertex i perturbs dimension i for
    #     i = 1..n-1 and vertex n's perturbation is an out-of-bounds write
    #     (`init_simplex[i][i] += scale` with i = n, nlsolver.h:1929-1931)
    #     that lands in allocator slack and is lost, so vertex n stays at x
    #     and dimension 0 is only spanned by vertex 0's uniform shift;
    #   * the centroid is only recomputed when the worst index changed or
    #     after a shrink (nlsolver.h:2240-2243), starting from a ZERO vector
    #     and prev_worst = 0 (nlsolver.h:2191-2197) — iteration 1 reflects
    #     through the origin whenever the initial worst vertex is index 0.
    #   (verified step-for-step against the reference binary:
    #   tests/test_trajectory_parity.py)
    variant: str = "textbook"


class NMState(NamedTuple):
    simplex: jax.Array        # [n+1, n]
    scores: jax.Array         # [n+1]
    iteration: jax.Array
    nfev: jax.Array
    last_best: jax.Array
    no_change_iter: jax.Array
    eps: jax.Array            # rescaled tolerance (nlsolver.h:2189)
    centroid: jax.Array       # [n] cached centroid (reference variant only)
    prev_worst: jax.Array     # worst index of the previous iteration
    shrunk: jax.Array         # previous iteration ended in a shrink
    done: jax.Array
    converged: jax.Array


def init_simplex(x0: jax.Array, step: float, variant: str = "textbook") -> jax.Array:
    """Gao/Han (or fixed-step) initial simplex (nlsolver.h:1910-1947).

    ``variant="reference"`` reproduces the reference's off-by-one
    perturbation (nlsolver.h:1929-1931, 1941-1943): ``vals[i][i] += scale``
    for i = 1..n perturbs dimension i of vertex i, so vertex i spans
    dimension i (not i-1) and vertex n's write lands one element past its
    buffer — observably, vertex n stays at x.
    """
    n = x0.shape[-1]
    if variant == "reference":
        pert = jnp.zeros((n, n), dtype=x0.dtype)
        if n > 1:
            idx = jnp.arange(n - 1)
            pert = pert.at[idx, idx + 1].set(1.0)
    else:
        pert = jnp.eye(n, dtype=x0.dtype)
    if step < 0:
        x_inf = jnp.max(jnp.abs(x0))
        scale = jnp.clip(x_inf, 1.0, 10.0).astype(x0.dtype)
        vertices = x0[None, :] + scale * pert         # vertices 1..n
        v0 = x0 + ((1.0 - jnp.sqrt(n + 1.0)) / n * scale).astype(x0.dtype)
        return jnp.concatenate([v0[None, :], vertices], axis=0)
    vertices = x0[None, :] + jnp.asarray(step, x0.dtype) * pert
    return jnp.concatenate([x0[None, :], vertices], axis=0)


def init(
    fn: Objective,
    x0: jax.Array,
    config: NelderMeadConfig,
    bounds: Optional[Bounds] = None,
) -> NMState:
    simplex = init_simplex(x0, config.step, config.variant)
    scores = batch_eval(fn, simplex)
    # relative tolerance rescale using the first vertex's score
    # (nlsolver.h:2189: eps = eps * (scores[0] * eps))
    eps = jnp.asarray(config.eps, scores.dtype)
    eps = eps * scores[0] * eps
    n1 = simplex.shape[0]
    return NMState(
        simplex=simplex,
        scores=scores,
        iteration=jnp.int32(0),
        nfev=jnp.int32(n1),
        last_best=jnp.int32(-1),
        no_change_iter=jnp.int32(0),
        eps=eps,
        # the reference's centroid cache starts as a ZERO vector with
        # prev_worst = 0 (nlsolver.h:2191-2197)
        centroid=jnp.zeros_like(x0),
        prev_worst=jnp.int32(0),
        shrunk=jnp.asarray(False),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def _second_worst_score(scores: jax.Array, worst: jax.Array) -> jax.Array:
    """True second-worst score (textbook variant)."""
    masked = scores.at[worst].set(-jnp.inf)
    return jnp.max(masked)


def _reference_second_worst_score(scores: jax.Array, worst: jax.Array) -> jax.Array:
    """The reference's "second worst": its single-pass scan only updates
    ``second_worst`` when a new running maximum is found
    (nlsolver.h:2217-2219), so the value it ends with is the max over the
    strict prefix before the (first-occurrence) argmax — scores[0] when the
    argmax is index 0."""
    n1 = scores.shape[0]
    idx = jnp.arange(n1)
    prefix = jnp.where(idx < worst, scores, -jnp.inf)
    return jnp.where(worst == 0, scores[0], jnp.max(prefix))


def step(
    fn: Objective,
    state: NMState,
    config: NelderMeadConfig,
    lower: jax.Array,
    upper: jax.Array,
    bounded: bool,
) -> NMState:
    simplex, scores = state.simplex, state.scores
    n1, n = simplex.shape

    reference_variant = config.variant == "reference"
    best = jnp.argmin(scores).astype(jnp.int32)
    worst = jnp.argmax(scores).astype(jnp.int32)
    f_best = scores[best]
    f_worst = scores[worst]
    if reference_variant:
        f_second = _reference_second_worst_score(scores, worst)
    else:
        f_second = _second_worst_score(scores, worst)

    # stagnation tracking on the best *index* (nlsolver.h:2222-2230)
    no_change = jnp.where(best == state.last_best, state.no_change_iter + 1, 0)
    fse = std_err(scores)

    hit_tol = (fse < state.eps) | (no_change >= config.no_change_best_tol)
    done_now = (state.iteration >= config.max_iter) | hit_tol
    halted = state._replace(
        no_change_iter=no_change,
        last_best=best,
        done=jnp.asarray(True),
        converged=hit_tol,
    )

    def _clamp(x):
        return jnp.clip(x, lower, upper) if bounded else x

    x_worst = simplex[worst]
    if reference_variant:
        # bit-exact with update_centroid (nlsolver.h:1965-1984): accumulate
        # vertices in index order, skipping the worst, then divide.  (The
        # default path's (sum - worst)/n differs by ~1 ulp, which chaotic
        # problems amplify; masked add-of-zero is IEEE-exact.)  n1 is static,
        # so this unrolls at trace time — parity tooling only.
        zero = jnp.zeros_like(x_worst)
        acc = zero
        for i in range(n1):
            acc = acc + jnp.where(worst == i, zero, simplex[i])
        fresh_centroid = acc / n
        # the reference only recomputes the centroid when the worst index
        # changed or the previous iteration shrank (nlsolver.h:2240-2243);
        # otherwise the cached buffer is reused — including the initial
        # ZERO vector on iteration 1 when the first worst is index 0.
        recompute = (worst != state.prev_worst) | state.shrunk
        centroid = jnp.where(recompute, fresh_centroid, state.centroid)
    else:
        centroid = (jnp.sum(simplex, axis=0) - x_worst) / n

    alpha = jnp.asarray(config.alpha, simplex.dtype)
    gamma = jnp.asarray(config.gamma, simplex.dtype)
    rho = jnp.asarray(config.rho, simplex.dtype)
    sigma = jnp.asarray(config.sigma, simplex.dtype)

    x_reflect = _clamp(centroid + alpha * (centroid - x_worst))
    f_reflect = fn(x_reflect)

    # branch selection (nlsolver.h:2251-2296)
    #   0: expand (reflected is new best)
    #   1: accept reflection (between best and second worst)
    #   2: contract or shrink
    branch = jnp.where(f_reflect < f_best, 0, jnp.where(f_reflect < f_second, 1, 2))

    def do_expand(sim, sc):
        x_expand = _clamp(centroid + gamma * (x_reflect - centroid))
        f_expand = fn(x_expand)
        take_exp = f_expand < f_reflect
        new_point = jnp.where(take_exp, x_expand, x_reflect)
        new_score = jnp.where(take_exp, f_expand, f_reflect)
        return (
            sim.at[worst].set(new_point),
            sc.at[worst].set(new_score),
            jnp.int32(2),
        )

    def do_reflect(sim, sc):
        return (
            sim.at[worst].set(x_reflect),
            sc.at[worst].set(f_reflect),
            jnp.int32(1),
        )

    def do_contract(sim, sc):
        reflect_better = f_reflect < f_worst
        if reference_variant:
            # the reference's contraction (nlsolver.h:2266-2275) computes
            # c + rho*(c - point) — the opposite orientation from textbook NM
            x_contract = jnp.where(
                reflect_better,
                centroid + rho * (centroid - x_reflect),
                centroid + rho * (centroid - x_worst),
            )
        else:
            # textbook: outside contraction toward the reflected point when
            # it improved on the worst, inside toward the worst otherwise
            x_contract = jnp.where(
                reflect_better,
                centroid + rho * (x_reflect - centroid),
                centroid + rho * (x_worst - centroid),
            )
        x_contract = _clamp(x_contract)
        f_contract = fn(x_contract)
        accept = f_contract < jnp.where(reflect_better, f_reflect, f_worst)

        def contracted(args):
            sim, sc = args
            return (
                sim.at[worst].set(x_contract),
                sc.at[worst].set(f_contract),
                jnp.int32(2),
            )

        def shrunk(args):
            sim, sc = args
            x_best = sim[best]
            new_sim = x_best[None, :] + sigma * (sim - x_best[None, :])
            new_sim = new_sim.at[best].set(x_best)
            new_sc = batch_eval(fn, new_sim)
            new_sc = new_sc.at[best].set(sc[best])  # best not rescored (:2288-2294)
            return new_sim, new_sc, jnp.int32(1 + n1)

        return lax.cond(accept, contracted, shrunk, (sim, sc))

    new_simplex, new_scores, evals = lax.switch(
        branch, [do_expand, do_reflect, do_contract], simplex, scores
    )

    worked = NMState(
        simplex=new_simplex,
        scores=new_scores,
        iteration=state.iteration + 1,
        nfev=state.nfev + evals,
        last_best=best,
        no_change_iter=no_change,
        eps=state.eps,
        centroid=centroid,
        prev_worst=worst,
        shrunk=evals == (1 + n1),  # only the shrink branch costs 1+n1 evals
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: NMState, flip_sign: bool) -> SolverResult:
    best = jnp.argmin(state.scores)
    f_val = state.scores[best]
    return make_result(
        x=state.simplex[best],
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def _solve_once(
    fn: Objective,
    x0: jax.Array,
    config: NelderMeadConfig,
    bounds: Optional[Bounds],
    minimize: bool,
) -> SolverResult:
    sfn = signed(fn, minimize)
    lower, upper, bounded = resolve_bounds(bounds, x0)
    state = init(sfn, x0, config, bounds)
    state = drive(lambda s: step(sfn, s, config, lower, upper, bounded), state)
    return _finalize(state, flip_sign=not minimize)


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: NelderMeadConfig = NelderMeadConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,  # unused; uniform solver signature
    _minimize: bool = True,
) -> SolverResult:
    """Nelder-Mead minimization (restarts accumulate like nlsolver.h:2127-2134)."""
    res = _solve_once(fn, x0, config, bounds, _minimize)
    for _ in range(config.restarts):
        res = res.add(_solve_once(fn, res.x, config, bounds, _minimize))
    return res


def maximize(
    fn: Objective,
    x0: jax.Array,
    config: NelderMeadConfig = NelderMeadConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,
) -> SolverResult:
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
