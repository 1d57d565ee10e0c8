"""Differential Evolution.

Re-creation of the reference's ``DE`` class (nlsolver.h:2379-2477) with the
population as one ``[pop, dim]`` array:

  * the sequential per-agent loop (nlsolver.h:2449-2472 — the author notes it
    "can in principle be parallelized") becomes a fully vectorized
    synchronous generation: distinct partner indices for every agent come
    from a rejection-free shift sampler (replacing the unordered_set loop,
    nlsolver.h:2331-2355), mutation + binomial crossover + greedy selection
    are masked vector ops, and all proposals are scored in one vmapped call;
  * population init matches the reference's quirky semantics
    (``init_agents``, nlsolver.h:2302-2323): agent[i,j] = (U[0,1)-0.5) *
    x0[j] — x0 acts as a per-dimension *width*, centering the population
    around the origin, not around x0;
  * recombination strategies ``random``/``best`` pick the crossover base
    agent as in nlsolver.h:2451-2457;
  * termination (nlsolver.h:2441-2443): max_iter, best value unchanged for
    ``best_value_no_change`` iterations, or sample-std of scores < eps.

Sharding: for populations too large for one chip, run this same step under
``shard_map`` with the population axis sharded; the only cross-device
communication is the termination reduction (psum/pmin) — see
``nlsolver_tpu.parallel``.
"""
from __future__ import annotations

from dataclasses import dataclass
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
    std_err,
)
from ..random.sampling import distinct_indices


@dataclass(frozen=True)
class DEConfig:
    """Hyperparameters with the reference's defaults (nlsolver.h:2390-2394)."""

    crossover_prob: float = 0.9
    differential_weight: float = 0.8
    eps: float = 1e-3           # reference writes 10e-4
    pop_size: int = 50
    max_iter: int = 1000
    best_value_no_change: int = 50
    strategy: str = "random"    # RecombinationStrategy {random, best} (:2377)
    # partner sampling (honored by the column-major de_batched driver):
    #   "uniform"  — per-agent uniform distinct partners (reference
    #                semantics, nlsolver.h:2331-2355);
    #   "rotation" — per-generation random ring rotations: agent i's
    #                partners are (i+o1, i+o2, i+o3) mod P with the three
    #                offsets drawn fresh each generation from disjoint
    #                ranges (distinct, nonzero).  Replaces the per-agent
    #                index sampling and partner gathers with three lane
    #                rolls — the fast path for large fleets.
    partner_sampling: str = "uniform"


class DEState(NamedTuple):
    agents: jax.Array        # [pop, dim]
    scores: jax.Array        # [pop]
    best_value: jax.Array    # best score seen at last check
    iteration: jax.Array
    nfev: jax.Array
    val_no_change: jax.Array
    key: jax.Array
    done: jax.Array
    converged: jax.Array


def init(fn: Objective, x0: jax.Array, config: DEConfig, key: jax.Array) -> DEState:
    key, k_init = jax.random.split(key)
    u = jax.random.uniform(k_init, (config.pop_size, x0.shape[-1]), dtype=x0.dtype)
    agents = (u - 0.5) * x0[None, :]
    scores = batch_eval(fn, agents)
    return DEState(
        agents=agents,
        scores=scores,
        best_value=jnp.min(scores),
        iteration=jnp.int32(0),
        nfev=jnp.int32(config.pop_size),
        val_no_change=jnp.int32(0),
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(fn: Objective, state: DEState, config: DEConfig) -> DEState:
    agents, scores = state.agents, state.scores
    pop, dim = agents.shape

    best_now = jnp.min(scores)
    improved = best_now < state.best_value
    val_no_change = jnp.where(improved, 0, state.val_no_change + 1)

    hit_tol = (val_no_change >= config.best_value_no_change) | (
        std_err(scores) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol
    halted = state._replace(
        best_value=best_now,
        val_no_change=val_no_change,
        done=jnp.asarray(True),
        converged=hit_tol,
    )

    key, k_idx, k_dim, k_cross = jax.random.split(state.key, 4)
    if config.strategy == "best":
        fixed = jnp.broadcast_to(jnp.argmin(scores).astype(jnp.int32), (pop,))
    else:
        fixed = jnp.arange(pop, dtype=jnp.int32)

    r = distinct_indices(k_idx, pop, fixed, k=3)            # [pop, 3]
    forced_dim = jax.random.randint(k_dim, (pop,), 0, dim)  # always-mutated dim
    u = jax.random.uniform(k_cross, (pop, dim), dtype=agents.dtype)
    mutate = (u < config.crossover_prob) | (
        jnp.arange(dim)[None, :] == forced_dim[:, None]
    )

    f_weight = jnp.asarray(config.differential_weight, agents.dtype)
    donor = agents[r[:, 0]] + f_weight * (agents[r[:, 1]] - agents[r[:, 2]])
    base = agents[fixed]
    proposals = jnp.where(mutate, donor, base)

    prop_scores = batch_eval(fn, proposals)
    accept = prop_scores < scores
    new_agents = jnp.where(accept[:, None], proposals, agents)
    new_scores = jnp.where(accept, prop_scores, scores)

    worked = DEState(
        agents=new_agents,
        scores=new_scores,
        best_value=best_now,
        iteration=state.iteration + 1,
        nfev=state.nfev + pop,
        val_no_change=val_no_change,
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: DEState, flip_sign: bool) -> SolverResult:
    best = jnp.argmin(state.scores)
    f_val = state.scores[best]
    return make_result(
        x=state.agents[best],
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: DEConfig = DEConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    _minimize: bool = True,
) -> SolverResult:
    if key is None:
        key = jax.random.key(0)
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config, key)
    state = drive(lambda s: step(sfn, s, config), state)
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: DEConfig = DEConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
