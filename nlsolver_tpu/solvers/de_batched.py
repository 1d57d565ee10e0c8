"""High-throughput batched Differential Evolution, column-major layout.

The general-purpose ``solvers.de`` stores agents as [pop, dim] rows; under
``vmap`` every instance then works on a short trailing ``dim`` axis.  This
driver is the layout for large fleets (SURVEY.md §2 "fused DE
mutation+crossover+select"):

  * agents live as ``[B, n, pop]`` — population on the trailing axis;
  * ``partner_sampling="uniform"`` gathers the three partner columns per
    agent and forms the donor elementwise,
        donor = A[:, r0] + F (A[:, r1] - A[:, r2]),
    so every donor coordinate is exact f32 arithmetic (no matrix product,
    hence no TF32 rounding on GPUs); ``"rotation"`` replaces the per-agent
    partners with three lane rolls of the whole population;
  * the "random" strategy's crossover base is the agent matrix itself
    (fixed = self), so no base gather; "best" broadcasts one column;
  * objectives are evaluated column-wise (``vmap(fn, in_axes=1)``), so a
    reduction-over-coordinates objective (all the classical test functions)
    reduces over the short axis with the batch and population wide.

Semantics are identical to ``solvers.de`` (same init-width quirk, greedy
selection, termination rule); only the execution layout differs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import SolverResult, make_result, signed, std_err
from ..random.sampling import distinct_indices
from .de import DEConfig


class DEBatchState(NamedTuple):
    agents: jax.Array        # [B, n, P] column-major
    scores: jax.Array        # [B, P]
    best_value: jax.Array    # [B]
    iteration: jax.Array     # [B]
    nfev: jax.Array          # [B]
    val_no_change: jax.Array # [B]
    keys: jax.Array          # [B]
    done: jax.Array          # [B]
    converged: jax.Array     # [B]


def _eval_columns(fn, A):  # A: [B, n, P] -> [B, P]
    return jax.vmap(jax.vmap(fn, in_axes=1))(A)


def init(fn, x0: jax.Array, config: DEConfig, keys: jax.Array) -> DEBatchState:
    """x0: [B, n] width vectors; keys: [B]."""
    B, n = x0.shape
    P = config.pop_size

    def init_one(key, x0_i):
        key, k = jax.random.split(key)
        u = jax.random.uniform(k, (n, P), dtype=x0_i.dtype)
        return (u - 0.5) * x0_i[:, None], key  # nlsolver.h:2302-2323 semantics

    agents, keys = jax.vmap(init_one)(keys, x0)
    scores = _eval_columns(fn, agents)
    zeros = jnp.zeros((B,), jnp.int32)
    return DEBatchState(
        agents=agents,
        scores=scores,
        best_value=jnp.min(scores, axis=1),
        iteration=zeros,
        nfev=jnp.full((B,), P, jnp.int32),
        val_no_change=zeros,
        keys=keys,
        done=jnp.zeros((B,), bool),
        converged=jnp.zeros((B,), bool),
    )


def step(fn, state: DEBatchState, config: DEConfig) -> DEBatchState:
    B, n, P = state.agents.shape
    dtype = state.agents.dtype

    best_now = jnp.min(state.scores, axis=1)
    improved = best_now < state.best_value
    val_no_change = jnp.where(improved, 0, state.val_no_change + 1)
    hit_tol = (val_no_change >= config.best_value_no_change) | (
        std_err(state.scores, axis=1) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol

    rotation = config.partner_sampling == "rotation"
    f_w = jnp.asarray(config.differential_weight, dtype)

    def propose(key, agents_i, scores_i, offs):
        k_idx, k_dim, k_cross, key = jax.random.split(key, 4)
        if rotation:
            # ring partners (i+o1, i+o2, i+o3) mod P: three lane rolls
            donor = jnp.roll(agents_i, -offs[0], axis=1) + f_w * (
                jnp.roll(agents_i, -offs[1], axis=1)
                - jnp.roll(agents_i, -offs[2], axis=1)
            )
        else:
            if config.strategy == "best":
                fixed = jnp.broadcast_to(
                    jnp.argmin(scores_i).astype(jnp.int32), (P,)
                )
            else:
                fixed = jnp.arange(P, dtype=jnp.int32)
            r = distinct_indices(k_idx, P, fixed, k=3)      # [P, 3]
            pick = lambda j: jnp.take_along_axis(
                agents_i, jnp.broadcast_to(r[None, :, j], (n, P)), axis=1
            )
            donor = pick(0) + f_w * (pick(1) - pick(2))     # [n, P_tgt]

        fdim = jax.random.randint(k_dim, (P,), 0, n)
        u = jax.random.uniform(k_cross, (n, P), dtype=dtype)
        mutate = (u < config.crossover_prob) | (
            jnp.arange(n)[:, None] == fdim[None, :]
        )
        if config.strategy == "best":
            best_col = jnp.argmin(scores_i).astype(jnp.int32)
            base = jnp.take_along_axis(
                agents_i, jnp.broadcast_to(best_col, (n, 1)), axis=1
            )
        else:
            base = agents_i
        return jnp.where(mutate, donor, base), key

    if rotation:
        # per-generation shared offsets from disjoint ranges: distinct,
        # nonzero, never equal to the target index
        third = max(P // 3, 1)
        ko = jax.random.fold_in(state.keys[0], state.iteration[0])
        offs = jnp.stack([
            jax.random.randint(jax.random.fold_in(ko, 1), (), 1, third + 1),
            jax.random.randint(jax.random.fold_in(ko, 2), (), third + 1, 2 * third + 1),
            jax.random.randint(jax.random.fold_in(ko, 3), (), 2 * third + 1, P),
        ])
        proposals, keys = jax.vmap(
            lambda key, A, s: propose(key, A, s, offs)
        )(state.keys, state.agents, state.scores)
    else:
        dummy = jnp.zeros((3,), jnp.int32)
        proposals, keys = jax.vmap(
            lambda key, A, s: propose(key, A, s, dummy)
        )(state.keys, state.agents, state.scores)
    prop_scores = _eval_columns(fn, proposals)
    # fold the active-lane freeze INTO the greedy-selection mask: a
    # separate keep() pass after the select would re-stream agents/scores
    # a second time through device memory
    act = ~(state.done | done_now)                          # [B]
    accept = (prop_scores < state.scores) & act[:, None]    # [B, P]
    new_agents = jnp.where(accept[:, None, :], proposals, state.agents)
    new_scores = jnp.where(accept, prop_scores, state.scores)

    return DEBatchState(
        agents=new_agents,
        scores=new_scores,
        best_value=best_now,
        iteration=state.iteration + act.astype(jnp.int32),
        nfev=state.nfev + P * act.astype(jnp.int32),
        val_no_change=val_no_change,
        keys=jnp.where(act, keys, state.keys),
        done=state.done | done_now,
        converged=jnp.where(state.done, state.converged, hit_tol),
    )


def _finalize(state: DEBatchState, flip_sign: bool) -> SolverResult:
    best = jnp.argmin(state.scores, axis=1)
    x = jnp.take_along_axis(state.agents, best[:, None, None], axis=2)[:, :, 0]
    f = jnp.take_along_axis(state.scores, best[:, None], axis=1)[:, 0]
    return make_result(
        x=x,
        f_value=-f if flip_sign else f,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize_batched(
    fn,
    x0: jax.Array,                 # [B, n]
    config: DEConfig = DEConfig(),
    *,
    keys: Optional[jax.Array] = None,
    progress=None,
    progress_every: int = 50,
    _minimize: bool = True,
) -> SolverResult:
    """``progress`` (optional host callback, see ``core.driver.attach_
    progress``) streams (iteration, best, active) every ``progress_every``
    generations while the fleet runs."""
    if keys is None:
        keys = jax.random.split(jax.random.key(0), x0.shape[0])
    elif keys.ndim == 0 or keys.shape[0] != x0.shape[0]:
        raise ValueError(
            "keys must carry one stream per instance: got "
            f"{'a single unsplit key' if keys.ndim == 0 else keys.shape[0]}"
            f" for {x0.shape[0]} instances (split with jax.random.split)"
        )
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config, keys)

    from jax import lax

    body = lambda s: step(sfn, s, config)
    if progress is not None:
        from ..core.driver import attach_progress

        body = attach_progress(body, progress, progress_every)
    state = lax.while_loop(lambda s: ~jnp.all(s.done), body, state)
    return _finalize(state, flip_sign=not _minimize)
