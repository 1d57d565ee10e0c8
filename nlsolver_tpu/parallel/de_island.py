"""Island-model Differential Evolution: shard-local evolution with periodic
ring migration.

The fully-sharded DE (parallel/de_sharded.py) ``all_gather``s the whole
[pop, n] agent matrix every generation so any agent can partner with any
other — communication O(pop * n) per generation.  The island model
is the classic lower-communication alternative: each pop shard is an
independent DE "island" whose partner sampling is LOCAL to the shard, and
every ``migration_interval`` generations each island sends its best member
one hop around the ring of islands (``lax.ppermute``), where it replaces
the recipient's worst member if better.  Steady-state communication drops
to O(n) per interval — the per-generation collectives are two [b]-sized
scalar reductions (global-best ``pmin`` and the spread moments ``psum``)
used only for termination.

This is a different (and well-studied) algorithm from single-population DE,
not a sharding of it: island count = the mesh's pop axis is an algorithmic
hyperparameter, and the restricted mixing typically preserves diversity
longer on multimodal problems.  Results are invariant to the dp layout for
a fixed island count (tested), but NOT to the island count itself — by
design.  Randomness stays per-(instance, global agent, iteration) fold_in,
as everywhere (SURVEY.md §7 "Multi-host determinism").

Reference seed: the DE inner loop the author marked "can in principle be
parallelized" (nlsolver.h:2448); migration has no reference analogue.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..core import Objective, SolverResult, make_result
from ..random.sampling import distinct_indices
from ..solvers.de import DEConfig
from .mesh import DP_AXIS, POP_AXIS


def _agent_step_key(instance_key, agent_id, iteration):
    k = jax.random.fold_in(instance_key, agent_id)
    return jax.random.fold_in(k, iteration)


def minimize_islands(
    fn: Objective,
    x0: jax.Array,                 # [B, n] batch of start points (width vectors)
    config: DEConfig,
    mesh,
    keys: Optional[jax.Array] = None,   # [B] instance keys
    migration_interval: int = 10,
    sync_interval: int = 1,
    fused: bool = False,
) -> SolverResult:
    """Solve B instances, each with ``pop`` agents split into
    ``mesh.shape[POP_AXIS]`` DE islands with ring migration.

    ``sync_interval``: generations per global termination check.  The
    while_loop's cond carries the only dp-axis collective — the one that
    crosses hosts when dp spans processes; checking every k
    generations amortizes that latency k-fold at the cost of at most k-1
    frozen (no-op) trailing generations per lane.  Results are bit-
    identical (lanes freeze on their exact termination generation;
    tests/test_de_island.py).  NOTE the 2-process CPU harness
    (tools/two_process_bench.py) shows this knob does NOT rescue Gloo's
    ~11% efficiency there — on CPU the dominant cost is per-collective
    rendezvous of the per-generation POP-axis stats/migration ops, which
    on a GPU host ride NVLink; the knob targets the cross-host latency
    term only (SCALING.md "Measured 2-process overhead").

    ``fused=True`` is the collective diet: ``migration_interval``
    generations run PURELY island-local (zero collectives — verified at
    the HLO level, tests/test_de_island.py), then migration + global
    stats + termination fold into a THREE-collective block (one packed
    ``all_gather`` of [3, b] island stats, one packed ``ppermute`` of the
    [b, n+1] migrant, the loop-cond ``psum``).  Collectives drop from
    ~5/generation to 3/interval.  Semantics differ from the eager path by
    design: termination is checked at interval boundaries (a lane can run
    up to interval-1 extra generations) and ``sync_interval`` is ignored
    (the boundary IS the sync point)."""
    if fused:
        return _minimize_islands_fused(
            fn, x0, config, mesh, keys, migration_interval
        )
    B, n = x0.shape
    pop = config.pop_size
    dp_size = mesh.shape[DP_AXIS]
    islands = mesh.shape[POP_AXIS]
    if B % dp_size or pop % islands:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and "
            f"pop_size {pop} over islands={islands}"
        )
    p_loc = pop // islands
    if p_loc < 4:
        raise ValueError("each island needs >= 4 agents for partner sampling")
    if keys is None:
        keys = jax.random.split(jax.random.key(0), B)

    ring = [(i, (i + 1) % islands) for i in range(islands)]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DP_AXIS, None), P(DP_AXIS)),
        out_specs=(P(DP_AXIS, None), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS)),
        check_vma=False,
    )
    def solve(x0_loc, keys_loc):
        b_loc = x0_loc.shape[0]
        isl_idx = lax.axis_index(POP_AXIS)
        agent_ids = isl_idx * p_loc + jnp.arange(p_loc, dtype=jnp.int32)
        local_ids = jnp.arange(p_loc, dtype=jnp.int32)

        def init_agents(inst_key, x0_i):
            def one(aid):
                k = jax.random.fold_in(inst_key, aid)
                u = jax.random.uniform(k, (n,), dtype=x0_i.dtype)
                return (u - 0.5) * x0_i  # nlsolver.h:2302-2323 semantics

            return jax.vmap(one)(agent_ids)

        agents = jax.vmap(init_agents)(keys_loc, x0_loc)   # [b_loc, p_loc, n]
        scores = jax.vmap(jax.vmap(fn))(agents)            # [b_loc, p_loc]

        init_state = dict(
            agents=agents,
            scores=scores,
            best_value=jnp.full((b_loc,), jnp.inf, scores.dtype),
            iteration=jnp.zeros((b_loc,), jnp.int32),
            nfev=jnp.full((b_loc,), pop, jnp.int32),
            val_no_change=jnp.zeros((b_loc,), jnp.int32),
            done=jnp.zeros((b_loc,), bool),
            converged=jnp.zeros((b_loc,), bool),
        )

        def global_stats(scores_loc):
            """Termination quantities via O(b) collectives, no gather."""
            best = lax.pmin(jnp.min(scores_loc, axis=1), POP_AXIS)      # [b_loc]
            s1 = lax.psum(jnp.sum(scores_loc, axis=1), POP_AXIS)
            s2 = lax.psum(jnp.sum(scores_loc**2, axis=1), POP_AXIS)
            mean = s1 / pop
            var = jnp.maximum(s2 / pop - mean**2, 0.0) * pop / max(pop - 1, 1)
            return best, jnp.sqrt(var)

        def cond(state):
            still = jnp.sum((~state["done"]).astype(jnp.int32))
            return lax.psum(still, DP_AXIS) > 0

        def body(state):
            best_now, spread = global_stats(state["scores"])
            improved = best_now < state["best_value"]
            val_no_change = jnp.where(improved, 0, state["val_no_change"] + 1)
            hit_tol = (val_no_change >= config.best_value_no_change) | (
                spread < config.eps
            )
            done_now = (state["iteration"] >= config.max_iter) | hit_tol

            # --- island-local DE generation -----------------------------
            if config.strategy == "best":
                fixed = jnp.broadcast_to(
                    jnp.argmin(state["scores"], axis=1).astype(jnp.int32)[:, None],
                    (b_loc, p_loc),
                )
            else:
                fixed = jnp.broadcast_to(local_ids[None, :], (b_loc, p_loc))

            def propose_row(inst_key, iteration, agents_i, fixed_i):
                def one(aid, lid, fix):
                    k = _agent_step_key(inst_key, aid, iteration)
                    k_idx, k_dim, k_cross = jax.random.split(k, 3)
                    r = distinct_indices(k_idx, p_loc, fix, k=3)
                    fdim = jax.random.randint(k_dim, (), 0, n)
                    u = jax.random.uniform(k_cross, (n,), dtype=agents_i.dtype)
                    mutate = (u < config.crossover_prob) | (jnp.arange(n) == fdim)
                    donor = agents_i[r[0]] + config.differential_weight * (
                        agents_i[r[1]] - agents_i[r[2]]
                    )
                    return jnp.where(mutate, donor, agents_i[lid])

                return jax.vmap(one)(agent_ids, local_ids, fixed_i)

            proposals = jax.vmap(propose_row)(
                keys_loc, state["iteration"], state["agents"], fixed
            )
            prop_scores = jax.vmap(jax.vmap(fn))(proposals)
            accept = prop_scores < state["scores"]
            new_agents = jnp.where(accept[..., None], proposals, state["agents"])
            new_scores = jnp.where(accept, prop_scores, state["scores"])

            # --- ring migration every migration_interval generations ----
            loc_best_idx = jnp.argmin(new_scores, axis=1)               # [b_loc]
            loc_best_val = jnp.take_along_axis(
                new_scores, loc_best_idx[:, None], axis=1
            )[:, 0]
            loc_best_x = jnp.take_along_axis(
                new_agents, loc_best_idx[:, None, None], axis=1
            )[:, 0, :]
            im_val = lax.ppermute(loc_best_val, POP_AXIS, ring)          # [b_loc]
            im_x = lax.ppermute(loc_best_x, POP_AXIS, ring)              # [b_loc, n]

            migrate_now = (state["iteration"] + 1) % migration_interval == 0
            loc_worst_idx = jnp.argmax(new_scores, axis=1)
            loc_worst_val = jnp.take_along_axis(
                new_scores, loc_worst_idx[:, None], axis=1
            )[:, 0]
            take = migrate_now & (im_val < loc_worst_val)                # [b_loc]
            rows = jnp.arange(b_loc)
            mig_agents = new_agents.at[rows, loc_worst_idx].set(
                jnp.where(take[:, None], im_x, new_agents[rows, loc_worst_idx])
            )
            mig_scores = new_scores.at[rows, loc_worst_idx].set(
                jnp.where(take, im_val, loc_worst_val)
            )

            worked = dict(
                agents=mig_agents,
                scores=mig_scores,
                best_value=best_now,
                iteration=state["iteration"] + 1,
                nfev=state["nfev"] + pop,
                val_no_change=val_no_change,
                done=jnp.zeros((b_loc,), bool),
                converged=jnp.zeros((b_loc,), bool),
            )
            halted = dict(
                state,
                best_value=best_now,
                val_no_change=val_no_change,
                done=jnp.ones((b_loc,), bool),
                converged=hit_tol,
            )
            frozen = done_now | state["done"]

            def pick(key_):
                a = jnp.where(
                    _bcast(state["done"], jnp.asarray(halted[key_]).ndim),
                    state[key_],
                    halted[key_],
                )
                b = worked[key_]
                return jnp.where(_bcast(frozen, jnp.asarray(a).ndim), a, b)

            return {k: pick(k) for k in worked}

        if sync_interval > 1:
            outer_body = lambda s: lax.fori_loop(
                0, sync_interval, lambda _, st: body(st), s
            )
        else:
            outer_body = body
        final = lax.while_loop(cond, outer_body, init_state)

        # one gather at the end to extract the global best member
        scores_g = lax.all_gather(final["scores"], POP_AXIS, axis=1, tiled=True)
        agents_g = lax.all_gather(final["agents"], POP_AXIS, axis=1, tiled=True)
        best_idx = jnp.argmin(scores_g, axis=1)
        x_best = jnp.take_along_axis(agents_g, best_idx[:, None, None], axis=1)[
            :, 0, :
        ]
        f_best = jnp.take_along_axis(scores_g, best_idx[:, None], axis=1)[:, 0]
        return x_best, f_best, final["iteration"], final["nfev"], final["converged"]

    x_best, f_best, iters, nfev, converged = solve(x0, keys)
    return make_result(
        x=x_best,
        f_value=f_best,
        iterations=iters,
        function_calls=nfev,
        converged=converged,
    )


def _bcast(mask, ndim):
    while mask.ndim < ndim:
        mask = mask[..., None]
    return mask


def _minimize_islands_fused(
    fn: Objective,
    x0: jax.Array,
    config: DEConfig,
    mesh,
    keys: Optional[jax.Array],
    interval: int,
) -> SolverResult:
    """The collective-diet island DE (see ``minimize_islands(fused=True)``).

    Loop structure: ``while any-active { interval x PURE-LOCAL generation;
    ONE fused comm block }``.  A local generation touches no collective at
    all; the block costs exactly three (packed stats all_gather, packed
    migrant ppermute, loop-cond psum) regardless of ``interval``."""
    B, n = x0.shape
    pop = config.pop_size
    dp_size = mesh.shape[DP_AXIS]
    islands = mesh.shape[POP_AXIS]
    if B % dp_size or pop % islands:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and "
            f"pop_size {pop} over islands={islands}"
        )
    p_loc = pop // islands
    if p_loc < 4:
        raise ValueError("each island needs >= 4 agents for partner sampling")
    if keys is None:
        keys = jax.random.split(jax.random.key(0), B)

    ring = [(i, (i + 1) % islands) for i in range(islands)]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DP_AXIS, None), P(DP_AXIS)),
        out_specs=(P(DP_AXIS, None), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS)),
        check_vma=False,
    )
    def solve(x0_loc, keys_loc):
        b_loc = x0_loc.shape[0]
        isl_idx = lax.axis_index(POP_AXIS)
        agent_ids = isl_idx * p_loc + jnp.arange(p_loc, dtype=jnp.int32)
        local_ids = jnp.arange(p_loc, dtype=jnp.int32)

        def init_agents(inst_key, x0_i):
            def one(aid):
                k = jax.random.fold_in(inst_key, aid)
                u = jax.random.uniform(k, (n,), dtype=x0_i.dtype)
                return (u - 0.5) * x0_i

            return jax.vmap(one)(agent_ids)

        agents = jax.vmap(init_agents)(keys_loc, x0_loc)   # [b_loc, p_loc, n]
        scores = jax.vmap(jax.vmap(fn))(agents)            # [b_loc, p_loc]

        init_state = dict(
            agents=agents,
            scores=scores,
            best_value=jnp.full((b_loc,), jnp.inf, scores.dtype),
            iteration=jnp.zeros((b_loc,), jnp.int32),
            nfev=jnp.full((b_loc,), pop, jnp.int32),
            val_no_change=jnp.zeros((b_loc,), jnp.int32),
            done=jnp.zeros((b_loc,), bool),
            converged=jnp.zeros((b_loc,), bool),
        )

        def local_gen(state):
            """One island-local DE generation — NO collectives."""
            frozen = state["done"] | (state["iteration"] >= config.max_iter)

            if config.strategy == "best":
                fixed = jnp.broadcast_to(
                    jnp.argmin(state["scores"], axis=1).astype(jnp.int32)[:, None],
                    (b_loc, p_loc),
                )
            else:
                fixed = jnp.broadcast_to(local_ids[None, :], (b_loc, p_loc))

            def propose_row(inst_key, iteration, agents_i, fixed_i):
                def one(aid, lid, fix):
                    k = _agent_step_key(inst_key, aid, iteration)
                    k_idx, k_dim, k_cross = jax.random.split(k, 3)
                    r = distinct_indices(k_idx, p_loc, fix, k=3)
                    fdim = jax.random.randint(k_dim, (), 0, n)
                    u = jax.random.uniform(k_cross, (n,), dtype=agents_i.dtype)
                    mutate = (u < config.crossover_prob) | (jnp.arange(n) == fdim)
                    donor = agents_i[r[0]] + config.differential_weight * (
                        agents_i[r[1]] - agents_i[r[2]]
                    )
                    return jnp.where(mutate, donor, agents_i[lid])

                return jax.vmap(one)(agent_ids, local_ids, fixed_i)

            proposals = jax.vmap(propose_row)(
                keys_loc, state["iteration"], state["agents"], fixed
            )
            prop_scores = jax.vmap(jax.vmap(fn))(proposals)
            accept = (prop_scores < state["scores"]) & ~frozen[:, None]
            return dict(
                state,
                agents=jnp.where(
                    accept[..., None], proposals, state["agents"]
                ),
                scores=jnp.where(accept, prop_scores, state["scores"]),
                iteration=jnp.where(
                    frozen, state["iteration"], state["iteration"] + 1
                ),
                nfev=jnp.where(frozen, state["nfev"], state["nfev"] + pop),
            )

        def outer(state):
            state = lax.fori_loop(
                0, interval, lambda _, s: local_gen(s), state
            )
            scores_l, agents_l = state["scores"], state["agents"]

            # ---- fused collective block (3 collectives total) ----------
            packed = jnp.stack(
                [
                    jnp.min(scores_l, axis=1),
                    jnp.sum(scores_l, axis=1),
                    jnp.sum(scores_l**2, axis=1),
                ],
                axis=0,
            )                                               # [3, b_loc]
            g = lax.all_gather(packed, POP_AXIS, axis=0, tiled=False)
            best_now = jnp.min(g[:, 0], axis=0)             # [b_loc]
            mean = jnp.sum(g[:, 1], axis=0) / pop
            var = jnp.maximum(
                jnp.sum(g[:, 2], axis=0) / pop - mean**2, 0.0
            ) * pop / max(pop - 1, 1)
            spread = jnp.sqrt(var)

            loc_best_idx = jnp.argmin(scores_l, axis=1)
            loc_best_val = jnp.take_along_axis(
                scores_l, loc_best_idx[:, None], axis=1
            )[:, 0]
            loc_best_x = jnp.take_along_axis(
                agents_l, loc_best_idx[:, None, None], axis=1
            )[:, 0, :]
            migrant = jnp.concatenate(
                [loc_best_x, loc_best_val[:, None]], axis=1
            )                                               # [b_loc, n+1]
            im = lax.ppermute(migrant, POP_AXIS, ring)
            im_x, im_val = im[:, :n], im[:, n]

            loc_worst_idx = jnp.argmax(scores_l, axis=1)
            loc_worst_val = jnp.take_along_axis(
                scores_l, loc_worst_idx[:, None], axis=1
            )[:, 0]
            take = (im_val < loc_worst_val) & ~state["done"]
            rows = jnp.arange(b_loc)
            agents_m = agents_l.at[rows, loc_worst_idx].set(
                jnp.where(take[:, None], im_x, agents_l[rows, loc_worst_idx])
            )
            scores_m = scores_l.at[rows, loc_worst_idx].set(
                jnp.where(take, im_val, loc_worst_val)
            )

            improved = best_now < state["best_value"]
            val_no_change = jnp.where(
                improved, 0, state["val_no_change"] + interval
            )
            hit_tol = (val_no_change >= config.best_value_no_change) | (
                spread < config.eps
            )
            newly_done = ~state["done"] & (
                (state["iteration"] >= config.max_iter) | hit_tol
            )
            return dict(
                agents=agents_m,
                scores=scores_m,
                best_value=jnp.minimum(state["best_value"], best_now),
                iteration=state["iteration"],
                nfev=state["nfev"],
                val_no_change=val_no_change,
                done=state["done"] | newly_done,
                converged=jnp.where(newly_done, hit_tol, state["converged"]),
            )

        def cond(state):
            still = jnp.sum((~state["done"]).astype(jnp.int32))
            return lax.psum(still, DP_AXIS) > 0

        final = lax.while_loop(cond, outer, init_state)

        scores_g = lax.all_gather(final["scores"], POP_AXIS, axis=1, tiled=True)
        agents_g = lax.all_gather(final["agents"], POP_AXIS, axis=1, tiled=True)
        best_idx = jnp.argmin(scores_g, axis=1)
        x_best = jnp.take_along_axis(agents_g, best_idx[:, None, None], axis=1)[
            :, 0, :
        ]
        f_best = jnp.take_along_axis(scores_g, best_idx[:, None], axis=1)[:, 0]
        return x_best, f_best, final["iteration"], final["nfev"], final["converged"]

    x_best, f_best, iters, nfev, converged = solve(x0, keys)
    return make_result(
        x=x_best,
        f_value=f_best,
        iterations=iters,
        function_calls=nfev,
        converged=converged,
    )
