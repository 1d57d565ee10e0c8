"""Multi-device Differential Evolution: populations sharded over a mesh.

This is the flagship distributed solver (BASELINE.json: populations sharded
across devices and hosts, global best-member selection via psum/argmin
collectives).  The same generation step as
``solvers.de`` runs as one SPMD program under ``shard_map`` over a
(dp, pop) mesh:

  * ``dp`` axis — independent problem instances (batch);
  * ``pop`` axis — the agent population of each instance, sharded;
  * per generation each pop shard ``all_gather``s the (small) agent matrix
    and scores, samples global partner indices for its local
    agents, evaluates proposals locally, and greedily updates its shard;
  * termination is evaluated on the gathered scores (identical on every pop
    shard) and the outer ``while_loop`` condition is made globally
    consistent with a ``psum`` of still-running lanes over dp — the
    multi-device version of the masked-lane driver.

Randomness is layout-invariant: every draw comes from
``fold_in(instance_key, global_agent_id, iteration)``, so results do not
depend on how the population is sharded (SURVEY.md §7 "Multi-host
determinism").
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import Objective, SolverResult, make_result, std_err
from ..random.sampling import distinct_indices
from ..solvers.de import DEConfig
from .mesh import DP_AXIS, POP_AXIS


def _agent_step_key(instance_key, agent_id, iteration):
    k = jax.random.fold_in(instance_key, agent_id)
    return jax.random.fold_in(k, iteration)


def minimize_sharded(
    fn: Objective,
    x0: jax.Array,                # [B, n] batch of start points (width vectors)
    config: DEConfig,
    mesh,
    keys: Optional[jax.Array] = None,  # [B] instance keys
) -> SolverResult:
    """Solve B problem instances, each with a pop-sharded DE population."""
    B, n = x0.shape
    pop = config.pop_size
    dp_size = mesh.shape[DP_AXIS]
    pop_shards = mesh.shape[POP_AXIS]
    if B % dp_size or pop % pop_shards:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and "
            f"pop_size {pop} over pop={pop_shards}"
        )
    if keys is None:
        keys = jax.random.split(jax.random.key(0), B)

    in_specs = (P(DP_AXIS, None), P(DP_AXIS))
    out_specs = (P(DP_AXIS, None), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    def solve(x0_loc, keys_loc):
        b_loc = x0_loc.shape[0]
        p_loc = pop // pop_shards
        pop_idx = lax.axis_index(POP_AXIS)
        # global agent ids owned by this shard
        agent_ids = pop_idx * p_loc + jnp.arange(p_loc, dtype=jnp.int32)

        def init_agents(inst_key, x0_i):
            def one(aid):
                k = jax.random.fold_in(inst_key, aid)
                u = jax.random.uniform(k, (n,), dtype=x0_i.dtype)
                return (u - 0.5) * x0_i  # nlsolver.h:2302-2323 semantics

            return jax.vmap(one)(agent_ids)

        agents = jax.vmap(init_agents)(keys_loc, x0_loc)     # [b_loc, p_loc, n]
        scores = jax.vmap(jax.vmap(fn))(agents)              # [b_loc, p_loc]

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

        def gathered(state):
            # ONE packed gather (agents with the score appended as an
            # extra column) instead of two — same values, same shard
            # order, half the per-generation rendezvous (round-4
            # collective diet; bit-identical results)
            # pack in the promoted dtype and cast back on unpack, so a
            # bf16 fleet with f32 scores keeps both exact (review finding)
            adt, sdt = state["agents"].dtype, state["scores"].dtype
            pdt = jnp.promote_types(adt, sdt)
            packed = jnp.concatenate(
                [
                    state["agents"].astype(pdt),
                    state["scores"][..., None].astype(pdt),
                ],
                axis=-1,
            )                                      # [b_loc, p_loc, n+1]
            g = lax.all_gather(packed, POP_AXIS, axis=1, tiled=True)
            return g[..., :n].astype(adt), g[..., n].astype(sdt)

        def cond(state):
            still = jnp.sum((~state["done"]).astype(jnp.int32))
            return lax.psum(still, DP_AXIS) > 0

        def body(state):
            agents_g, scores_g = gathered(state)
            best_now = jnp.min(scores_g, axis=1)                     # [b_loc]
            improved = best_now < state["best_value"]
            val_no_change = jnp.where(improved, 0, state["val_no_change"] + 1)
            spread = std_err(scores_g, axis=1)
            hit_tol = (val_no_change >= config.best_value_no_change) | (
                spread < config.eps
            )
            done_now = (state["iteration"] >= config.max_iter) | hit_tol

            if config.strategy == "best":
                fixed = jnp.broadcast_to(
                    jnp.argmin(scores_g, axis=1).astype(jnp.int32)[:, None],
                    (b_loc, p_loc),
                )
            else:
                fixed = jnp.broadcast_to(agent_ids[None, :], (b_loc, p_loc))

            def propose_row(inst_key, iteration, agents_g_i, fixed_i):
                def one(aid, fix):
                    k = _agent_step_key(inst_key, aid, iteration)
                    k_idx, k_dim, k_cross = jax.random.split(k, 3)
                    r = distinct_indices(k_idx, pop, fix, k=3)
                    fdim = jax.random.randint(k_dim, (), 0, n)
                    u = jax.random.uniform(
                        k_cross, (n,), dtype=agents_g_i.dtype
                    )
                    mutate = (u < config.crossover_prob) | (
                        jnp.arange(n) == fdim
                    )
                    donor = agents_g_i[r[0]] + config.differential_weight * (
                        agents_g_i[r[1]] - agents_g_i[r[2]]
                    )
                    return jnp.where(mutate, donor, agents_g_i[fix])

                return jax.vmap(one)(agent_ids, fixed_i)

            proposals = jax.vmap(propose_row)(
                keys_loc, state["iteration"], agents_g, fixed
            )  # [b_loc, p_loc, n]
            prop_scores = jax.vmap(jax.vmap(fn))(proposals)
            accept = prop_scores < state["scores"]
            new_agents = jnp.where(accept[..., None], proposals, state["agents"])
            new_scores = jnp.where(accept, prop_scores, state["scores"])

            worked = dict(
                agents=new_agents,
                scores=new_scores,
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
            # freeze finished lanes; halt newly-done lanes
            frozen = done_now | state["done"]

            def pick(a, b):
                m = frozen
                while m.ndim < jnp.asarray(a).ndim:
                    m = m[..., None]
                return jnp.where(m, a, b)

            merged = {
                k: pick(
                    jnp.where(
                        _bcast(state["done"], jnp.asarray(halted[k]).ndim),
                        state[k],
                        halted[k],
                    ),
                    worked[k],
                )
                for k in worked
            }
            return merged

        final = lax.while_loop(cond, body, init_state)
        agents_g, scores_g = gathered(final)
        best_idx = jnp.argmin(scores_g, axis=1)
        x_best = jnp.take_along_axis(
            agents_g, best_idx[:, None, None], axis=1
        )[:, 0, :]
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
