"""Multi-device PSO: swarms sharded over the mesh pop axis.

Unlike sharded DE (which must ``all_gather`` the agent matrix because every
agent mixes with random partners), PSO's only cross-shard dependency is the
swarm-best position plus the spread-based termination statistic.  Round 4
applies the island-DE collective-diet lesson: everything is
PACKED into ONE ``all_gather`` of a [b, p_loc + n + 1] block per
generation —

  1. each pop shard updates and evaluates its local particles;
  2. one gather carries (this shard's particle-best values block, its
     local candidate value, its candidate position);
  3. every shard reconstructs the full particle-best vector (bit-identical
     to the old dedicated gather), takes the spread, and selects the
     global candidate by argmin with ties to the lowest shard index
     (bit-identical to the old pmin + owner-pmin + masked-psum triple).

The spread is computed at the END of the generation that produced it and
carried in the state; the next generation's termination check reads it —
the same value the old code recomputed at the top of the next iteration,
so results are bit-identical with 4x fewer collectives per generation.
Randomness is layout-invariant via fold_in(instance_key,
global_particle_id, iteration).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from ..core import SolverResult, make_result, std_err
from ..core.utils import tree_where
from ..solvers.pso import PSOConfig
from .mesh import DP_AXIS, POP_AXIS


def minimize_sharded(
    fn,
    x0: jax.Array,                 # [B, n]
    config: PSOConfig,
    mesh,
    keys: Optional[jax.Array] = None,
) -> SolverResult:
    B, n = x0.shape
    P_total = config.n_particles
    dp_size = mesh.shape[DP_AXIS]
    pop_shards = mesh.shape[POP_AXIS]
    if B % dp_size or P_total % pop_shards:
        raise ValueError(
            f"batch {B} must divide over dp={dp_size} and n_particles "
            f"{P_total} over pop={pop_shards}"
        )
    if keys is None:
        keys = jax.random.split(jax.random.key(0), B)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DP_AXIS, None), P(DP_AXIS)),
        out_specs=(P(DP_AXIS, None), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS), P(DP_AXIS)),
        check_vma=False,
    )
    def solve(x0_loc, keys_loc):
        b_loc = x0_loc.shape[0]
        p_loc = P_total // pop_shards
        pop_idx = lax.axis_index(POP_AXIS)
        particle_ids = pop_idx * p_loc + jnp.arange(p_loc, dtype=jnp.int32)
        dtype = x0_loc.dtype

        def init_one(inst_key, x0_i):
            lower, upper = -jnp.abs(x0_i), jnp.abs(x0_i)
            span = upper - lower

            def one(pid):
                k = jax.random.fold_in(inst_key, pid)
                kp, kv = jax.random.split(k)
                pos = lower + span * jax.random.uniform(kp, (n,), dtype=dtype)
                vel = span * (2.0 * jax.random.uniform(kv, (n,), dtype=dtype) - 1.0)
                return pos, vel

            pos, vel = jax.vmap(one)(particle_ids)
            vals = jax.vmap(fn)(pos)
            return pos, vel, vals

        positions, velocities, values = jax.vmap(init_one)(keys_loc, x0_loc)

        def packed_best_and_spread(vals_loc, pos_loc, best_vals_loc):
            """ONE all_gather per call: global candidate (value, position)
            from this generation's evaluations + the spread of the full
            particle-best vector.  Bit-identical to the former
            gather + pmin + owner-pmin + masked-psum sequence."""
            loc_idx = jnp.argmin(vals_loc, axis=1)
            loc_val = jnp.take_along_axis(vals_loc, loc_idx[:, None], axis=1)[:, 0]
            loc_pos = jnp.take_along_axis(
                pos_loc, loc_idx[:, None, None], axis=1
            )[:, 0]
            vdt, xdt = best_vals_loc.dtype, loc_pos.dtype
            pdt = jnp.promote_types(vdt, xdt)
            packed = jnp.concatenate(
                [
                    best_vals_loc.astype(pdt),
                    loc_val[:, None].astype(pdt),
                    loc_pos.astype(pdt),
                ],
                axis=1,
            )                                           # [b, p_loc + 1 + n]
            g = lax.all_gather(packed, POP_AXIS, axis=0, tiled=False)
            # [shards, b, p_loc + 1 + n]
            bv_all = jnp.swapaxes(g[:, :, :p_loc], 0, 1).reshape(
                b_loc, pop_shards * p_loc
            ).astype(vdt)                               # == tiled gather order
            spread = std_err(bv_all, axis=1)
            cand_vals = g[:, :, p_loc].astype(vdt)      # [shards, b]
            owner = jnp.argmin(cand_vals, axis=0)       # ties -> lowest shard
            glob_val = jnp.min(cand_vals, axis=0)
            pos_all = g[:, :, p_loc + 1 :]              # [shards, b, n]
            glob_pos = jnp.take_along_axis(
                pos_all, owner[None, :, None], axis=0
            )[0].astype(xdt)
            return glob_val, glob_pos, spread

        sb_val, sb_pos, spread0 = packed_best_and_spread(
            values, positions, values
        )

        state = dict(
            positions=positions,
            velocities=velocities,
            values=values,
            best_positions=positions,
            best_values=values,
            swarm_best_value=sb_val,       # [b_loc]
            swarm_best_position=sb_pos,    # [b_loc, n]
            spread=spread0,                # [b_loc] particle-best spread
            iteration=jnp.zeros((b_loc,), jnp.int32),
            nfev=jnp.full((b_loc,), P_total, jnp.int32),
            val_no_change=jnp.zeros((b_loc,), jnp.int32),
            done=jnp.zeros((b_loc,), bool),
            converged=jnp.zeros((b_loc,), bool),
        )

        def cond(s):
            still = jnp.sum((~s["done"]).astype(jnp.int32))
            return lax.psum(still, DP_AXIS) > 0

        def body(s):
            # termination on the spread of particle-best values, carried
            # from the END of the generation that produced them (same
            # value the old code recomputed here with a dedicated gather)
            hit_tol = (s["val_no_change"] >= config.best_value_no_change) | (
                s["spread"] < config.eps
            )
            done_now = (s["iteration"] >= config.max_iter) | hit_tol

            def upd_row(inst_key, iteration, pos, vel, sb_pos_i, bp):
                def one(pid, p_i, v_i, bp_i):
                    k = jax.random.fold_in(
                        jax.random.fold_in(inst_key, pid), iteration
                    )
                    kp, kg = jax.random.split(k)
                    r_p = jax.random.uniform(kp, (n,), dtype=dtype)
                    r_g = jax.random.uniform(kg, (n,), dtype=dtype)
                    v_new = (
                        config.inertia * v_i
                        + config.cognitive_coef * r_p * (bp_i - p_i)
                        + config.social_coef * r_g * (sb_pos_i - p_i)
                    )
                    return p_i + v_new, v_new

                return jax.vmap(one)(particle_ids, pos, vel, bp)

            new_pos, new_vel = jax.vmap(upd_row)(
                keys_loc,
                s["iteration"],
                s["positions"],
                s["velocities"],
                s["swarm_best_position"],
                s["best_positions"],
            )
            new_vals = jax.vmap(jax.vmap(fn))(new_pos)

            improved = new_vals < s["best_values"]
            best_values = jnp.where(improved, new_vals, s["best_values"])
            best_positions = jnp.where(
                improved[..., None], new_pos, s["best_positions"]
            )
            cand_val, cand_pos, new_spread = packed_best_and_spread(
                new_vals, new_pos, best_values
            )
            sw_improved = cand_val < s["swarm_best_value"]
            sb_val = jnp.where(sw_improved, cand_val, s["swarm_best_value"])
            sb_pos = jnp.where(sw_improved[:, None], cand_pos, s["swarm_best_position"])
            vnc = jnp.where(sw_improved, 0, s["val_no_change"] + 1)

            worked = dict(
                positions=new_pos,
                velocities=new_vel,
                values=new_vals,
                best_positions=best_positions,
                best_values=best_values,
                swarm_best_value=sb_val,
                swarm_best_position=sb_pos,
                spread=new_spread,
                iteration=s["iteration"] + 1,
                nfev=s["nfev"] + P_total,
                val_no_change=vnc,
                done=jnp.zeros_like(s["done"]),
                converged=jnp.zeros_like(s["converged"]),
            )
            halted = dict(
                s, val_no_change=vnc, done=jnp.ones_like(s["done"]), converged=hit_tol
            )
            frozen = s["done"]
            merged = {}
            for k2 in worked:
                step_val = tree_where(done_now, halted[k2], worked[k2])
                merged[k2] = tree_where(frozen, s[k2], step_val)
            return merged

        final = lax.while_loop(cond, body, state)
        return (
            final["swarm_best_position"],
            final["swarm_best_value"],
            final["iteration"],
            final["nfev"],
            final["converged"],
        )

    x, f, iters, nfev, conv = solve(x0, keys)
    return make_result(
        x=x, f_value=f, iterations=iters, function_calls=nfev, converged=conv
    )
