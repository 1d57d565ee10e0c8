"""High-throughput batched PSO, batch-minor (lane-axis) layout.

The general-purpose ``solvers.pso`` stores the swarm as ``[P, n]`` rows;
vmapping it over B problem instances puts the short ``dim`` on the
trailing axis and turns the per-instance swarm-best extraction
(``positions[argmin]``) into a vmapped dynamic-slice — a [B]-indexed
gather from an ``[B, P, n]`` array.  This driver is the layout for large
fleets, mirroring ``solvers/de_batched.py``:

  * the fleet lives as ``[n, P, B]`` — the INSTANCE batch on the trailing
    axis (always thousands wide), particles in the middle, coordinates
    leading;
  * every update is elementwise over the full ``[n, P, B]`` block; the
    swarm-best extraction is gather-free: an ``argmin``-vs-``iota`` one-hot
    mask and a reduction over the particle axis;
  * objectives are evaluated column-wise (nested ``vmap``), so a
    reduction-over-coordinates objective reduces over the LEADING axis with
    particles x instances vectorized behind it.

Semantics are identical to ``solvers.pso`` (the fixed vanilla/accelerated
updates, derived +/-|x_i| init bounds, particle-best-spread termination —
nlsolver.h:2496-2742 with the documented reference-bug fixes); only the
execution layout differs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import Bounds, SolverResult, make_result, signed, std_err
from ..core.driver import drive_fleet_scan  # noqa: F401  (bench entry point)
from .pso import PSOConfig, _derived_bounds  # noqa: F401  (shape-agnostic)


class PSOBatchState(NamedTuple):
    positions: jax.Array        # [n, P, B] batch-minor
    velocities: jax.Array       # [n, P, B]
    best_positions: jax.Array   # [n, P, B] per-particle best
    best_values: jax.Array      # [P, B]
    swarm_best_position: jax.Array  # [n, B]
    swarm_best_value: jax.Array     # [B]
    iteration: jax.Array        # [B]
    nfev: jax.Array             # [B]
    val_no_change: jax.Array    # [B]
    keys: jax.Array             # [B]
    done: jax.Array             # [B]
    converged: jax.Array        # [B]


def _eval_cols(fn, A):  # A: [n, P, B] -> [P, B]
    return jax.vmap(jax.vmap(fn, in_axes=1), in_axes=2, out_axes=1)(A)


def init(
    fn,
    x0: jax.Array,              # [B, n]
    config: PSOConfig,
    keys: jax.Array,            # [B]
    lower: jax.Array,           # [n, B]
    upper: jax.Array,           # [n, B]
) -> PSOBatchState:
    B, n = x0.shape
    P = config.n_particles
    dtype = x0.dtype

    def init_one(key, lo, hi):  # lo/hi: [n]
        key, k_pos, k_vel = jax.random.split(key, 3)
        u = jax.random.uniform(k_pos, (n, P), dtype=dtype)
        pos = lo[:, None] + (hi - lo)[:, None] * u
        span = jnp.abs(hi - lo)
        uv = jax.random.uniform(k_vel, (n, P), dtype=dtype)
        vel = span[:, None] * (2.0 * uv - 1.0)  # symmetric (see pso.init)
        return pos, vel, key

    positions, velocities, keys = jax.vmap(
        init_one, in_axes=(0, 1, 1), out_axes=(-1, -1, 0)
    )(keys, lower, upper)

    values = _eval_cols(fn, positions)          # [P, B]
    idx = jnp.argmin(values, axis=0)            # [B]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (P, B), 0) == idx[None, :]
    )
    swarm_best_position = jnp.sum(
        jnp.where(onehot[None, :, :], positions, 0.0), axis=1
    )                                           # [n, B]
    zeros = jnp.zeros((B,), jnp.int32)
    return PSOBatchState(
        positions=positions,
        velocities=velocities,
        best_positions=positions,
        best_values=values,
        swarm_best_position=swarm_best_position,
        swarm_best_value=jnp.min(values, axis=0),
        iteration=zeros,
        nfev=jnp.full((B,), P, jnp.int32),
        val_no_change=zeros,
        keys=keys,
        done=jnp.zeros((B,), bool),
        converged=jnp.zeros((B,), bool),
    )


def step(
    fn,
    state: PSOBatchState,
    config: PSOConfig,
    lower: Optional[jax.Array] = None,   # [n, B], only used when clamping
    upper: Optional[jax.Array] = None,
    clamp_positions: bool = False,
) -> PSOBatchState:
    n, P, B = state.positions.shape
    dtype = state.positions.dtype

    hit_tol = (state.val_no_change >= config.best_value_no_change) | (
        std_err(state.best_values, axis=0) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol
    # active-lane mask, folded INTO every big select below: a separate
    # freeze pass after the update would re-stream every [n, P, B] array
    # a second time (the cost of that pass on a GPU is not measured)
    act = ~(state.done | done_now)              # [B]
    a2 = act[None, :]                           # [P, B] broadcasts
    a3 = act[None, None, :]                     # [n, P, B] broadcasts

    def draw2(key):
        k1, k2, key = jax.random.split(key, 3)
        if config.accelerated:
            a = jax.random.normal(k1, (n, P), dtype)
            b = jnp.zeros((0,), dtype)  # unused
        else:
            a = jax.random.uniform(k1, (n, P), dtype=dtype)
            b = jax.random.uniform(k2, (n, P), dtype=dtype)
        return a, b, key

    ra, rb, keys = jax.vmap(draw2, out_axes=(-1, -1, 0))(state.keys)

    if config.accelerated:
        # inertia = inertia0^iter, per instance (nlsolver.h:2613)
        w = jnp.asarray(config.inertia, dtype) ** state.iteration.astype(dtype)
        cand_positions = (
            w[None, None, :] * ra
            + (1.0 - config.cognitive_coef) * state.positions
            + config.social_coef * state.swarm_best_position[:, None, :]
        )
        new_velocities = state.velocities
    else:
        nv = (
            config.inertia * state.velocities
            + config.cognitive_coef * ra * (state.best_positions - state.positions)
            + config.social_coef
            * rb
            * (state.swarm_best_position[:, None, :] - state.positions)
        )
        new_velocities = jnp.where(a3, nv, state.velocities)
        cand_positions = state.positions + nv

    if clamp_positions:
        cand_positions = jnp.clip(
            cand_positions, lower[:, None, :], upper[:, None, :]
        )
    new_positions = jnp.where(a3, cand_positions, state.positions)

    values = _eval_cols(fn, new_positions)      # [P, B]
    improved_particle = (values < state.best_values) & a2
    best_values = jnp.where(improved_particle, values, state.best_values)
    best_positions = jnp.where(
        improved_particle[None, :, :], new_positions, state.best_positions
    )

    # gather-free swarm-best: one-hot(argmin) mask + particle-axis reduce
    idx = jnp.argmin(values, axis=0)            # [B]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (P, B), 0) == idx[None, :]
    )
    cand_val = jnp.min(values, axis=0)          # [B]
    cand_pos = jnp.sum(jnp.where(onehot[None, :, :], new_positions, 0.0), axis=1)
    swarm_improved = (cand_val < state.swarm_best_value) & act
    swarm_best_value = jnp.where(
        swarm_improved, cand_val, state.swarm_best_value
    )
    swarm_best_position = jnp.where(
        swarm_improved[None, :], cand_pos, state.swarm_best_position
    )
    val_no_change = jnp.where(
        act,
        jnp.where(swarm_improved, 0, state.val_no_change + 1),
        state.val_no_change,
    )

    return PSOBatchState(
        positions=new_positions,
        velocities=new_velocities,
        best_positions=best_positions,
        best_values=best_values,
        swarm_best_position=swarm_best_position,
        swarm_best_value=swarm_best_value,
        iteration=state.iteration + act.astype(jnp.int32),
        nfev=state.nfev + P * act.astype(jnp.int32),
        val_no_change=val_no_change,
        keys=jnp.where(act, keys, state.keys),
        done=state.done | done_now,
        converged=jnp.where(state.done, state.converged, hit_tol),
    )


def _finalize(state: PSOBatchState, flip_sign: bool) -> SolverResult:
    f = state.swarm_best_value
    return make_result(
        x=state.swarm_best_position.T,     # [B, n]
        f_value=-f if flip_sign else f,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize_batched(
    fn,
    x0: jax.Array,                 # [B, n]
    config: PSOConfig = PSOConfig(),
    bounds: Optional[Bounds] = None,
    *,
    keys: Optional[jax.Array] = None,
    _minimize: bool = True,
) -> SolverResult:
    if keys is None:
        keys = jax.random.split(jax.random.key(0), x0.shape[0])
    elif keys.ndim == 0 or keys.shape[0] != x0.shape[0]:
        raise ValueError(
            "keys must carry one stream per instance: got "
            f"{'a single unsplit key' if keys.ndim == 0 else keys.shape[0]}"
            f" for {x0.shape[0]} instances (split with jax.random.split)"
        )
    sfn = signed(fn, _minimize)
    x0_cols = x0.T                              # [n, B]
    if bounds is None:
        lower, upper = _derived_bounds(x0_cols)
        clamp = False                           # init-only (nlsolver.h:2562)
    else:
        lower = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape).T
        upper = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape).T
        clamp = True
    state = init(sfn, x0, config, keys, lower, upper)

    from jax import lax

    state = lax.while_loop(
        lambda s: ~jnp.all(s.done),
        lambda s: step(sfn, s, config, lower, upper, clamp),
        state,
    )
    return _finalize(state, flip_sign=not _minimize)
