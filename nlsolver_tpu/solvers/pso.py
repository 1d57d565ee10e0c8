"""Particle Swarm Optimization (vanilla + accelerated).

Re-creation of the reference's ``PSO`` class (nlsolver.h:2496-2742) with the
swarm as ``[n_particles, dim]`` arrays updated by fused vector ops and a
single vmapped objective call per iteration.

Deliberate fixes over the reference (per SURVEY.md §2 the reference's vanilla
update is broken and its own tests fail because of it):

  * the cognitive term uses the particle's best-known position — the
    reference computes ``pos[i][j] - pos[i][j]`` (a no-op, nlsolver.h:2670)
    and never updates ``particle_best_positions`` at all;
  * the social term indexes the swarm-best position by *dimension* — the
    reference indexes it by particle (``swarm_best_position[i]``,
    nlsolver.h:2674, an out-of-bounds read);
  * the stagnation counter increments when no swarm-best improvement
    happened — the reference keys it on ``best_index == 0``
    (nlsolver.h:2740).

Everything else follows the reference: derived bounds ±|x_i| when called
unbounded (used for initialization only; clamping happens only in the
bounded entry points — nlsolver.h:2553-2562 vs :2617-2619), inertia schedule
``inertia^iter`` for accelerated PSO with position update
``w*N(0,1) + (1-cognitive)*pos + social*best`` (nlsolver.h:2610-2615,
:2687-2699), and the composite termination rule on particle-best spread
(nlsolver.h:2599-2600).
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


@dataclass(frozen=True)
class PSOConfig:
    """Defaults from nlsolver.h:2522-2526."""

    inertia: float = 0.8
    cognitive_coef: float = 1.8
    social_coef: float = 1.8
    n_particles: int = 10
    max_iter: int = 5000
    best_value_no_change: int = 50
    eps: float = 1e-3
    accelerated: bool = False   # PSOType {Vanilla, Accelerated}


class PSOState(NamedTuple):
    positions: jax.Array        # [P, n]
    velocities: jax.Array       # [P, n] (unused rows of zeros for accelerated)
    best_positions: jax.Array   # [P, n] per-particle best
    best_values: jax.Array      # [P]
    swarm_best_position: jax.Array  # [n]
    swarm_best_value: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    val_no_change: jax.Array
    key: jax.Array
    done: jax.Array
    converged: jax.Array


def _derived_bounds(x0: jax.Array):
    """Unbounded entry point derives per-dim bounds ±|x_i| (nlsolver.h:2554-2560)."""
    t = jnp.abs(x0)
    return -t, t


def init(
    fn: Objective,
    x0: jax.Array,
    config: PSOConfig,
    key: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
) -> PSOState:
    n = x0.shape[-1]
    P = config.n_particles
    key, k_pos, k_vel = jax.random.split(key, 3)
    u = jax.random.uniform(k_pos, (P, n), dtype=x0.dtype)
    positions = lower[None, :] + (upper - lower)[None, :] * u
    span = jnp.abs(upper - lower)
    uv = jax.random.uniform(k_vel, (P, n), dtype=x0.dtype)
    # symmetric initial velocities in (-span, span); the reference draws from
    # [-span, 0) (nlsolver.h:2649) which is an asymmetry with no rationale
    velocities = span[None, :] * (2.0 * uv - 1.0)

    values = batch_eval(fn, positions)
    best_idx = jnp.argmin(values)
    return PSOState(
        positions=positions,
        velocities=velocities,
        best_positions=positions,
        best_values=values,
        swarm_best_position=positions[best_idx],
        swarm_best_value=values[best_idx],
        iteration=jnp.int32(0),
        nfev=jnp.int32(P),
        val_no_change=jnp.int32(0),
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(
    fn: Objective,
    state: PSOState,
    config: PSOConfig,
    lower: jax.Array,
    upper: jax.Array,
    clamp_positions: bool,
) -> PSOState:
    P, n = state.positions.shape
    dtype = state.positions.dtype

    hit_tol = (state.val_no_change >= config.best_value_no_change) | (
        std_err(state.best_values) < config.eps
    )
    done_now = (state.iteration >= config.max_iter) | hit_tol
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol)

    key, k1, k2 = jax.random.split(state.key, 3)

    if config.accelerated:
        # inertia = inertia0^iter (nlsolver.h:2613); position update inlines
        # the velocity (nlsolver.h:2687-2699)
        w = jnp.asarray(config.inertia, dtype) ** state.iteration.astype(dtype)
        noise = jax.random.normal(k1, (P, n), dtype)
        new_positions = (
            w * noise
            + (1.0 - config.cognitive_coef) * state.positions
            + config.social_coef * state.swarm_best_position[None, :]
        )
        new_velocities = state.velocities
    else:
        r_p = jax.random.uniform(k1, (P, n), dtype=dtype)
        r_g = jax.random.uniform(k2, (P, n), dtype=dtype)
        new_velocities = (
            config.inertia * state.velocities
            + config.cognitive_coef * r_p * (state.best_positions - state.positions)
            + config.social_coef * r_g * (state.swarm_best_position[None, :] - state.positions)
        )
        new_positions = state.positions + new_velocities

    if clamp_positions:
        new_positions = jnp.clip(new_positions, lower[None, :], upper[None, :])

    values = batch_eval(fn, new_positions)
    improved_particle = values < state.best_values
    best_values = jnp.where(improved_particle, values, state.best_values)
    best_positions = jnp.where(
        improved_particle[:, None], new_positions, state.best_positions
    )

    cand_idx = jnp.argmin(values)
    cand_val = values[cand_idx]
    swarm_improved = cand_val < state.swarm_best_value
    swarm_best_value = jnp.where(swarm_improved, cand_val, state.swarm_best_value)
    swarm_best_position = jnp.where(
        swarm_improved, new_positions[cand_idx], state.swarm_best_position
    )
    val_no_change = jnp.where(swarm_improved, 0, state.val_no_change + 1)

    worked = PSOState(
        positions=new_positions,
        velocities=new_velocities,
        best_positions=best_positions,
        best_values=best_values,
        swarm_best_position=swarm_best_position,
        swarm_best_value=swarm_best_value,
        iteration=state.iteration + 1,
        nfev=state.nfev + P,
        val_no_change=val_no_change,
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: PSOState, flip_sign: bool) -> SolverResult:
    f_val = state.swarm_best_value
    return make_result(
        x=state.swarm_best_position,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: PSOConfig = PSOConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    _minimize: bool = True,
) -> SolverResult:
    if key is None:
        key = jax.random.key(0)
    sfn = signed(fn, _minimize)
    if bounds is None:
        lower, upper = _derived_bounds(x0)
        clamp_positions = False  # derived bounds only seed the init (:2562)
    else:
        lower = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape)
        upper = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape)
        clamp_positions = True
    state = init(sfn, x0, config, key, lower, upper)
    state = drive(
        lambda s: step(sfn, s, config, lower, upper, clamp_positions), state
    )
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: PSOConfig = PSOConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
