"""High-throughput batched SANN, batch-minor (lane-axis) layout.

``solvers.sann`` under ``vmap`` carries the chain point as ``[B, n]`` rows —
the objective then reduces over the TRAILING (lane) axis per instance, the
slow reduction direction, and every inner proposal splits B keys
one-instance-at-a-time.  This driver is the fleet layout: the chain
lives as ``[n, B]`` with the instance batch on the trailing axis, each
Metropolis proposal is one fused elementwise
block over the whole fleet, and the objective reduces over the LEADING
coordinate axis with B vectorized behind it.

Semantics are identical to ``solvers.sann`` (Boltzmann cooling
t = T_max/log(iter+e-1), Gaussian kernel scaled by t/T_max,
``temperature_iter - 1`` inner proposals per outer iteration, Metropolis
acceptance vs the current chain value with the ``metropolis_vs_best``
reference-parity quirk — nlsolver.h:2744-2815); only the execution layout
differs.  The proposals within a chain are inherently sequential (a Markov
chain), so all parallelism is across instances — exactly what the lane
axis is for.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import Bounds, SolverResult, make_result, signed
from ..core.driver import drive_fleet_scan  # noqa: F401  (bench entry point)
from .sann import E_MINUS_1, SANNConfig


class SANNBatchState(NamedTuple):
    p: jax.Array            # [n, B] current chain points
    f_p: jax.Array          # [B]
    x_best: jax.Array       # [n, B]
    best_value: jax.Array   # [B]
    iteration: jax.Array    # [B]
    nfev: jax.Array         # [B]
    keys: jax.Array         # [B]
    done: jax.Array         # [B]
    converged: jax.Array    # [B]


def _eval_cols(fn, X):  # X: [n, B] -> [B]
    return jax.vmap(fn, in_axes=1)(X)


def init(fn, x0: jax.Array, config: SANNConfig, keys: jax.Array) -> SANNBatchState:
    """x0: [B, n] start points; keys: [B]."""
    B, n = x0.shape
    p = x0.T
    val = _eval_cols(fn, p)
    return SANNBatchState(
        p=p,
        f_p=val,
        x_best=p,
        best_value=val,
        iteration=jnp.zeros((B,), jnp.int32),
        nfev=jnp.ones((B,), jnp.int32),
        keys=keys,
        done=jnp.zeros((B,), bool),
        converged=jnp.zeros((B,), bool),
    )


def step(fn, state: SANNBatchState, config: SANNConfig) -> SANNBatchState:
    n, B = state.p.shape
    dtype = state.p.dtype

    done_now = state.iteration >= config.max_iter

    t = config.temperature_max / jnp.log(
        state.iteration.astype(dtype) + E_MINUS_1
    )                                           # [B]
    scale = t / config.temperature_max          # [B]

    n_inner = config.temperature_iter - 1
    # per-(instance, iteration, proposal) streams: one split per instance
    # per outer step, then a scan-carried per-proposal fold_in
    def split_one(key):
        key, k_inner = jax.random.split(key)
        return key, k_inner

    keys, k_inner = jax.vmap(split_one)(state.keys)

    def proposal(carry, j):
        p, f_p, x_best, best_value = carry
        kj = jax.vmap(jax.random.fold_in, in_axes=(0, None))(k_inner, j)

        def draw(k):
            k_step, k_accept = jax.random.split(k)
            return (
                jax.random.normal(k_step, (n,), dtype),
                jax.random.uniform(k_accept, (), dtype=dtype),
            )

        noise, u = jax.vmap(draw, out_axes=(-1, 0))(kj)   # [n, B], [B]
        p_try = p + scale[None, :] * noise
        val = _eval_cols(fn, p_try)                       # [B]
        anchor = best_value if config.metropolis_vs_best else f_p
        diff = val - anchor
        accept = (diff <= 0.0) | (u < jnp.exp(-diff / t))
        p = jnp.where(accept[None, :], p_try, p)
        f_p = jnp.where(accept, val, f_p)
        better = accept & (val <= best_value)
        x_best = jnp.where(better[None, :], p_try, x_best)
        best_value = jnp.where(better, val, best_value)
        return (p, f_p, x_best, best_value), None

    (p, f_p, x_best, best_value), _ = lax.scan(
        proposal,
        (state.p, state.f_p, state.x_best, state.best_value),
        jnp.arange(n_inner),
    )

    # freeze finished lanes (same single-select pattern as the PSO/DE
    # fleets; the [n, B] state here is small next to the 9-proposal inner
    # loop, so this is consistency more than bandwidth)
    act = ~(state.done | done_now)
    a2 = act[None, :]
    return SANNBatchState(
        p=jnp.where(a2, p, state.p),
        f_p=jnp.where(act, f_p, state.f_p),
        x_best=jnp.where(a2, x_best, state.x_best),
        best_value=jnp.where(act, best_value, state.best_value),
        iteration=state.iteration + act.astype(jnp.int32),
        nfev=state.nfev + n_inner * act.astype(jnp.int32),
        keys=jnp.where(act, keys, state.keys),
        done=state.done | done_now,
        # SANN terminates only on max_iter (nlsolver.h:2787)
        converged=state.done | done_now,
    )


def _finalize(state: SANNBatchState, flip_sign: bool) -> SolverResult:
    f = state.best_value
    return make_result(
        x=state.x_best.T,                  # [B, n]
        f_value=-f if flip_sign else f,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize_batched(
    fn,
    x0: jax.Array,                 # [B, n]
    config: SANNConfig = SANNConfig(),
    bounds: Optional[Bounds] = None,   # accepted for API symmetry; unused
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
    state = init(sfn, x0, config, keys)
    state = lax.while_loop(
        lambda s: ~jnp.all(s.done),
        lambda s: step(sfn, s, config),
        state,
    )
    return _finalize(state, flip_sign=not _minimize)
