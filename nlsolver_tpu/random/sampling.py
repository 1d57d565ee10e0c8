"""Sampling utilities built on counter-based ``jax.random`` keys.

The reference threads stateful RNG functors (xorshift/xoshiro/splitmix/...,
nlsolver.h:1176-1382) by reference through every solver.  This design
replaces them with splittable threefry keys carried in solver state —
deterministic under ``jit``/``vmap`` and invariant to sharding layout when
keys are split per (instance, agent).  Bit-exact re-creations of the
reference generators (for parity oracles) live in ``reference_rngs.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def uniform_like(key: jax.Array, template: jax.Array, shape=None) -> jax.Array:
    shape = template.shape if shape is None else shape
    return jax.random.uniform(key, shape, dtype=template.dtype)


def distinct_indices(
    key: jax.Array, pop_size: int, fixed: jax.Array, k: int = 3
) -> jax.Array:
    """Draw ``k`` mutually-distinct indices in ``[0, pop_size)``, each also
    distinct from ``fixed``.

    Vectorized, rejection-free reformulation of the reference's
    unordered_set rejection loop (``generate_indices``, nlsolver.h:2331-2355),
    which cannot run under ``vmap``.  Uses the successive-shift trick: the
    j-th draw is sampled from ``pop_size - 1 - j`` values and shifted past
    the (sorted) already-excluded indices, which yields the same uniform
    distribution over ordered distinct tuples.

    Args:
      fixed: scalar or [B] array of reserved indices.
    Returns:
      [k] (scalar fixed) or [B, k] array of indices.
    """
    fixed = jnp.asarray(fixed)
    batch_shape = fixed.shape
    keys = jax.random.split(key, k)

    exclusions = fixed[..., None]  # [..., 1] running sorted exclusion list
    out = []
    for j in range(k):
        r = jax.random.randint(
            keys[j], batch_shape, 0, pop_size - 1 - j, dtype=jnp.int32
        )
        # shift past each sorted exclusion in increasing order
        sorted_ex = jnp.sort(exclusions, axis=-1)
        for e_idx in range(sorted_ex.shape[-1]):
            r = r + (r >= sorted_ex[..., e_idx]).astype(jnp.int32)
        out.append(r)
        exclusions = jnp.concatenate([exclusions, r[..., None]], axis=-1)
    return jnp.stack(out, axis=-1)


def rnorm(key: jax.Array, shape=(), dtype=jnp.float32) -> jax.Array:
    """Standard normal draws.

    The reference uses a Box–Muller transform with pi truncated to 3.141593
    (nlsolver.h:2479-2494); here we use jax.random.normal (exact, vectorized).
    ``box_muller_parity`` below reproduces the reference formula for
    numerical cross-checks.
    """
    return jax.random.normal(key, shape, dtype)


def box_muller_parity(u1: jax.Array, u2: jax.Array) -> jax.Array:
    """Reference-parity Box–Muller (nlsolver.h:2479-2485): given two uniforms,
    return sqrt(-2 log u1) * cos(2*pi_trunc*u2) with pi_ = 3.141593."""
    pi_trunc = 3.141593
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * pi_trunc * u2)
