"""Objective-function handling.

The reference takes a stateful C++ functor by reference and wraps it in a
counting lambda with a compile-time sign (``f_multiplier``; nlsolver.h:
2177-2182).  Here an objective is any pure callable ``f(x: Array[n]) ->
scalar``; maximization is minimization of ``-f`` (README.md:139-140), batched
evaluation is ``vmap``, and evaluation counts live explicitly in solver state
(no hidden mutation — required for jit purity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

Objective = Callable[[jax.Array], jax.Array]


@dataclass(frozen=True)
class Bounds:
    """Box bounds. Arrays broadcastable against x."""

    lower: jax.Array
    upper: jax.Array


def signed(fn: Objective, minimize: bool) -> Objective:
    """Sign-wrap: maximization == minimization of -f."""
    if minimize:
        return fn
    return lambda x: -fn(x)


def with_eval_dtype(fn: Objective, dtype) -> Objective:
    """Evaluate ``fn`` in a reduced precision while the solver state stays
    float32.

    The wrapper casts the query point down to ``dtype`` (typically
    ``jnp.bfloat16``), evaluates, and casts the score back up to the query's
    original dtype, so solver bookkeeping (greedy comparisons, convergence
    statistics, counters) is unchanged.  The evaluation's memory traffic
    halves, which can pay for objective-bound fleets (the gain on a GPU is
    not measured).

    Accuracy: bf16 has ~8 significand bits, so scores carry ~2-3 decimal
    digits; convergence thresholds below ~1e-2 of the score's magnitude
    cannot be resolved.  See tests/test_bf16_eval.py for the measured
    effect on the classical test-function suite.
    """
    def wrapped(x: jax.Array) -> jax.Array:
        out_dtype = x.dtype
        return fn(x.astype(dtype)).astype(out_dtype)

    return wrapped


def batch_eval(fn: Objective, xs: jax.Array) -> jax.Array:
    """Evaluate fn over a batch of points [B, n] -> [B].

    This is the replacement for every sequential agent/vertex scoring
    loop in the reference (e.g. DE nlsolver.h:2423-2425, NM :2184-2186):
    one vmapped call XLA can fuse and tile.
    """
    return jax.vmap(fn)(xs)


def resolve_bounds(
    bounds: Optional[Bounds], x0: jax.Array
) -> tuple[jax.Array, jax.Array, bool]:
    """Return (lower, upper, bounded)."""
    if bounds is None:
        big = jnp.asarray(jnp.inf, x0.dtype)
        return (
            jnp.full_like(x0, -big),
            jnp.full_like(x0, big),
            False,
        )
    lower = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape)
    upper = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape)
    return lower, upper, True
