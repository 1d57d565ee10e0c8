"""Small numeric helpers shared by all solvers.

These replace the reference's hand-rolled AVX vector math in
``nlsolver::math`` (nlsolver.h:57-1175): under XLA every one of those kernels
is a single fused vector op, so the only things worth keeping as named
helpers are the statistical/structural utilities below.
"""
from __future__ import annotations

from typing import TypeVar

import jax
import jax.numpy as jnp
from jax import lax

T = TypeVar("T")

# Precision for every matrix product in a solver step.  At default
# precision a float32 product may run in TF32 on a GPU (a 10-bit
# mantissa), which breaks steps that rely on exact f32 arithmetic; the
# global ``jax_default_matmul_precision`` is left alone because user
# objectives run under it too.
HIGHEST = lax.Precision.HIGHEST


def max_abs(x: jax.Array) -> jax.Array:
    """Infinity norm (reference: max_abs_vec, nlsolver.h:1894-1904)."""
    return jnp.max(jnp.abs(x))


def exact_product(x: jax.Array) -> jax.Array:
    """Identity that keeps a product from being FMA-contracted into a
    following add.

    The trajectory-parity golden binaries target baseline x86-64 (no FMA
    ISA), so ``a + w*b`` there rounds the product and the sum separately;
    XLA:CPU's LLVM pipeline otherwise fuses the pair into one fmuladd
    (e.g. it evaluates ``(z + a*p) + b*s`` as ``fma(b, s, fma(a, p, z))``
    — measured).  Wrapping the product in this helper restores separate
    rounding.  Implementation: a 2-element sort is a runtime library call
    on XLA:CPU, a true optimization boundary — ``optimization_barrier``,
    selects on runtime predicates, and int-bitcast round-trips are all
    folded away by the fast-math pipeline (each verified ineffective on
    a 4000-sample probe; the sort gives 0/4000 mismatches vs the no-FMA
    reference arithmetic).  Parity/debug paths only — never on the
    production hot path."""
    return jnp.sort(jnp.stack([x, x]), axis=0)[0]


def std_err(scores: jax.Array, axis: int = -1) -> jax.Array:
    """Sample standard deviation of scores (reference: std_err,
    nlsolver.h:2037-2052 — divides by n-1, despite the name it is not a
    standard error).  Used as the population-spread convergence measure by
    NM / DE / PSO / NM-PSO."""
    n = scores.shape[axis]
    mean = jnp.mean(scores, axis=axis, keepdims=True)
    var = jnp.sum((scores - mean) ** 2, axis=axis) / max(n - 1, 1)
    return jnp.sqrt(var)


def tree_where(pred: jax.Array, on_true: T, on_false: T) -> T:
    """Elementwise select over a whole pytree.

    The masked-lane workhorse: once a problem instance has terminated, its
    state is frozen by selecting the old state, so a single
    ``lax.while_loop`` can drive a vmapped batch whose instances finish at
    different iterations (replaces the reference's per-problem early
    ``return``, e.g. nlsolver.h:2233-2237).
    """
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(_expand(pred, jnp.asarray(a).ndim), a, b),
        on_true,
        on_false,
    )


def _expand(pred: jax.Array, ndim: int) -> jax.Array:
    pred = jnp.asarray(pred)
    while pred.ndim < ndim:
        pred = pred[..., None]
    return pred


def clamp(x: jax.Array, lower, upper) -> jax.Array:
    """Clamp to box bounds (reference: simplex_transform's std::clamp,
    nlsolver.h:2002-2004)."""
    return jnp.clip(x, lower, upper)
