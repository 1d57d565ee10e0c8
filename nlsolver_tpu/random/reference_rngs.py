"""Bit-exact functional re-creations of the reference RNG functors.

Reference: ``nlsolver::rng`` (nlsolver.h:1176-1382) — halton, recurrent,
splitmix64, xoshiro256+, xorshift128+.  The production randomness path is
counter-based ``jax.random`` keys (see ``sampling.py``); these exist for

  * numerical parity testing against the reference binary (the native C++
    oracle in ``nlsolver_tpu/native`` implements the identical generators);
  * users porting experiments that depend on the reference streams;
  * ``get_state``/``set_state`` checkpoint semantics (the only resumable
    state the reference has — SURVEY.md §5).

64-bit integer arithmetic is emulated with uint32 (hi, lo) pairs so the
generators run under jit/vmap without ``jax_enable_x64``.  Seeding
quirks are reproduced faithfully: splitmix starts from 12374563468
(nlsolver.h:1265), and xoshiro's third word is seeded from
``(uint64)splitmix.yield()`` — a float in [0, 1) truncated to ZERO
(nlsolver.h:1295), so only two of its four words carry entropy.

All generators are (state) -> (u, state) pure functions; ``sample`` scans
out a sequence.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

U32 = jnp.uint32
_MAX64_F = 18446744073709551615.0


class U64(NamedTuple):
    hi: jax.Array
    lo: jax.Array


def u64(hi: int, lo: int) -> U64:
    return U64(jnp.asarray(hi, U32), jnp.asarray(lo, U32))


def from_int(v: int) -> U64:
    return u64((v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF)


def to_float(a: U64, dtype=jnp.float32) -> jax.Array:
    """(scalar_t)u64 / (scalar_t)(2^64 - 1), matching the C++ conversion.

    The u64 -> float value is computed in the widest available float so the
    single rounding of the C++ cast is reproduced.
    """
    wide = jnp.float64 if jnp.zeros((), jnp.float64).dtype == jnp.float64 else jnp.float32
    h = a.hi.astype(wide)
    l = a.lo.astype(wide)
    return ((h * 4294967296.0 + l) / _MAX64_F).astype(dtype)


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(U32)
    return U64(a.hi + b.hi + carry, lo)


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def shl(a: U64, k: int) -> U64:
    if k == 0:
        return a
    if k == 32:
        return U64(a.lo, jnp.zeros_like(a.lo))
    if k > 32:
        return U64(a.lo << (k - 32), jnp.zeros_like(a.lo))
    return U64((a.hi << k) | (a.lo >> (32 - k)), a.lo << k)


def shr(a: U64, k: int) -> U64:
    if k == 0:
        return a
    if k == 32:
        return U64(jnp.zeros_like(a.hi), a.hi)
    if k > 32:
        return U64(jnp.zeros_like(a.hi), a.hi >> (k - 32))
    return U64(a.hi >> k, (a.lo >> k) | (a.hi << (32 - k)))


def rotl(a: U64, k: int) -> U64:
    left = shl(a, k)
    right = shr(a, 64 - k)
    return U64(left.hi | right.hi, left.lo | right.lo)


def _mul32(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """32x32 -> (hi32, lo32) via 16-bit limbs (no 64-bit ints needed)."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def mul(a: U64, b: U64) -> U64:
    """Low 64 bits of a * b."""
    hi, lo = _mul32(a.lo, b.lo)
    hi = hi + a.lo * b.hi + a.hi * b.lo  # wrap-around products, low 32 only
    return U64(hi, lo)


# ---------------------------------------------------------------- splitmix64

@lru_cache(maxsize=None)
def _splitmix_consts():
    """Materialized lazily: module-level jnp constants would initialize the
    XLA backend at import time, which breaks jax.distributed.initialize()
    in multi-process launches (tests/distributed_child.py)."""
    return (
        from_int(0x9E3779B97F4A7C15),   # golden ratio increment
        from_int(0xBF58476D1CE4E5B9),
        from_int(0x94D049BB133111EB),
    )
SPLITMIX_DEFAULT_SEED = 12374563468  # nlsolver.h:1265


class SplitmixState(NamedTuple):
    s: U64


def splitmix_init(seed: int = SPLITMIX_DEFAULT_SEED) -> SplitmixState:
    return SplitmixState(from_int(seed))


def splitmix_next_u64(state: SplitmixState) -> Tuple[U64, SplitmixState]:
    """splitmix64 step (nlsolver.h:1266-1278)."""
    golden, m1, m2 = _splitmix_consts()
    s = add(state.s, golden)
    r = mul(xor(s, shr(s, 30)), m1)
    r = mul(xor(r, shr(r, 27)), m2)
    r = xor(r, shr(r, 31))
    return r, SplitmixState(s)


def splitmix_next(state: SplitmixState, dtype=jnp.float32):
    r, state = splitmix_next_u64(state)
    return to_float(r, dtype), state


# ------------------------------------------------------------- xoshiro256+

class XoshiroState(NamedTuple):
    s0: U64
    s1: U64
    s2: U64
    s3: U64


def xoshiro_init() -> XoshiroState:
    """Reference seeding (nlsolver.h:1291-1297): s0 = splitmix u64,
    s1 = s0 >> 32, s2 = (uint64)(float splitmix yield) == 0, s3 = 0."""
    sm = splitmix_init()
    s0, sm = splitmix_next_u64(sm)
    s1 = shr(s0, 32)
    zero = u64(0, 0)
    return XoshiroState(s0, s1, zero, zero)


def xoshiro_next(state: XoshiroState, dtype=jnp.float32):
    """xoshiro256+ step (nlsolver.h:1298-1311)."""
    s0, s1, s2, s3 = state
    result = add(s0, s3)
    t = shl(s1, 17)
    s2 = xor(s2, s0)
    s3 = xor(s3, s1)
    s1 = xor(s1, s2)
    s0 = xor(s0, s3)
    s2 = xor(s2, t)
    s3 = rotl(s3, 45)
    return to_float(result, dtype), XoshiroState(s0, s1, s2, s3)


# ------------------------------------------------------------ xorshift128+

class XorshiftState(NamedTuple):
    x0: U64
    x1: U64


def xorshift_init() -> XorshiftState:
    """Reference seeding (nlsolver.h:1345-1349): x0 = splitmix u64,
    x1 = x0 >> 32."""
    sm = splitmix_init()
    x0, sm = splitmix_next_u64(sm)
    return XorshiftState(x0, shr(x0, 32))


def xorshift_next(state: XorshiftState, dtype=jnp.float32):
    """xorshift128+ step (nlsolver.h:1350-1360).  NOTE the reference's
    return quirk: it computes (scalar_t)((t + s) / (scalar_t)MAX) where the
    integer t+s is divided AFTER converting only the denominator — i.e.
    standard u64->float conversion of (t+s) then divide; reproduced here."""
    t = state.x0
    s = state.x1
    x0 = s
    t = xor(t, shl(t, 23))
    t = xor(t, shr(t, 18))
    t = xor(t, xor(s, shr(s, 5)))
    return to_float(add(t, s), dtype), XorshiftState(x0, t)


# ----------------------------------------------------------------- halton

class HaltonState(NamedTuple):
    b: jax.Array
    y: jax.Array
    n: jax.Array
    d: jax.Array
    x: jax.Array


def halton_init(base: float = 2.0, dtype=jnp.float32) -> HaltonState:
    z = lambda v: jnp.asarray(v, dtype)
    return HaltonState(z(base), z(1), z(0), z(1), z(1))


def halton_next(state: HaltonState):
    """Van der Corput / Halton step (nlsolver.h:1182-1195)."""
    b, y, n, d, x = state
    x = d - n

    def simple(_):
        return jnp.asarray(1.0, d.dtype), d * b, y

    def general(_):
        def cond(c):
            yc, nc = c
            return x <= yc

        def body(c):
            yc, nc = c
            yc = yc / b
            return yc, (b + 1.0) * yc - x

        y0, n0 = lax.while_loop(cond, body, (d, n))
        return n0, d, y0

    n2, d2, y2 = lax.cond(x == 1.0, simple, general, None)
    return n2 / d2, HaltonState(b, y2, n2, d2, x)


# ---------------------------------------------------------------- recurrent

class RecurrentState(NamedTuple):
    alpha: jax.Array
    z: jax.Array


def recurrent_init(seed: float = 0.5, dtype=jnp.float32) -> RecurrentState:
    alpha = jnp.asarray(0.618034, dtype)
    z = alpha + jnp.asarray(seed, dtype)
    z = z - jnp.floor(z)
    return RecurrentState(alpha, z)


def recurrent_next(state: RecurrentState):
    """Additive recurrence modulo 1 (nlsolver.h:1236-1241)."""
    z = state.z + state.alpha
    z = z - jnp.floor(z)
    return z, RecurrentState(state.alpha, z)


# ------------------------------------------------------------------ common

_NEXT = {
    "splitmix": lambda s: splitmix_next(s),
    "xoshiro": lambda s: xoshiro_next(s),
    "xorshift": lambda s: xorshift_next(s),
    "halton": halton_next,
    "recurrent": recurrent_next,
}

_INIT = {
    "splitmix": splitmix_init,
    "xoshiro": xoshiro_init,
    "xorshift": xorshift_init,
    "halton": halton_init,
    "recurrent": recurrent_init,
}


# user-registered generators: kind -> (init_fn(dtype) -> state,
#                                       next_fn(state) -> (u, state))
_CUSTOM = {}


def register(kind: str, init_fn, next_fn) -> None:
    """Register a user generator under ``kind`` for use anywhere a named
    generator is accepted (the reference-emulation solver configs take
    ``rng="<kind>"``).

    This is the analogue of the reference's RNG-functor interop: its test
    harness wraps ``std::mt19937`` in a tiny functor yielding U[0,1)
    (test_functions.h:40-48) and passes it to any solver.  Here a generator
    is the functional pair ``init_fn(dtype) -> state`` (a pytree of arrays)
    and ``next_fn(state) -> (u, state)`` — pure, so it composes with jit /
    scan / checkpointing exactly like the built-ins."""
    _CUSTOM[kind] = (init_fn, next_fn)


def make(kind: str, dtype=jnp.float32):
    """Return (init_state, next_fn) for a generator kind.

    ``dtype`` selects the float width of the emitted variates (and the
    internal state of the float-state generators halton/recurrent — the
    reference's ``recurrent<double>`` stream differs from ``recurrent<float>``
    because rounding error accumulates in the modular addition)."""
    if kind in _CUSTOM:
        init_fn, next_fn = _CUSTOM[kind]
        return init_fn(dtype), next_fn
    if kind in ("halton", "recurrent"):
        return _INIT[kind](dtype=dtype), _NEXT[kind]
    bit_next = {
        "splitmix": splitmix_next,
        "xoshiro": xoshiro_next,
        "xorshift": xorshift_next,
    }[kind]
    return _INIT[kind](), (lambda s: bit_next(s, dtype))


def sample(state, next_fn, n: int):
    """Scan out n variates: returns ([n] array, final state)."""

    def body(s, _):
        u, s = next_fn(s)
        return s, u

    final, us = lax.scan(body, state, None, length=n)
    return us, final
