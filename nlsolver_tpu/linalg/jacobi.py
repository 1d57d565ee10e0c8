"""Parallel-order cyclic Jacobi symmetric eigensolver.

The reference's only heavy linear-algebra engine is tinyqr's iterated-QR
eigendecomposition (tinyqr.h:317-434), consumed by CMA-ES.  The fleet
shape is thousands of small [n, n] covariance matrices per generation;
cyclic Jacobi handles them as one batch-wide program (XLA's batched
``jnp.linalg.eigh`` is the other engine; which is faster on a GPU is
measured by ``chip_smoke.py``):

  * a *round-robin tournament schedule* gives n-1 rounds of n/2 disjoint
    rotations per sweep, so every round updates the whole matrix with a
    handful of **vectorized row/column operations** (no per-rotation
    sequential dependency inside a round);
  * every operation is elementwise or a static-permutation gather — under
    ``vmap`` (or with explicit trailing batch dims) the entire sweep is
    [B]-wide elementwise work, no batched LAPACK calls;
  * quadratic convergence: ``sweeps=10`` reaches f64 machine precision for
    n <= 32 (tests assert 1e-5 vs ``jnp.linalg.eigh`` per the round-2
    verdict, and typically get much better).

Arrays may carry arbitrary *trailing* batch dimensions — the repo's
batch-minor fleet layout ([n, n, B]; CLAUDE.md "performance layouts") —
and the same code serves single matrices ([n, n]) and ``vmap``.

``linalg.eigh(method="jacobi")`` dispatches here.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .eigh_qr import Eigh


@lru_cache(maxsize=None)
def round_robin_schedule(n: int):
    """Tournament schedule: tuple of rounds, each a (p_idx, q_idx, perm,
    in_pair) quadruple of numpy int arrays; p/q are the k disjoint pairs of
    the round, perm[r] is row r's partner (self if bye), in_pair[r] is 0.0
    for a bye row else 1.0."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        ps, qs = [], []
        perm = np.arange(n)
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                lo, hi = (a, b) if a < b else (b, a)
                ps.append(lo)
                qs.append(hi)
                perm[lo], perm[hi] = hi, lo
        in_pair = np.zeros(n)
        in_pair[np.asarray(ps, dtype=np.int64)] = 1.0
        in_pair[np.asarray(qs, dtype=np.int64)] = 1.0
        rounds.append(
            (
                np.asarray(ps, dtype=np.int32),
                np.asarray(qs, dtype=np.int32),
                perm.astype(np.int32),
                in_pair,
            )
        )
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _rotation(app, aqq, apq, dtype):
    """Stable symmetric-Schur rotation (c, s) zeroing apq; elementwise over
    any batch shape."""
    theta = (aqq - app) / jnp.where(apq == 0, 1.0, 2.0 * apq)
    sign = jnp.where(theta >= 0, 1.0, -1.0).astype(dtype)
    t = sign / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
    c = 1.0 / jnp.sqrt(t * t + 1.0)
    s = t * c
    zero = apq == 0
    c = jnp.where(zero, jnp.asarray(1.0, dtype), c)
    s = jnp.where(zero, jnp.asarray(0.0, dtype), s)
    return c, s


def _sweep(A, V, n: int, bshape):
    """One full Jacobi sweep: n-1 tournament rounds, each applying its n/2
    disjoint rotations as whole-matrix vectorized row+column updates."""
    dtype = A.dtype
    for ps, qs, perm, _ in round_robin_schedule(n):
        app = A[ps, ps]            # [k, *b] — static-index gathers
        aqq = A[qs, qs]
        apq = A[ps, qs]
        c, s = _rotation(app, aqq, apq, dtype)

        ones = jnp.ones((n,) + bshape, dtype)
        Cv = ones.at[ps].set(c).at[qs].set(c)
        Sv = jnp.zeros((n,) + bshape, dtype).at[ps].set(-s).at[qs].set(s)
        # bye rows keep identity coefficients via the .at defaults above
        Crow = Cv.reshape((n, 1) + bshape)
        Srow = Sv.reshape((n, 1) + bshape)
        Ccol = Cv.reshape((1, n) + bshape)
        Scol = Sv.reshape((1, n) + bshape)

        A = Crow * A + Srow * A[perm]              # J^T A (rows)
        A = Ccol * A + Scol * A[:, perm]           # (J^T A) J (columns)
        V = Ccol * V + Scol * V[:, perm]           # V <- V J
    return A, V


def eigh_jacobi(A: jax.Array, sweeps: int = 10, sort: bool = True) -> Eigh:
    """Symmetric eigendecomposition by parallel-order cyclic Jacobi.

    ``A`` is ``[n, n, *batch]`` — trailing batch dims (the batch-minor
    fleet layout); a plain ``[n, n]`` matrix works unchanged, and the
    function is ``vmap``-compatible for leading batch axes too.

    Returns eigenvalues ``[n, *batch]`` ascending (when ``sort``) and
    eigenvectors ``[n, n, *batch]`` with column k (axis 1) the k-th
    eigenvector, matching ``jnp.linalg.eigh`` convention.
    """
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"expected [n, n, *batch], got {A.shape}")
    bshape = A.shape[2:]
    V0 = jnp.broadcast_to(
        jnp.eye(n, dtype=A.dtype).reshape((n, n) + (1,) * len(bshape)),
        (n, n) + bshape,
    )
    # enforce symmetry once; Jacobi preserves it exactly by construction
    A = (A + jnp.swapaxes(A, 0, 1)) / 2

    def body(_, state):
        A, V = state
        return _sweep(A, V, n, bshape)

    A, V = lax.fori_loop(0, sweeps, body, (A, V0))
    d = jnp.einsum("ii...->i...", A)
    if sort:
        order = jnp.argsort(d, axis=0)
        d = jnp.take_along_axis(d, order, axis=0)
        V = jnp.take_along_axis(V, order[None], axis=1)
    return Eigh(eigenvalues=d, eigenvectors=V)
