"""Batched parallel-order Givens QR (Sameh-Kuck schedule).

tinyqr's ``qr_impl`` (tinyqr.h:253-283) annihilates subdiagonal entries one
sequential rotation at a time.  The fleet shape is thousands of
small [m, n] matrices (LM normal equations, CMA-ES whitening, NLLS
Jacobians); the Sameh-Kuck wavefront makes the factorization
hardware-friendly the same way ``linalg.jacobi`` does for eigh:

  * entry (i, j) (0-based, i > j) is annihilated at stage
    ``k = m - 1 - i + 2 j`` by a rotation of rows (i-1, i); within a stage
    all row pairs are DISJOINT, so each stage is a handful of vectorized
    whole-row operations — [B]-wide elementwise work under the batch-minor
    layout;
  * m + 2n - 3 stages total instead of n(2m - n - 1)/2 sequential
    rotations; the schedule is static Python/numpy at trace time;
  * arrays carry arbitrary trailing batch dims ([m, n, *batch] — the
    repo's batch-minor fleet layout, CLAUDE.md "performance layouts");
    plain [m, n] matrices and leading-axis ``vmap`` work unchanged.

``least_squares_parallel`` threads the right-hand side through the same
rotations (computing Q^T y implicitly — tinyqr's ``lm``/``back_solve``
pipeline, tinyqr.h:437-470) and back-substitutes on the trailing-batch
layout.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .givens import QR, givens_rotation


@lru_cache(maxsize=None)
def sameh_kuck_schedule(m: int, n: int):
    """Static wavefront schedule: tuple of stages, each (ps, qs, js, perm)
    int arrays — rotate rows (p, q) = (i-1, i) to zero entry (q, js) — with
    all pairs in a stage row-disjoint."""
    stages = {}
    for j in range(n):
        for i in range(m - 1, j, -1):
            k = (m - 1 - i) + 2 * j
            stages.setdefault(k, []).append((i - 1, i, j))
    out = []
    for k in sorted(stages):
        ps = np.asarray([t[0] for t in stages[k]], np.int32)
        qs = np.asarray([t[1] for t in stages[k]], np.int32)
        js = np.asarray([t[2] for t in stages[k]], np.int32)
        perm = np.arange(m, dtype=np.int32)
        perm[ps], perm[qs] = qs, ps
        out.append((ps, qs, js, perm))
    return tuple(out)


def _apply_stages(m: int, n: int, R, carried, dtype, bshape):
    """Run the full schedule on R, applying the identical row rotations to
    every array in ``carried`` (Q^T accumulator, right-hand sides, ...)."""
    for ps, qs, js, perm in sameh_kuck_schedule(m, n):
        a = R[ps, js]                       # [k, *batch] static gathers
        b = R[qs, js]
        c, s = givens_rotation(a, b)
        ones = jnp.ones((m,) + bshape, dtype)
        Cv = ones.at[ps].set(c).at[qs].set(c)
        Sv = jnp.zeros((m,) + bshape, dtype).at[ps].set(s).at[qs].set(-s)
        Crow = Cv.reshape((m, 1) + bshape)
        Srow = Sv.reshape((m, 1) + bshape)
        R = Crow * R + Srow * R[perm]
        # matrices ([m, k, *batch]) broadcast via the row shape; vectors
        # ([m, *batch], e.g. right-hand sides) use the coefficients directly
        carried = [
            (Crow * X + Srow * X[perm]) if X.ndim == R.ndim
            else (Cv * X + Sv * X[perm])
            for X in carried
        ]
    return R, carried


def qr_parallel(A: jax.Array, compute_q: bool = True) -> QR:
    """QR of ``A`` = [m, n, *batch] (m >= n) by parallel-order Givens.

    Returns ``Q`` [m, m, *batch] (or ``None`` when ``compute_q=False``)
    and ``R`` [m, n, *batch] upper-triangular, matching
    ``jnp.linalg.qr(mode="complete")`` up to column signs.
    """
    m, n = A.shape[0], A.shape[1]
    if m < n:
        raise ValueError(f"need m >= n, got {A.shape}")
    bshape = A.shape[2:]
    dtype = A.dtype
    carried = []
    if compute_q:
        Qt = jnp.broadcast_to(
            jnp.eye(m, dtype=dtype).reshape((m, m) + (1,) * len(bshape)),
            (m, m) + bshape,
        )
        carried.append(Qt)
    R, carried = _apply_stages(m, n, A, carried, dtype, bshape)
    Q = jnp.swapaxes(carried[0], 0, 1) if compute_q else None
    return QR(Q=Q, R=R)


def backsolve_bm(R: jax.Array, b: jax.Array) -> jax.Array:
    """Solve R x = b for upper-triangular R [n, n, *batch], b [n, *batch]
    by unrolled back-substitution on the trailing-batch layout."""
    n = R.shape[0]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = b[i]
        for j in range(i + 1, n):
            acc = acc - R[i, j] * xs[j]
        xs[i] = acc / R[i, i]
    return jnp.stack(xs, axis=0)


def least_squares_parallel(A: jax.Array, y: jax.Array) -> jax.Array:
    """min_x ||A x - y||_2 for A [m, n, *batch], y [m, *batch]: the
    rotations are applied to y directly (implicit Q^T y — no Q
    materialized), then R[:n, :n] x = (Q^T y)[:n] back-substitutes."""
    m, n = A.shape[0], A.shape[1]
    bshape = A.shape[2:]
    R, (qty,) = _apply_stages(m, n, A, [y], A.dtype, bshape)
    return backsolve_bm(R[:n, :n], qty[:n])
