"""Batched small-matrix Cholesky solve, batch-minor layout.

The LM / NLLS fleet solves thousands of tiny (n <= ~32) SPD systems per
step.  ``solve_spd_batchminor`` puts the BATCH on the trailing axis and
unrolls the tiny Cholesky-Banachiewicz factorization and both triangular
solves over n, so every operation is one [B]-wide elementwise op that XLA
fuses.  ``solve_spd_batched`` is the standard-layout ([B, n, n] / [B, n])
alternative through XLA's batched ``cho_solve``.

(Replaces the reference's per-instance cholesky/forwardsolve/backsolve,
nlsolver.h:252-294.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _chol_solve_batchminor(A, b):
    """A: [n, n, B] SPD, b: [n, B] -> x: [n, B]; fully unrolled over n."""
    n = A.shape[0]
    # Cholesky-Banachiewicz, batch on the trailing axis
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = A[i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(acc)
            else:
                L[i][j] = acc / L[j][j]
    # forward solve L z = b
    z = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * z[k]
        z[i] = acc / L[i][i]
    # back solve L^T x = z
    x = [None] * n
    for i in reversed(range(n)):
        acc = z[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return jnp.stack(x, axis=0)


@jax.jit
def solve_spd_batchminor(A_bm, b_bm):
    """Layout-native entry: A [n, n, B], b [n, B] -> x [n, B].

    Keep solver state batch-minor end-to-end to use this.  Mixing layouts
    (transpose-in / transpose-out around the unrolled graph) provokes XLA
    into strided-gather layouts — hence no [B, n, n] wrapper over this path.
    """
    return _chol_solve_batchminor(A_bm, b_bm)


@jax.jit
def solve_spd_batched(A, b):
    """Solve B small SPD systems: A [B, n, n], b [B, n] -> [B, n].

    Standard-layout path via vmapped Cholesky."""
    import jax.scipy.linalg as jsl

    def one(Ai, bi):
        c, low = jsl.cho_factor(Ai)
        return jsl.cho_solve((c, low), bi)

    return jax.vmap(one)(A, b)
