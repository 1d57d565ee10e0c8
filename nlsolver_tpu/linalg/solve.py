"""Triangular / Cholesky / least-squares solves.

Re-creation of the reference's dense-solve helpers:
  * ``cholesky`` + ``forwardsolve``/``backsolve`` (nlsolver.h:252-294);
  * ``get_update_with_hessian`` — LM's damped-normal-equation solve with a
    diagonal fast path (nlsolver.h:310-330); one Cholesky solve covers
    both branches;
  * tinyqr's ``back_solve`` / ``lm`` least-squares (tinyqr.h:437-470).

All functions are pure jnp on single matrices; batch with ``vmap`` (used by
the batched-LM / NLLS paths), or use the batch-minor solves in
``nlsolver_tpu.ops`` for small-matrix fleets.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..core.utils import HIGHEST


def cholesky(A: jax.Array) -> jax.Array:
    """Lower-triangular Cholesky factor (nlsolver.h:252-270)."""
    return jnp.linalg.cholesky(A)


def forwardsolve(L: jax.Array, b: jax.Array) -> jax.Array:
    return jsl.solve_triangular(L, b, lower=True)


def backsolve(U: jax.Array, b: jax.Array) -> jax.Array:
    return jsl.solve_triangular(U, b, lower=False)


def solve_cholesky(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve SPD A x = b via Cholesky (the reference's LM solve path,
    nlsolver.h:326-329)."""
    c, low = jsl.cho_factor(A)
    return jsl.cho_solve((c, low), b)


# Below this order, an unrolled scalar Cholesky beats LAPACK-shaped
# cho_solve by a wide margin once vmapped: the unrolled graph is pure
# elementwise ops over the batch (on a GPU not measured; see
# ops/smallchol.py for the same idea in batch-minor layout).
_UNROLL_N = 8


def _solve_spd_unrolled(A: jax.Array, b: jax.Array) -> jax.Array:
    """Single small SPD solve, fully unrolled over the static order n.

    Scalar indexing only, so under ``vmap`` every operation becomes a
    [B]-shaped elementwise op — no batched-LAPACK path, no transposes."""
    n = b.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def is_diagonal(H: jax.Array) -> jax.Array:
    """Runtime diagonality test (nlsolver.h:296-307): every off-diagonal
    entry below ``eps * 1e12`` (~2.2e-4 for f64).

    The reference compares the *signed* entry (``A[i,j] > eps*1e12`` — a
    matrix whose off-diagonals are all negative passes as "diagonal" and
    gets the elementwise-divide update).  That is a bug; we test ``|A[i,j]|``
    by default.  The threshold is the reference's *double*-precision
    constant for every dtype — scaling by the input dtype's eps would make
    the f32 threshold ~1.2e5 and classify everything as diagonal.
    """
    n = H.shape[-1]
    thresh = jnp.asarray(2.220446049250313e-16 * 1e12, H.dtype)
    off = jnp.abs(H) * (1.0 - jnp.eye(n, dtype=H.dtype))
    return jnp.max(off) <= thresh


def damped_solve(H: jax.Array, g: jax.Array, lam, *, diagonal=None) -> jax.Array:
    """(H + lam I) u = g (get_update_with_hessian + H += lam I,
    nlsolver.h:3529-3533).

    ``diagonal`` selects the reference's fast path (nlsolver.h:316-322):

    * ``True`` — H is known diagonal (separable objective): elementwise
      divide, O(n) instead of O(n^3).  Static, so fleets of vmapped LM
      solves on separable Hessians never touch the Cholesky graph.
    * ``False`` — always factorize.
    * ``None`` (default) — runtime ``is_diagonal`` check via ``lax.cond``,
      mirroring the reference's dynamic dispatch.  Under ``jit`` (no vmap)
      only the taken branch executes; under ``vmap`` both run, so pass a
      static flag for batched fleets.

    Small orders use the unrolled vmap-friendly solve (see _UNROLL_N note).
    """
    n = g.shape[-1]
    Hd = H + lam * jnp.eye(n, dtype=H.dtype)
    if diagonal is True:
        return g / jnp.diagonal(Hd, axis1=-2, axis2=-1)
    dense_solve = _solve_spd_unrolled if n <= _UNROLL_N else solve_cholesky
    if diagonal is False:
        return dense_solve(Hd, g)
    return jax.lax.cond(
        is_diagonal(Hd),
        lambda: g / jnp.diagonal(Hd, axis1=-2, axis2=-1),
        lambda: dense_solve(Hd, g),
    )


def least_squares(A: jax.Array, y: jax.Array) -> jax.Array:
    """Minimize ||A x - y||_2 via QR (tinyqr's ``lm``, tinyqr.h:460-470)."""
    q, r = jnp.linalg.qr(A)
    return jsl.solve_triangular(
        r, jnp.matmul(q.T, y, precision=HIGHEST), lower=False
    )
