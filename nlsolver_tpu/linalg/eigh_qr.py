"""Symmetric eigendecomposition by the iterated-QR algorithm.

Re-creation of tinyqr's ``qr_algorithm`` / ``QRSolver`` (tinyqr.h:317-434):
A_{k+1} = R_k Q_k with eigenvector accumulation, default 25 iterations and
the same tolerance-based early stop on the off-diagonal norm.  ``eigh``
dispatches to XLA's ``jnp.linalg.eigh`` by default (the production path for
CMA-ES); the QR-algorithm path exists for parity with the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.utils import HIGHEST
from .givens import qr_givens


class Eigh(NamedTuple):
    eigenvalues: jax.Array   # [n]
    eigenvectors: jax.Array  # [n, n], columns


def eigh_qr(A: jax.Array, max_iter: int = 25, tol: float = 1e-12) -> Eigh:
    """Iterated-QR eigendecomposition (tinyqr.h:317-367 semantics)."""
    n = A.shape[-1]

    def body(state):
        Ak, V, it = state
        q, r = qr_givens(Ak)
        mm = lambda a, b: jnp.matmul(a, b, precision=HIGHEST)
        return (mm(r, q), mm(V, q), it + 1)

    def cond(state):
        Ak, _, it = state
        off = jnp.sqrt(jnp.sum((Ak - jnp.diag(jnp.diagonal(Ak))) ** 2))
        return (it < max_iter) & (off > tol)

    Ak, V, _ = lax.while_loop(
        cond, body, (A, jnp.eye(n, dtype=A.dtype), jnp.int32(0))
    )
    return Eigh(eigenvalues=jnp.diagonal(Ak), eigenvectors=V)


def eigh(A: jax.Array, method: str = "xla", **kwargs) -> Eigh:
    """Symmetric eigendecomposition.

    * ``"xla"`` — ``jnp.linalg.eigh`` (best for one large matrix);
    * ``"jacobi"`` — parallel-order cyclic Jacobi (``linalg.jacobi``):
      the fleet engine for many small matrices, batch-minor or vmapped;
    * ``"qr"`` — tinyqr's iterated-QR semantics (parity path).
    """
    if method == "qr":
        return eigh_qr(A, **kwargs)
    if method == "jacobi":
        from .jacobi import eigh_jacobi

        return eigh_jacobi(A, **kwargs)
    if method != "xla":
        raise ValueError(
            f"unknown eigh method {method!r}; one of xla, jacobi, qr"
        )
    w, v = jnp.linalg.eigh(A)
    return Eigh(eigenvalues=w, eigenvectors=v)
