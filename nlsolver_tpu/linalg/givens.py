"""Givens-rotation QR decomposition.

Re-creation of tinyqr's core (reference: tinyqr.h:86-139 ``givens_rotation``/
``rotate_matrix``, :253-310 ``qr_impl``/``qr_decomposition``) as traceable
jnp code.  The rotation schedule is static (the (j, i) pairs are Python
ints at trace time), each rotation is a 2-row matrix op, and the whole
factorization vmaps over batches — the replacement for tinyqr's
AVX-specialized row rotations.

For performance-critical sizes ``jnp.linalg.qr`` (XLA's blocked
Householder) is the default; the Givens path exists for parity with the
reference algorithm.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.utils import HIGHEST


def givens_rotation(a, b):
    """Stable Givens coefficients (c, s) zeroing b against a
    (tinyqr.h:86-97)."""
    abs_a, abs_b = jnp.abs(a), jnp.abs(b)
    # guard both divisions; select the stable branch
    safe_a = jnp.where(abs_a == 0.0, 1.0, a)
    safe_b = jnp.where(abs_b == 0.0, 1.0, b)
    t_ba = jnp.where(abs_a >= abs_b, b / safe_a, 0.0)
    t_ab = jnp.where(abs_a >= abs_b, 0.0, a / safe_b)
    u_a = jnp.sign(a) * jnp.sqrt(1.0 + t_ba * t_ba)
    u_b = jnp.sign(b) * jnp.sqrt(1.0 + t_ab * t_ab)
    c = jnp.where(abs_a >= abs_b, 1.0 / u_a, t_ab / u_b)
    s = jnp.where(abs_a >= abs_b, t_ba / u_a, 1.0 / u_b)
    both_zero = (abs_a == 0.0) & (abs_b == 0.0)
    c = jnp.where(both_zero, 1.0, c)
    s = jnp.where(both_zero, 0.0, s)
    return c, s


class QR(NamedTuple):
    Q: jax.Array
    R: jax.Array


def qr_givens(A: jax.Array) -> QR:
    """QR of a square matrix by Givens rotations (static schedule)."""
    n = A.shape[-1]
    Q = jnp.eye(n, dtype=A.dtype)
    R = A
    for j in range(n):
        for i in range(j + 1, n):
            c, s = givens_rotation(R[j, j], R[i, j])
            rot_j = c * R[j] + s * R[i]
            rot_i = -s * R[j] + c * R[i]
            R = R.at[j].set(rot_j).at[i].set(rot_i)
            qj = c * Q[j] + s * Q[i]
            qi = -s * Q[j] + c * Q[i]
            Q = Q.at[j].set(qj).at[i].set(qi)
    return QR(Q=Q.T, R=R)


def qr(A: jax.Array, method: str = "householder") -> QR:
    """QR with selectable backend: XLA Householder (default), sequential
    Givens (the reference algorithm), or the batched parallel-order
    Sameh-Kuck wavefront (``method="parallel"``, for [m, n, *batch]
    fleets — linalg/qr_parallel.py)."""
    if method == "givens":
        return qr_givens(A)
    if method == "parallel":
        from .qr_parallel import qr_parallel

        return qr_parallel(A)
    if method != "householder":
        raise ValueError(
            f"unknown qr method {method!r}; one of householder, givens, "
            f"parallel"
        )
    q, r = jnp.linalg.qr(A)
    return QR(Q=q, R=r)


def validate_qr(qr_result: QR, A: jax.Array) -> jax.Array:
    """Max reconstruction error |QR - A| (tinyqr's validate_qr,
    tinyqr.h:218-252, returned instead of printed)."""
    return jnp.max(jnp.abs(
        jnp.matmul(qr_result.Q, qr_result.R, precision=HIGHEST) - A
    ))
