"""Batched BFGS rank-2 inverse-Hessian update.

The reference's O(n^2) scalar loop (``update_inverse_hessian``,
nlsolver.h:3130-3168, fed by ``hessian_update_inner_loop`` nlsolver.h:232)
becomes a fused batched elementwise update: for B problem instances at once

    H'_b = H_b - rho_b (s_b (y_b^T H_b) + (H_b y_b) s_b^T)
               + rho_b (1 + rho_b y_b^T H_b y_b) s_b s_b^T

Two layouts: ``rank2_update_batched`` takes the standard ``[B, n, n]``
stack; ``rank2_direction_batchminor`` keeps the fleet on the trailing axis
(``[n, n, B]``, the BFGS fleet's layout) and also returns the next search
direction.  Every contraction is written as a multiply and a reduction, so
no matrix product (and no TF32 rounding) is involved.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.utils import HIGHEST


def rank2_update_reference(H, s, y, rho):
    """Single-instance update (solvers.bfgs.rank2_update formulation)."""
    Hy = jnp.matmul(H, y, precision=HIGHEST)
    yHy = jnp.dot(y, Hy, precision=HIGHEST)
    coef = rho * (1.0 + rho * yHy)
    sym = jnp.outer(s, Hy) + jnp.outer(Hy, s)
    return H - rho * sym + coef * jnp.outer(s, s)


def rank2_update_batched(H, s, y, rho):
    """Fused batched formulation: [B, n, n], [B, n], [B, n], [B]."""
    Hy = jnp.sum(H * y[:, None, :], axis=2)
    yHy = jnp.sum(y * Hy, axis=1)
    coef = rho * (1.0 + rho * yHy)
    sym = s[:, :, None] * Hy[:, None, :] + Hy[:, :, None] * s[:, None, :]
    ss = s[:, :, None] * s[:, None, :]
    return H - rho[:, None, None] * sym + coef[:, None, None] * ss


def rank2_direction_batchminor(H, s, y, g, rho, reset):
    """Batch-minor update fused with the next direction: (H', d' = -H' g).

    H [n,n,B]; s, y, g [n,B]; rho, reset [B] (reset: bool — use the
    identity in place of H before updating, the reference's self-healing
    H=I, nlsolver.h:3253-3260).  Reading H once for both the update and
    the direction keeps the O(n^2 B) tensor to one pass per iteration.
    """
    n = H.shape[0]
    eye = jnp.eye(n, dtype=H.dtype)[:, :, None]
    Heff = jnp.where(reset[None, None, :], eye, H)
    Hy = jnp.sum(Heff * y[None, :, :], axis=1)             # [n,B]
    yHy = jnp.sum(y * Hy, axis=0)                          # [B]
    coef = rho * (1.0 + rho * yHy)
    sym = s[:, None, :] * Hy[None, :, :] + Hy[:, None, :] * s[None, :, :]
    Hn = Heff - rho[None, None, :] * sym + coef[None, None, :] * (
        s[:, None, :] * s[None, :, :]
    )
    d = -jnp.sum(Hn * g[None, :, :], axis=1)               # [n,B]
    return Hn, d
