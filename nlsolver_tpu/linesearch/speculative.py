"""Speculative (grid) line search for lane fleets.

The More-Thuente search (``linesearch/more_thuente.py``, the reference's
cvsrch, nlsolver.h:1673-1793) is a SEQUENTIAL recurrence: up to maxfev=20
dependent trials, each one full objective+gradient evaluation whose input
depends on the previous trial's output.  On a latency-bound fleet (small
B, cheap objective) that dependency chain is the floor: the device idles
between tiny dependent kernels.

The latency-bound redesign: evaluate a STATIC geometric grid of K trial steps
for every lane in ONE batched objective/gradient call — [n, K*B] points,
K times the lane-parallel work, depth 1 instead of depth <=20 — then
select per lane:

  1. the best (lowest-f) trial satisfying strong Wolfe
     (ftol/gtol constants identical to cvsrch, nlsolver.h:1682-1688);
  2. else the best trial satisfying the Armijo decrease alone;
  3. else the best strictly-improving trial;
  4. else alpha = 0 (no acceptable step: the caller's reset machinery
     treats the zero step exactly like a failed line search — BFGS's
     curvature guard fires and the next direction is -g).

This trades evaluation COUNT (always K per iteration) for DEPTH (one
parallel evaluation), the right trade whenever lanes * K still leaves
the device underused - i.e. exactly the latency-bound regime.  More
iterations may be needed than with the adaptive search (the grid is not refined), which is
why it is a config option, not the default; convergence parity is tested
in tests/test_linesearch.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .more_thuente import FTOL, GTOL, MTResult

#: default trial-step multipliers: three decades down, one octave ladder up
DEFAULT_GRID = (0.001, 0.01, 0.1, 0.3, 0.5, 1.0, 2.0, 4.0)


def speculative_fleet(
    fn_cols, grad_cols, X, f0, G0, D, alpha0, grid=DEFAULT_GRID
) -> MTResult:
    """Grid line search on a batch-minor fleet (drop-in for
    :func:`more_thuente_fleet`).

    fn_cols ``[n, B] -> [B]``; grad_cols ``[n, B] -> [n, B]``;
    X ``[n, B]``; f0 ``[B]``; G0/D ``[n, B]``; alpha0 scalar or ``[B]``;
    ``grid`` a static tuple of K multipliers of alpha0.

    Returns an :class:`MTResult` whose ``nfev`` counts K trials (each one
    f and one gradient evaluation, like the MT accounting) and whose
    ``info`` reports the acceptance tier: 1 strong Wolfe, 2 Armijo-only,
    3 improvement-only, 6 no acceptable step (alpha = 0), -1 non-descent
    direction (reference bail-out semantics, nlsolver.h:1693-1695).
    """
    n, B = X.shape
    K = len(grid)
    dtype = X.dtype
    alpha0 = jnp.broadcast_to(jnp.asarray(alpha0, dtype), (B,))
    g = jnp.asarray(grid, dtype)
    alphas = g[:, None] * alpha0[None, :]                    # [K, B]

    Xt = X[:, None, :] + alphas[None, :, :] * D[:, None, :]  # [n, K, B]
    # vmap over the K axis (NOT a [n, K*B] reshape): every inner call sees
    # a lane-aligned [n, B] fleet, so objectives that close over per-lane
    # data (centers, observations, ...) keep their lane correspondence
    fv = jax.vmap(fn_cols, in_axes=1, out_axes=0)(Xt)        # [K, B]
    Gv = jax.vmap(grad_cols, in_axes=1, out_axes=1)(Xt)      # [n, K, B]
    dg = jnp.sum(Gv * D[:, None, :], axis=0)                 # [K, B]

    dginit = jnp.sum(G0 * D, axis=0)                         # [B]
    armijo = fv <= f0[None, :] + FTOL * alphas * dginit[None, :]
    curv = jnp.abs(dg) <= GTOL * (-dginit)[None, :]
    wolfe = armijo & curv
    improve = fv < f0[None, :]

    big = jnp.asarray(jnp.inf, dtype)

    def best_of(mask):
        """(index, any) of the lowest f among mask-satisfying trials."""
        masked = jnp.where(mask, fv, big)
        return jnp.argmin(masked, axis=0), jnp.any(mask, axis=0)

    i_w, has_w = best_of(wolfe)
    i_a, has_a = best_of(armijo)
    i_i, has_i = best_of(improve)

    idx = jnp.where(has_w, i_w, jnp.where(has_a, i_a, i_i))  # [B]
    alpha_pick = jnp.take_along_axis(alphas, idx[None, :], axis=0)[0]
    any_ok = has_w | has_a | has_i
    alpha = jnp.where(any_ok, alpha_pick, jnp.zeros_like(alpha_pick))

    info = jnp.where(
        has_w, 1, jnp.where(has_a, 2, jnp.where(has_i, 3, 6))
    ).astype(jnp.int32)
    bad = dginit >= 0.0
    return MTResult(
        alpha=jnp.where(bad, alpha0, alpha),
        nfev=jnp.where(bad, 0, K).astype(jnp.int32) * jnp.ones((B,), jnp.int32),
        info=jnp.where(bad, -1, info),
    )
