"""More-Thuente strong-Wolfe line search.

Re-creation of the reference's MINPACK-style ``cvsrch``/``cstep``
(nlsolver.h:1527-1793) as a bounded ``lax.while_loop`` over pure scalar
state, with the same constants (xtol=1e-15, ftol=1e-4, gtol=1e-2,
stpmin=1e-15, stpmax=1e15, xtrapf=4, maxfev=20; nlsolver.h:1682-1688).

The reference mutates nine scalars by reference through a 4-way branch
tree; here ``cstep`` computes all four trial steps and selects by case —
branchless data flow that vmaps cleanly over batches of line searches.
Each trial evaluates both f and the gradient (nlsolver.h:1740-1741), so
callers receive an ``nfev`` that counts one of each per trial.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.utils import HIGHEST

XTOL = 1e-15
FTOL = 1e-4
GTOL = 1e-2
STPMIN = 1e-15
STPMAX = 1e15
XTRAPF = 4.0
MAXFEV = 20


def _max_abs3(x, y, z):
    return jnp.maximum(jnp.abs(x), jnp.maximum(jnp.abs(y), jnp.abs(z)))


def cstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax):
    """One MINPACK cstep trial-step update (nlsolver.h:1528-1671).

    Returns (stx, fx, dx, sty, fy, dy, stp, brackt, ok).
    """
    err = (
        (brackt & ((stp <= jnp.minimum(stx, sty)) | (stp >= jnp.maximum(stx, sty))))
        | (dx * (stp - stx) >= 0.0)
        | (stpmax < stpmin)
    )

    sgnd = dp * jnp.sign(dx)

    case1 = fp > fx
    case2 = (~case1) & (sgnd < 0.0)
    case3 = (~case1) & (~case2) & (jnp.abs(dp) < jnp.abs(dx))
    # case4 = otherwise

    d_stp_stx = jnp.where(stp == stx, 1.0, stp - stx)  # guard inactive divides

    theta = 3.0 * (fx - fp) / d_stp_stx + dx + dp
    s = _max_abs3(theta, dx, dp)
    s = jnp.where(s == 0.0, 1.0, s)
    gamma_base = s * jnp.sqrt(
        jnp.maximum((theta / s) ** 2 - (dx / s) * (dp / s), 0.0)
    )

    # --- case 1: higher function value (bracketing, bound) ---
    g1 = jnp.where(stp < stx, -gamma_base, gamma_base)
    p1 = (g1 - dx) + theta
    q1 = ((g1 - dx) + g1) + dp
    q1 = jnp.where(q1 == 0.0, 1.0, q1)
    stpc1 = stx + (p1 / q1) * (stp - stx)
    den1 = (fx - fp) / d_stp_stx + dx
    den1 = jnp.where(den1 == 0.0, 1.0, den1)
    stpq1 = stx + ((dx / den1) / 2.0) * (stp - stx)
    stpf1 = jnp.where(
        jnp.abs(stpc1 - stx) < jnp.abs(stpq1 - stx),
        stpc1,
        stpc1 + (stpq1 - stpc1) / 2.0,
    )

    # --- case 2: lower value, derivative sign change (bracketing) ---
    g2 = jnp.where(stp > stx, -gamma_base, gamma_base)
    p2 = (g2 - dp) + theta
    q2 = ((g2 - dp) + g2) + dx
    q2 = jnp.where(q2 == 0.0, 1.0, q2)
    stpc2 = stp + (p2 / q2) * (stx - stp)
    dpdx = jnp.where(dp == dx, 1.0, dp - dx)
    stpq2 = stp + (dp / dpdx) * (stx - stp)
    stpf2 = jnp.where(
        jnp.abs(stpc2 - stp) > jnp.abs(stpq2 - stp), stpc2, stpq2
    )

    # --- case 3: derivative decreases in magnitude (bound) ---
    g3 = jnp.where(stp > stx, -gamma_base, gamma_base)
    p3 = (g3 - dp) + theta
    q3 = (g3 + (dx - dp)) + g3
    q3 = jnp.where(q3 == 0.0, 1.0, q3)
    r3 = p3 / q3
    stpc3 = jnp.where(
        (r3 < 0.0) & (g3 != 0.0),
        stp + r3 * (stx - stp),
        jnp.where(stp > stx, stpmax, stpmin),
    )
    stpq3 = stp + (dp / dpdx) * (stx - stp)
    stpf3 = jnp.where(
        brackt,
        jnp.where(jnp.abs(stp - stpc3) < jnp.abs(stp - stpq3), stpc3, stpq3),
        jnp.where(jnp.abs(stp - stpc3) > jnp.abs(stp - stpq3), stpc3, stpq3),
    )

    # --- case 4: derivative does not decrease ---
    d_sty_stp = jnp.where(sty == stp, 1.0, sty - stp)
    theta4 = 3.0 * (fp - fy) / d_sty_stp + dy + dp
    s4 = _max_abs3(theta4, dy, dp)
    s4 = jnp.where(s4 == 0.0, 1.0, s4)
    g4 = s4 * jnp.sqrt(
        jnp.maximum((theta4 / s4) ** 2 - (dy / s4) * (dp / s4), 0.0)
    )
    g4 = jnp.where(stp > sty, -g4, g4)
    p4 = (g4 - dp) + theta4
    q4 = ((g4 - dp) + g4) + dy
    q4 = jnp.where(q4 == 0.0, 1.0, q4)
    stpc4 = stp + (p4 / q4) * (sty - stp)
    stpf4 = jnp.where(
        brackt, stpc4, jnp.where(stp > stx, stpmax, stpmin)
    )

    stpf = jnp.where(
        case1, stpf1, jnp.where(case2, stpf2, jnp.where(case3, stpf3, stpf4))
    )
    bound = case1 | case3
    new_brackt = brackt | case1 | case2

    # interval endpoint update (nlsolver.h:1642-1656)
    take_y_from_p = fp > fx
    swap_x_to_y = (~take_y_from_p) & (sgnd < 0.0)
    n_sty = jnp.where(take_y_from_p, stp, jnp.where(swap_x_to_y, stx, sty))
    n_fy = jnp.where(take_y_from_p, fp, jnp.where(swap_x_to_y, fx, fy))
    n_dy = jnp.where(take_y_from_p, dp, jnp.where(swap_x_to_y, dx, dy))
    n_stx = jnp.where(take_y_from_p, stx, stp)
    n_fx = jnp.where(take_y_from_p, fx, fp)
    n_dx = jnp.where(take_y_from_p, dx, dp)

    stpf = jnp.clip(stpf, stpmin, stpmax)
    n_stp = stpf
    # safeguard toward the bracket interior (nlsolver.h:1661-1669)
    guard = new_brackt & bound
    interior = n_stx + 0.66 * (n_sty - n_stx)
    n_stp = jnp.where(
        guard,
        jnp.where(
            n_sty > n_stx, jnp.minimum(interior, n_stp), jnp.maximum(interior, n_stp)
        ),
        n_stp,
    )

    # on input error the reference leaves everything untouched (returns -1)
    def keep(old, new):
        return jnp.where(err, old, new)

    return (
        keep(stx, n_stx),
        keep(fx, n_fx),
        keep(dx, n_dx),
        keep(sty, n_sty),
        keep(fy, n_fy),
        keep(dy, n_dy),
        keep(stp, n_stp),
        keep(brackt, new_brackt),
        ~err,
    )


class MTResult(NamedTuple):
    alpha: jax.Array
    nfev: jax.Array   # trials; each trial costs 1 f-eval and 1 grad-eval
    info: jax.Array   # MINPACK info code (1 = strong Wolfe satisfied)


def more_thuente(fn, grad_fn, x, f0, g0, direction, alpha0, alpha_max=STPMAX) -> MTResult:
    """Strong-Wolfe search along ``direction`` from ``x``.

    fn/grad_fn: objective and gradient callables on [n] points.
    f0/g0: objective value and gradient at x.
    alpha_max: optional (traceable) upper bound on the step — used by the
    box-constrained solvers to truncate the search at the feasible boundary
    (the MINPACK ``stpmax`` argument the reference hard-codes to 1e15,
    nlsolver.h:1686).
    Returns the accepted step alpha (the reference's cvsrch result semantics:
    initial alpha when the initial slope is non-negative).
    """
    dtype = x.dtype
    stpmax = jnp.asarray(alpha_max, dtype)
    alpha0 = jnp.minimum(jnp.asarray(alpha0, dtype), stpmax)
    dginit = jnp.dot(g0, direction, precision=HIGHEST)

    dgtest = FTOL * dginit
    finit = f0

    class S(NamedTuple):
        stp: jax.Array
        stx: jax.Array
        fx: jax.Array
        dgx: jax.Array
        sty: jax.Array
        fy: jax.Array
        dgy: jax.Array
        brackt: jax.Array
        stage1: jax.Array
        nfev: jax.Array
        width: jax.Array
        width1: jax.Array
        ok: jax.Array
        info: jax.Array

    w = stpmax - STPMIN
    init = S(
        stp=alpha0,
        stx=jnp.asarray(0.0, dtype),
        fx=finit,
        dgx=dginit,
        sty=jnp.asarray(0.0, dtype),
        fy=finit,
        dgy=dginit,
        brackt=jnp.asarray(False),
        stage1=jnp.asarray(True),
        nfev=jnp.int32(0),
        width=jnp.asarray(w, dtype),
        width1=jnp.asarray(2 * w, dtype),
        ok=jnp.asarray(True),
        info=jnp.int32(0),
    )

    def cond(s: S):
        return s.info == 0

    def body(s: S) -> S:
        stmin = jnp.where(s.brackt, jnp.minimum(s.stx, s.sty), s.stx)
        stmax = jnp.where(
            s.brackt, jnp.maximum(s.stx, s.sty), s.stp + XTRAPF * (s.stp - s.stx)
        )
        stp = jnp.clip(s.stp, STPMIN, stpmax)
        fallback = (
            (s.brackt & ((stp <= stmin) | (stp >= stmax)))
            | (s.nfev >= MAXFEV - 1)
            | (~s.ok)
            | (s.brackt & ((stmax - stmin) <= XTOL * stmax))
        )
        stp = jnp.where(fallback, s.stx, stp)

        xt = x + stp * direction
        fv = fn(xt)
        gv = grad_fn(xt)
        nfev = s.nfev + 1
        dg = jnp.dot(gv, direction, precision=HIGHEST)
        ftest1 = finit + stp * dgtest

        info = jnp.int32(0)
        info = jnp.where(
            (s.brackt & ((stp <= stmin) | (stp >= stmax))) | (~s.ok), 6, info
        )
        info = jnp.where((stp == stpmax) & (fv <= ftest1) & (dg <= dgtest), 5, info)
        info = jnp.where((stp == STPMIN) & ((fv > ftest1) | (dg >= dgtest)), 4, info)
        info = jnp.where(nfev >= MAXFEV, 3, info)
        info = jnp.where(s.brackt & ((stmax - stmin) <= XTOL * stmax), 2, info)
        info = jnp.where(
            (fv <= ftest1) & (jnp.abs(dg) <= GTOL * (-dginit)), 1, info
        )

        stage1 = s.stage1 & ~(
            (fv <= ftest1) & (dg >= jnp.minimum(FTOL, GTOL) * dginit)
        )
        use_mod = stage1 & (fv <= s.fx) & (fv > ftest1)

        # modified function values (nlsolver.h:1763-1777)
        sel = lambda m, a, b: jnp.where(m, a, b)
        fm = sel(use_mod, fv - stp * dgtest, fv)
        fxm = sel(use_mod, s.fx - s.stx * dgtest, s.fx)
        fym = sel(use_mod, s.fy - s.sty * dgtest, s.fy)
        dgm = sel(use_mod, dg - dgtest, dg)
        dgxm = sel(use_mod, s.dgx - dgtest, s.dgx)
        dgym = sel(use_mod, s.dgy - dgtest, s.dgy)

        stx2, fx2, dgx2, sty2, fy2, dgy2, stp2, brackt2, ok2 = cstep(
            s.stx, fxm, dgxm, s.sty, fym, dgym, stp, fm, dgm, s.brackt, stmin, stmax
        )

        fx3 = sel(use_mod, fx2 + stx2 * dgtest, fx2)
        fy3 = sel(use_mod, fy2 + sty2 * dgtest, fy2)
        dgx3 = sel(use_mod, dgx2 + dgtest, dgx2)
        dgy3 = sel(use_mod, dgy2 + dgtest, dgy2)

        # forced bisection when the bracket shrinks too slowly (:1784-1790)
        slow = brackt2 & (jnp.abs(sty2 - stx2) >= 0.66 * s.width1)
        stp3 = jnp.where(slow, stx2 + 0.5 * (sty2 - stx2), stp2)
        width1 = jnp.where(brackt2, s.width, s.width1)
        width = jnp.where(brackt2, jnp.abs(sty2 - stx2), s.width)

        # when terminating, the caller's step is the stp we just evaluated at
        done = info != 0
        return S(
            stp=jnp.where(done, stp, stp3),
            stx=stx2,
            fx=fx3,
            dgx=dgx3,
            sty=sty2,
            fy=fy3,
            dgy=dgy3,
            brackt=brackt2,
            stage1=stage1,
            nfev=nfev,
            width=width,
            width1=width1,
            ok=ok2,
            info=info,
        )

    final = lax.while_loop(cond, body, init)
    # non-descent direction: reference bails before any trial (:1693-1695)
    bad = dginit >= 0.0
    return MTResult(
        alpha=jnp.where(bad, alpha0, final.stp),
        nfev=jnp.where(bad, 0, final.nfev),
        info=jnp.where(bad, -1, final.info),
    )


class _FS(NamedTuple):
    stp: jax.Array
    stx: jax.Array
    fx: jax.Array
    dgx: jax.Array
    sty: jax.Array
    fy: jax.Array
    dgy: jax.Array
    brackt: jax.Array
    stage1: jax.Array
    nfev: jax.Array
    width: jax.Array
    width1: jax.Array
    ok: jax.Array
    info: jax.Array


def more_thuente_fleet(fn_cols, grad_cols, X, f0, G0, D, alpha0) -> MTResult:
    """Batch-minor fleet variant of :func:`more_thuente`.

    One line search per LANE: the fleet state lives on the trailing axis so
    every scalar of the MINPACK recurrence is a ``[B]`` vector and every
    point is a column of ``X`` — the layout that keeps the whole BFGS fleet
    on the trailing axis (see solvers/bfgs_fleet.py).

    fn_cols:  ``[n, B] -> [B]`` objective on columns.
    grad_cols: ``[n, B] -> [n, B]`` gradients of each column.
    X ``[n, B]``, f0 ``[B]``, G0/D ``[n, B]``; alpha0 scalar or ``[B]``.

    Same constants and same ``cstep`` select tree as the single-instance
    version (nlsolver.h:1527-1793) — ``cstep`` is pure elementwise data flow
    so it vectorizes over lanes unchanged.  Finished lanes are frozen in the
    shared ``while_loop``; the loop runs until every lane has an info code.
    """
    dtype = X.dtype
    B = X.shape[-1]
    alpha0 = jnp.broadcast_to(jnp.asarray(alpha0, dtype), (B,))
    dginit = jnp.sum(G0 * D, axis=0)            # [B]
    dgtest = FTOL * dginit
    finit = f0

    w = jnp.asarray(STPMAX - STPMIN, dtype)
    zero = jnp.zeros((B,), dtype)
    init = _FS(
        stp=alpha0,
        stx=zero,
        fx=finit,
        dgx=dginit,
        sty=zero,
        fy=finit,
        dgy=dginit,
        brackt=jnp.zeros((B,), bool),
        stage1=jnp.ones((B,), bool),
        nfev=jnp.zeros((B,), jnp.int32),
        width=jnp.full((B,), w, dtype),
        width1=jnp.full((B,), 2 * w, dtype),
        ok=jnp.ones((B,), bool),
        info=jnp.zeros((B,), jnp.int32),
    )

    def cond(s: _FS):
        return jnp.any(s.info == 0)

    def body(s: _FS) -> _FS:
        active = s.info == 0                    # [B]
        stmin = jnp.where(s.brackt, jnp.minimum(s.stx, s.sty), s.stx)
        stmax = jnp.where(
            s.brackt, jnp.maximum(s.stx, s.sty), s.stp + XTRAPF * (s.stp - s.stx)
        )
        stp = jnp.clip(s.stp, STPMIN, STPMAX)
        fallback = (
            (s.brackt & ((stp <= stmin) | (stp >= stmax)))
            | (s.nfev >= MAXFEV - 1)
            | (~s.ok)
            | (s.brackt & ((stmax - stmin) <= XTOL * stmax))
        )
        stp = jnp.where(fallback, s.stx, stp)

        Xt = X + stp * D                        # [n,B] (stp broadcasts on lanes)
        fv = fn_cols(Xt)                        # [B]
        Gv = grad_cols(Xt)                      # [n,B]
        nfev = s.nfev + active.astype(jnp.int32)
        dg = jnp.sum(Gv * D, axis=0)
        ftest1 = finit + stp * dgtest

        info = jnp.zeros((B,), jnp.int32)
        info = jnp.where(
            (s.brackt & ((stp <= stmin) | (stp >= stmax))) | (~s.ok), 6, info
        )
        info = jnp.where((stp == STPMAX) & (fv <= ftest1) & (dg <= dgtest), 5, info)
        info = jnp.where((stp == STPMIN) & ((fv > ftest1) | (dg >= dgtest)), 4, info)
        info = jnp.where(nfev >= MAXFEV, 3, info)
        info = jnp.where(s.brackt & ((stmax - stmin) <= XTOL * stmax), 2, info)
        info = jnp.where(
            (fv <= ftest1) & (jnp.abs(dg) <= GTOL * (-dginit)), 1, info
        )

        stage1 = s.stage1 & ~(
            (fv <= ftest1) & (dg >= jnp.minimum(FTOL, GTOL) * dginit)
        )
        use_mod = stage1 & (fv <= s.fx) & (fv > ftest1)

        sel = lambda m, a, b: jnp.where(m, a, b)
        fm = sel(use_mod, fv - stp * dgtest, fv)
        fxm = sel(use_mod, s.fx - s.stx * dgtest, s.fx)
        fym = sel(use_mod, s.fy - s.sty * dgtest, s.fy)
        dgm = sel(use_mod, dg - dgtest, dg)
        dgxm = sel(use_mod, s.dgx - dgtest, s.dgx)
        dgym = sel(use_mod, s.dgy - dgtest, s.dgy)

        stx2, fx2, dgx2, sty2, fy2, dgy2, stp2, brackt2, ok2 = cstep(
            s.stx, fxm, dgxm, s.sty, fym, dgym, stp, fm, dgm, s.brackt, stmin, stmax
        )

        fx3 = sel(use_mod, fx2 + stx2 * dgtest, fx2)
        fy3 = sel(use_mod, fy2 + sty2 * dgtest, fy2)
        dgx3 = sel(use_mod, dgx2 + dgtest, dgx2)
        dgy3 = sel(use_mod, dgy2 + dgtest, dgy2)

        slow = brackt2 & (jnp.abs(sty2 - stx2) >= 0.66 * s.width1)
        stp3 = jnp.where(slow, stx2 + 0.5 * (sty2 - stx2), stp2)
        width1 = jnp.where(brackt2, s.width, s.width1)
        width = jnp.where(brackt2, jnp.abs(sty2 - stx2), s.width)

        done = info != 0
        new = _FS(
            stp=jnp.where(done, stp, stp3),
            stx=stx2,
            fx=fx3,
            dgx=dgx3,
            sty=sty2,
            fy=fy3,
            dgy=dgy3,
            brackt=brackt2,
            stage1=stage1,
            nfev=nfev,
            width=width,
            width1=width1,
            ok=ok2,
            info=info,
        )
        # freeze lanes that already carried an info code into this trip
        return jax.tree_util.tree_map(
            lambda old, nw: jnp.where(active, nw, old), s, new
        )

    final = lax.while_loop(cond, body, init)
    bad = dginit >= 0.0
    return MTResult(
        alpha=jnp.where(bad, alpha0, final.stp),
        nfev=jnp.where(bad, 0, final.nfev),
        info=jnp.where(bad, -1, final.info),
    )
