"""L-BFGS-B: the Byrd-Lu-Nocedal-Zhu bound-constrained limited-memory BFGS.

The reference lists "L-BFGS-B/BFGS-B" as a TODO (changelist.txt:1-8).
``solvers.lbfgs`` covers the unbounded case plus a simple projected-gradient
box mode; this module is the full BLNZ algorithm (Byrd, Lu, Nocedal, Zhu,
"A limited memory algorithm for bound constrained optimization", SIAM J.
Sci. Comput. 16(5), 1995):

  1. limited-memory **compact representation** B = theta*I - W M W^T built
     from the (s, y) history ring;
  2. **generalized Cauchy point**: piecewise-quadratic minimization along
     the projected steepest-descent path, examining breakpoints in sorted
     order (a ``lax.scan`` over the n sorted breakpoints — static shapes,
     so the whole solver jits and vmaps over fleets of problems);
  3. **subspace minimization** over the variables free at the Cauchy point
     via the direct primal method with the Sherman-Morrison-Woodbury
     inverse (eqs. 5.4-5.11 of the paper), expressed with masks instead of
     gather/scatter so shapes stay static;
  4. strong-Wolfe More-Thuente line search truncated at the feasible
     boundary (the MINPACK ``stpmax`` the reference hard-codes to 1e15,
     nlsolver.h:1686, here set to the max feasible step).

Execution notes: the per-step dense work is O(n*m) matvecs plus one 2m x 2m
inverse; the breakpoint scan is n sequential steps of O(m) work.  For
large fleets vmap the whole ``minimize`` — every lane runs the same static
program.  Convergence is scipy-compatible: sup-norm of the projected
gradient below ``pg_eps``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import Bounds, Objective, SolverResult, drive, make_result, signed
from ..core.utils import HIGHEST, tree_where
from ..deriv import Deriv, make_grad
from ..linesearch import more_thuente


@dataclass(frozen=True)
class LBFGSBConfig:
    memory: int = 10
    max_iter: int = 200
    pg_eps: float = 1e-8          # sup-norm of projected gradient (scipy's pgtol)
    factr: float = 1e7            # relative f-change stop, scipy semantics:
                                  # stop when df <= factr * eps64 * max(|f|, 1),
                                  # floored at one ulp of the iterate dtype;
                                  # 0.0 disables (stop only on exact stall)
    alpha: float = 1.0
    deriv: Deriv = field(default_factory=Deriv)


class LBFGSBState(NamedTuple):
    x: jax.Array
    gradient: jax.Array
    f_prev: jax.Array
    s_hist: jax.Array      # [m, n] ring
    y_hist: jax.Array      # [m, n] ring
    valid: jax.Array       # [m] bool
    head: jax.Array        # ring insert position (monotonic)
    iteration: jax.Array
    nfev: jax.Array
    gfev: jax.Array
    done: jax.Array
    converged: jax.Array


def _compact_rep(s_hist, y_hist, valid, head):
    """Chronologically-ordered compact representation of B = theta*I - W M W^T.

    Returns (theta, W [n, 2m], Minv [2m, 2m]) where Minv is the *inverse*
    middle matrix M (i.e. M = inv([[-D, L^T], [L, theta S^T S]])).
    Invalid ring slots are padded to an identity block and their W columns
    zeroed, so they contribute nothing.
    """
    m, n = s_hist.shape
    dtype = s_hist.dtype

    order = (head + jnp.arange(m)) % m          # oldest -> newest
    S = s_hist[order]                            # [m, n] chronological
    Y = y_hist[order]
    v = valid[order].astype(dtype)               # [m]

    SY = jnp.matmul(S, Y.T, precision=HIGHEST)   # [m, m]: SY[i, j] = s_i . y_j
    d = jnp.diag(SY)                             # s_i . y_i
    vv = v[:, None] * v[None, :]
    L = jnp.tril(SY, k=-1) * vv
    D = jnp.where(v > 0, d, 1.0)                 # pad invalid slots

    newest = (head - 1) % m
    ys = jnp.dot(s_hist[newest], y_hist[newest], precision=HIGHEST)
    yy = jnp.dot(y_hist[newest], y_hist[newest], precision=HIGHEST)
    theta = jnp.where(valid[newest] & (yy > 0), yy / ys, 1.0)

    SS = jnp.matmul(S, S.T, precision=HIGHEST) * vv
    SS = SS + jnp.diag(jnp.where(v > 0, 0.0, 1.0))

    Mmat = jnp.block([[-jnp.diag(D), L.T], [L, theta * SS]])
    Minv = jnp.linalg.inv(Mmat)                  # 2m x 2m — tiny

    W = jnp.concatenate([Y * v[:, None], theta * S * v[:, None]], axis=0).T  # [n, 2m]
    return theta, W, Minv


def _cauchy_point(x, g, lower, upper, theta, W, Minv):
    """Generalized Cauchy point (BLNZ algorithm CP, sec. 4).

    Returns (xcp, c) with c = W^T (xcp - x) accumulated along the path.
    """
    n = x.shape[0]
    dtype = x.dtype
    eps = jnp.asarray(jnp.finfo(dtype).tiny * 1e4, dtype)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    d0 = -g
    bound_gap = jnp.where(d0 > 0, upper - x, lower - x)        # signed gap
    t_raw = jnp.where(d0 != 0, bound_gap / jnp.where(d0 != 0, d0, 1.0), big)
    t_raw = jnp.where(jnp.isfinite(t_raw), t_raw, big)
    at_bound = (d0 != 0) & (t_raw <= 0)
    d0 = jnp.where(at_bound | (d0 == 0), 0.0, d0)
    t = jnp.where(d0 != 0, t_raw, big)                         # breakpoints

    order = jnp.argsort(t)

    p = jnp.matmul(W.T, d0, precision=HIGHEST)                 # [2m]
    c = jnp.zeros_like(p)
    fp = -jnp.dot(d0, d0, precision=HIGHEST)
    fpp = -theta * fp - jnp.dot(
        p, jnp.matmul(Minv, p, precision=HIGHEST), precision=HIGHEST
    )
    fpp = jnp.maximum(fpp, eps)

    class C(NamedTuple):
        d: jax.Array
        p: jax.Array
        c: jax.Array
        fp: jax.Array
        fpp: jax.Array
        t_old: jax.Array
        stopped: jax.Array

    def scan_step(carry: C, b):
        t_b = t[b]
        dt = t_b - carry.t_old
        dt_min = -carry.fp / carry.fpp
        # minimizer inside the current segment, path exhausted, or already
        # non-descent (fp >= 0): stop before processing this breakpoint
        stop_here = carry.stopped | (dt_min < dt) | (t_b >= big) | (carry.fp >= 0)

        gb = g[b]
        zb = jnp.where(d0[b] > 0, upper[b], lower[b]) - x[b]
        wb = W[b]
        c_new = carry.c + dt * carry.p
        Mc = jnp.matmul(Minv, c_new, precision=HIGHEST)
        Mp = jnp.matmul(Minv, carry.p, precision=HIGHEST)
        Mw = jnp.matmul(Minv, wb, precision=HIGHEST)
        fp_new = (
            carry.fp + dt * carry.fpp + gb * gb + theta * gb * zb
            - gb * jnp.dot(wb, Mc, precision=HIGHEST)
        )
        fpp_new = (
            carry.fpp - theta * gb * gb
            - 2.0 * gb * jnp.dot(wb, Mp, precision=HIGHEST)
            - gb * gb * jnp.dot(wb, Mw, precision=HIGHEST)
        )
        fpp_new = jnp.maximum(fpp_new, eps)
        p_new = carry.p + gb * wb
        d_new = carry.d.at[b].set(0.0)

        active = ~stop_here
        new = C(
            d=jnp.where(active, d_new, carry.d),
            p=jnp.where(active, p_new, carry.p),
            c=jnp.where(active, c_new, carry.c),
            fp=jnp.where(active, fp_new, carry.fp),
            fpp=jnp.where(active, fpp_new, carry.fpp),
            t_old=jnp.where(active, t_b, carry.t_old),
            stopped=stop_here,
        )
        return new, None

    init = C(
        d=d0, p=p, c=c,
        fp=fp, fpp=fpp,
        t_old=jnp.asarray(0.0, dtype),
        stopped=jnp.asarray(False),
    )
    fin, _ = lax.scan(scan_step, init, order)

    dt_min = jnp.maximum(-fin.fp / fin.fpp, 0.0)
    t_cp = fin.t_old + dt_min
    xcp = x + jnp.minimum(t_cp, t) * d0
    xcp = jnp.clip(xcp, lower, upper)
    c_final = fin.c + dt_min * fin.p
    # free at the Cauchy point: breakpoint not yet reached AND not pinned at
    # a bound with the gradient pushing outward (those have t_i = 0 in the
    # paper; here they carry t = big purely to stay out of the scan)
    free = (t > t_cp) & ~at_bound & jnp.isfinite(t_cp)
    return xcp, c_final, free


def _subspace_step(x, g, xcp, c, free, lower, upper, theta, W, Minv):
    """Direct primal subspace minimization (BLNZ sec. 5.1, SMW form).

    Minimizes the quadratic model over the variables free at the Cauchy
    point, masked (no gathers).  Returns xbar, clipped to the box via the
    standard alpha* backtrack toward xcp.
    """
    dtype = x.dtype
    F = free.astype(dtype)
    twom = W.shape[1]

    # reduced gradient of the quadratic at xcp
    mm = lambda a, b: jnp.matmul(a, b, precision=HIGHEST)
    r = (g + theta * (xcp - x) - mm(W, mm(Minv, c))) * F

    k = mm(Minv, mm(W.T, r))
    WF = W * F[:, None]                      # Z Z^T W
    N = jnp.eye(twom, dtype=dtype) - mm(Minv, mm(W.T, WF)) / theta
    v = jnp.linalg.solve(N, k)
    du = -(r / theta + mm(WF, v) / theta**2) * F

    # alpha*: largest step in [0, 1] keeping xcp + alpha*du inside the box
    gap = jnp.where(du > 0, upper - xcp, lower - xcp)
    ratio = jnp.where(du != 0, gap / jnp.where(du != 0, du, 1.0), jnp.inf)
    ratio = jnp.where(jnp.isnan(ratio), jnp.inf, ratio)
    alpha_star = jnp.clip(jnp.min(ratio), 0.0, 1.0)

    xbar = jnp.clip(xcp + alpha_star * du, lower, upper)
    return xbar


def init(fn: Objective, x0: jax.Array, config: LBFGSBConfig) -> LBFGSBState:
    n = x0.shape[-1]
    m = config.memory
    grad_fn, g_cost = make_grad(fn, n, config.deriv)
    g = grad_fn(x0)
    return LBFGSBState(
        x=x0,
        gradient=g,
        f_prev=jnp.asarray(jnp.inf, x0.dtype),
        s_hist=jnp.zeros((m, n), x0.dtype),
        y_hist=jnp.zeros((m, n), x0.dtype),
        valid=jnp.zeros((m,), bool),
        head=jnp.int32(0),
        iteration=jnp.int32(0),
        nfev=jnp.int32(g_cost),
        gfev=jnp.int32(1),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(fn, state: LBFGSBState, config: LBFGSBConfig, lower, upper) -> LBFGSBState:
    n = state.x.shape[-1]
    m = config.memory
    dtype = state.x.dtype
    grad_fn, g_cost = make_grad(fn, n, config.deriv)

    x, g = state.x, state.gradient
    f0 = fn(x)
    # scipy-compatible convergence: sup-norm of the projected gradient,
    # or the relative f-change falling below factr * machine-eps
    pg = jnp.clip(x - g, lower, upper) - x
    pg_norm = jnp.max(jnp.abs(pg))
    hit_tol = pg_norm < config.pg_eps
    f_scale = jnp.maximum(jnp.maximum(jnp.abs(state.f_prev), jnp.abs(f0)), 1.0)
    # factr is anchored to float64 eps (scipy's semantics are double-only);
    # in narrower dtypes the threshold is floored at one working-dtype ulp so
    # the stop still fires when f-progress falls below representable.
    if config.factr > 0:
        ftol_rel = max(
            config.factr * 2.220446049250313e-16, float(jnp.finfo(dtype).eps)
        )
    else:
        ftol_rel = 0.0
    hit_ftol = jnp.isfinite(state.f_prev) & (
        (state.f_prev - f0) <= ftol_rel * f_scale
    )
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | hit_ftol
        | ~jnp.isfinite(pg_norm)
    )
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol | hit_ftol)

    theta, W, Minv = _compact_rep(state.s_hist, state.y_hist, state.valid, state.head)
    xcp, c, free = _cauchy_point(x, g, lower, upper, theta, W, Minv)
    xbar = _subspace_step(x, g, xcp, c, free, lower, upper, theta, W, Minv)

    d = xbar - x
    dg = jnp.dot(g, d, precision=HIGHEST)
    # fall back to the Cauchy direction, then to the projected gradient,
    # whenever the subspace step loses descent (mirrors the reference's
    # BFGS H-reset self-healing, nlsolver.h:3253-3260)
    d_cp = xcp - x
    d = jnp.where(dg < 0, d, d_cp)
    dg = jnp.dot(g, d, precision=HIGHEST)
    d = jnp.where(dg < 0, d, pg)
    dg = jnp.dot(g, d, precision=HIGHEST)

    # max feasible step along d (xbar is feasible, so alpha_max >= 1)
    gap = jnp.where(d > 0, upper - x, lower - x)
    ratio = jnp.where(d != 0, gap / jnp.where(d != 0, d, 1.0), jnp.inf)
    ratio = jnp.where(jnp.isnan(ratio), jnp.inf, ratio)
    alpha_max = jnp.clip(jnp.min(ratio), 1.0, 1e10)

    ls = more_thuente(fn, grad_fn, x, f0, g, d, config.alpha, alpha_max=alpha_max)
    new_x = jnp.clip(x + ls.alpha * d, lower, upper)
    s = new_x - x
    new_g = grad_fn(new_x)
    y = new_g - g

    ys = jnp.dot(y, s, precision=HIGHEST)
    yy = jnp.dot(y, y, precision=HIGHEST)
    good_pair = ys > jnp.asarray(jnp.finfo(dtype).eps, dtype) * yy
    idx = state.head % m
    s_hist = state.s_hist.at[idx].set(jnp.where(good_pair, s, state.s_hist[idx]))
    y_hist = state.y_hist.at[idx].set(jnp.where(good_pair, y, state.y_hist[idx]))
    valid = state.valid.at[idx].set(good_pair | state.valid[idx])
    head = jnp.where(good_pair, state.head + 1, state.head)

    worked = LBFGSBState(
        x=new_x,
        gradient=new_g,
        f_prev=f0,
        s_hist=s_hist,
        y_hist=y_hist,
        valid=valid,
        head=head,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev * (1 + g_cost) + g_cost,
        gfev=state.gfev + ls.nfev + 1,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    return tree_where(done_now, halted, worked)


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: LBFGSBConfig = LBFGSBConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,
    _minimize: bool = True,
) -> SolverResult:
    sfn = signed(fn, _minimize)
    x0 = jnp.asarray(x0)
    if bounds is not None:
        lower = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape)
        upper = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape)
    else:
        big = jnp.asarray(jnp.finfo(x0.dtype).max / 4, x0.dtype)
        lower = jnp.full_like(x0, -big)
        upper = jnp.full_like(x0, big)
    x0 = jnp.clip(x0, lower, upper)
    state = init(sfn, x0, config)
    state = drive(lambda s: step(sfn, s, config, lower, upper), state)
    f_val = sfn(state.x)
    return make_result(
        x=state.x,
        f_value=-f_val if not _minimize else f_val,
        iterations=state.iteration,
        function_calls=state.nfev + 1,
        gradient_calls=state.gfev,
        converged=state.converged,
    )


def maximize(fn, x0, config: LBFGSBConfig = LBFGSBConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
