"""1-D root finders: bisection, false position, Brent, Ridders, Tiruneh,
ITP, Chandrupatla.

Re-creation of ``nlsolver::rootfinder`` (nlsolver.h:3923-4319) as pure
scalar state machines under ``lax.while_loop`` — every finder ``vmap``s over
large batches of bracketing problems, which is the fleet execution model
(SURVEY.md §3.5: "vmapped scalar while-loops over large batches").

Differences from the reference (deliberate):
  * a failed bracket check returns ``bracketed=False`` (with NaN x) instead
    of printing to stdout (nlsolver.h:3939-3943) — jit-pure;
  * interval updates are sign-aware (they compare against f(a) rather than
    assuming f is increasing through the root) — the reference's ``val > 0
    => b = mid`` update silently loses the bracket on decreasing functions;
  * ``false_position`` updates ``val_b`` with the function value — the
    reference assigns the midpoint by mistake (``val_b = mid``,
    nlsolver.h:3996);
  * all defaults match the reference (incl. ridders' max_iter=5 and
    tiruneh's 3-point start {-100, 0, 100}).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class RootResult(NamedTuple):
    x: jax.Array
    f_value: jax.Array
    iterations: jax.Array
    function_calls: jax.Array
    converged: jax.Array
    bracketed: jax.Array  # initial interval actually bracketed a root


def _not_bracketed(dtype):
    nan = jnp.asarray(jnp.nan, dtype)
    return RootResult(
        x=nan,
        f_value=nan,
        iterations=jnp.int32(0),
        function_calls=jnp.int32(2),
        converged=jnp.asarray(False),
        bracketed=jnp.asarray(False),
    )


def _merge(bracketed_ok, result_ok: RootResult, dtype) -> RootResult:
    from ..core.utils import tree_where

    return tree_where(bracketed_ok, result_ok, _not_bracketed(dtype))


def bisection(fn, lower, upper, eps=1e-6, max_iter=200) -> RootResult:
    """nlsolver.h:3924-3962 (defaults lower=-100, upper=100 there)."""
    lower = jnp.asarray(lower, jnp.result_type(lower, upper, float))
    upper = jnp.asarray(upper, lower.dtype)
    a = jnp.minimum(lower, upper)
    b = jnp.maximum(lower, upper)
    fa = fn(a)
    fb = fn(b)
    ok = fa * fb < 0

    def cond(s):
        return ~s[-1]

    def body(s):
        a, fa, b, it, nfev, x, val, done = s
        mid = (a + b) / 2
        v = fn(mid)
        nfev = nfev + 1
        stop = (jnp.abs(v) < eps) | (it > max_iter)
        same_side = v * fa > 0
        new_a = jnp.where(same_side, mid, a)
        new_fa = jnp.where(same_side, v, fa)
        new_b = jnp.where(same_side, b, mid)
        return (
            jnp.where(stop, a, new_a),
            jnp.where(stop, fa, new_fa),
            jnp.where(stop, b, new_b),
            jnp.where(stop, it, it + 1),
            nfev,
            mid,
            v,
            stop,
        )

    init = (a, fa, b, jnp.int32(0), jnp.int32(2), a, fa, ~ok)
    a_, fa_, b_, it, nfev, x, val, _ = lax.while_loop(cond, body, init)
    res = RootResult(x, val, it, nfev, jnp.abs(val) < eps, jnp.asarray(True))
    return _merge(ok, res, a.dtype)


def false_position(fn, lower, upper, eps=1e-6, max_iter=200,
                   variant="fixed") -> RootResult:
    """Regula falsi (nlsolver.h:3963-4000).

    Default fixes two reference quirks; ``variant="reference"`` reproduces
    them for trajectory parity:
      * the reference keeps the FUNCTION-VALUE slot of the upper bracket as
        the midpoint COORDINATE (``val_b = mid``, nlsolver.h:3996);
      * its side test is ``val < 0`` / ``val > 0`` (assumes f increasing
        through the root) rather than sign-aware.
    """
    a = jnp.asarray(lower, jnp.result_type(lower, upper, float))
    b = jnp.asarray(upper, a.dtype)
    fa = fn(a)
    fb = fn(b)
    ok = fa * fb < 0
    reference = variant == "reference"

    def cond(s):
        return ~s[-1]

    def body(s):
        a, fa, b, fb, it, nfev, x, val, done = s
        mid = a + ((b - a) * fa) / (fa - fb)
        v = fn(mid)
        nfev = nfev + 1
        stop = (jnp.abs(v) < eps) | (it > max_iter)
        same_side = v < 0 if reference else v * fa > 0
        new_a = jnp.where(same_side, mid, a)
        new_fa = jnp.where(same_side, v, fa)
        new_b = jnp.where(same_side, b, mid)
        new_fb = jnp.where(same_side, fb, jnp.where(reference, mid, v))
        keep = lambda old, new: jnp.where(stop, old, new)
        return (
            keep(a, new_a),
            keep(fa, new_fa),
            keep(b, new_b),
            keep(fb, new_fb),
            keep(it, it + 1),
            nfev,
            mid,
            v,
            stop,
        )

    init = (a, fa, b, fb, jnp.int32(0), jnp.int32(2), a, fa, ~ok)
    state = lax.while_loop(cond, body, init)
    it, nfev, x, val = state[4], state[5], state[6], state[7]
    res = RootResult(x, val, it, nfev, jnp.abs(val) < eps, jnp.asarray(True))
    return _merge(ok, res, a.dtype)


def brent(fn, lower, upper, tol=1e-12, max_iter=200) -> RootResult:
    """Brent's method: IQI + secant + bisection safeguards
    (nlsolver.h:4002-4067)."""
    a = jnp.asarray(lower, jnp.result_type(lower, upper, float))
    b = jnp.asarray(upper, a.dtype)
    fa = fn(a)
    fb = fn(b)
    ok = fa * fb < 0
    # reference keeps (a, b) as given; it swaps during iteration only

    class S(NamedTuple):
        a: jax.Array
        fa: jax.Array
        b: jax.Array
        fb: jax.Array
        c: jax.Array
        fc: jax.Array
        d: jax.Array
        flag: jax.Array
        it: jax.Array
        nfev: jax.Array
        fs: jax.Array
        done: jax.Array

    init = S(a, fa, b, fb, a, fa, jnp.zeros_like(a), jnp.asarray(True),
             jnp.int32(0), jnp.int32(2), fb, ~ok)

    def cond(s: S):
        return ~s.done

    def body(s: S) -> S:
        use_iqi = (s.fa != s.fc) & (s.fb != s.fc)
        denom_ab = jnp.where(s.fa == s.fb, 1.0, s.fa - s.fb)
        iqi = (
            (s.a * s.fb * s.fc) / (denom_ab * jnp.where(s.fa == s.fc, 1.0, s.fa - s.fc))
            + (s.b * s.fa * s.fc) / (-denom_ab * jnp.where(s.fb == s.fc, 1.0, s.fb - s.fc))
            + (s.c * s.fa * s.fb)
            / (jnp.where(s.fc == s.fa, 1.0, s.fc - s.fa) * jnp.where(s.fc == s.fb, 1.0, s.fc - s.fb))
        )
        # reference divides by (val_b - val_a) (nlsolver.h:4033); -denom_ab
        # is bit-identical to fb - fa (IEEE negation is exact)
        secant = s.b - s.fb * ((s.b - s.a) / -denom_ab)
        cand = jnp.where(use_iqi, iqi, secant)

        # fa == fb makes the reference's secant (and IQI) divide by zero:
        # the inf/NaN candidate always fails its safeguard window test, so
        # it invariably falls through to bisection.  The where-guarded
        # denominators above produce a finite bogus candidate instead, so
        # force the bisection branch explicitly to match.
        degenerate = s.fa == s.fb
        cond_bisect = (
            degenerate
            | ~((cand > (3 * s.a + s.b) / 4) & (cand < s.b))
            | (s.flag & (jnp.abs(cand - s.b) >= jnp.abs(s.b - s.c) / 2))
            | (~s.flag & (jnp.abs(cand - s.b) >= jnp.abs(s.c - s.d) / 2))
            | (s.flag & (jnp.abs(s.b - s.c) < tol))
            | (~s.flag & (jnp.abs(s.c - s.d) < tol))
        )
        cand = jnp.where(cond_bisect, (s.a + s.b) / 2, cand)
        flag = cond_bisect

        fs = fn(cand)
        nfev = s.nfev + 1
        d = s.c
        c, fc = s.b, s.fb
        move_b = s.fa * fs < 0
        b2 = jnp.where(move_b, cand, s.b)
        fb2 = jnp.where(move_b, fs, s.fb)
        a2 = jnp.where(move_b, s.a, cand)
        fa2 = jnp.where(move_b, s.fa, fs)
        swap = jnp.abs(fa2) < jnp.abs(fb2)
        a3 = jnp.where(swap, b2, a2)
        b3 = jnp.where(swap, a2, b2)
        fa3 = jnp.where(swap, fb2, fa2)
        fb3 = jnp.where(swap, fa2, fb2)
        done = (
            (jnp.abs(fb3) < tol)
            | (jnp.abs(fs) < tol)
            | (jnp.abs(b3 - a3) < tol)
            | (s.it >= max_iter)
        )
        return S(a3, fa3, b3, fb3, c, fc, d, flag, s.it + 1, nfev, fs, done)

    final = lax.while_loop(cond, body, init)
    # reference returns on the check BEFORE incrementing iter visible outside
    res = RootResult(
        x=final.b,
        f_value=final.fb,
        iterations=final.it - 1,
        function_calls=final.nfev,
        converged=jnp.abs(final.fb) < tol,
        bracketed=jnp.asarray(True),
    )
    return _merge(ok, res, a.dtype)


def ridders(fn, lower, upper, tol=1e-12, eps=1e-12, max_iter=5) -> RootResult:
    """Ridders' exponential-fit method (nlsolver.h:4069-4124; the
    reference's default max_iter really is 5)."""
    a = jnp.asarray(lower, jnp.result_type(lower, upper, float))
    b = jnp.asarray(upper, a.dtype)
    fa = fn(a)
    fb = fn(b)
    ok = fa * fb < 0

    class S(NamedTuple):
        a: jax.Array
        fa: jax.Array
        b: jax.Array
        fb: jax.Array
        it: jax.Array
        nfev: jax.Array
        x: jax.Array
        fx: jax.Array
        done: jax.Array

    init = S(a, fa, b, fb, jnp.int32(0), jnp.int32(2), a, fa, ~ok)

    def cond(s: S):
        return ~s.done

    def body(s: S) -> S:
        mid = (s.a + s.b) / 2
        fmid = fn(mid)
        denom = jnp.sqrt(jnp.maximum(fmid**2 - s.fa * s.fb, 1e-300))
        new_mid = mid + (mid - s.a) * (
            jnp.sign(s.fa - s.fb) * fmid / denom
        )
        fnew = fn(new_mid)
        nfev = s.nfev + 2
        stop = (
            (jnp.minimum(jnp.abs(new_mid - s.a), jnp.abs(new_mid - s.b)) < tol)
            | (jnp.abs(fnew) < eps)
            | (s.it >= max_iter)
        )
        # bracket update (nlsolver.h:4109-4121)
        case1 = fmid * fnew < 0
        case2 = (~case1) & (s.fa * fnew < 0)
        a2 = jnp.where(case1, mid, s.a)
        fa2 = jnp.where(case1, fmid, s.fa)
        a3 = jnp.where(case2, new_mid, a2)
        fa3 = jnp.where(case2, fnew, fa2)
        b2 = jnp.where(case1, new_mid, jnp.where(case2, s.b, new_mid))
        fb2 = jnp.where(case1, fnew, jnp.where(case2, s.fb, fnew))
        keep = lambda old, new: jnp.where(stop, old, new)
        return S(
            keep(s.a, a3),
            keep(s.fa, fa3),
            keep(s.b, b2),
            keep(s.fb, fb2),
            jnp.where(stop, s.it, s.it + 1),
            nfev,
            new_mid,
            fnew,
            stop,
        )

    final = lax.while_loop(cond, body, init)
    res = RootResult(
        x=final.x,
        f_value=final.fx,
        iterations=final.it,
        function_calls=final.nfev,
        converged=jnp.abs(final.fx) < eps,
        bracketed=jnp.asarray(True),
    )
    return _merge(ok, res, a.dtype)


def tiruneh(fn, x_k=(-100.0, 0.0, 100.0), eps=1e-6, tol=1e-12, max_iter=10) -> RootResult:
    """Tiruneh's 3-point memory method (arXiv:1902.09058; reference
    nlsolver.h:4144-4183).  Keeps a rolling (oldest, middle, newest) window;
    like the reference, termination tests and the returned iterate use the
    OLDEST element of the window (its circulant's ``last()`` is the oldest
    slot)."""
    k0 = jnp.asarray(x_k[0], jnp.result_type(*x_k, float))
    k1 = jnp.asarray(x_k[1], k0.dtype)
    k2 = jnp.asarray(x_k[2], k0.dtype)
    f0, f1, f2 = fn(k0), fn(k1), fn(k2)

    class S(NamedTuple):
        k0: jax.Array
        k1: jax.Array
        k2: jax.Array
        f0: jax.Array
        f1: jax.Array
        f2: jax.Array
        it: jax.Array
        nfev: jax.Array
        done: jax.Array

    init = S(k0, k1, k2, f0, f1, f2, jnp.int32(0), jnp.int32(3), jnp.asarray(False))

    def cond(s: S):
        return ~s.done

    def body(s: S) -> S:
        stop = (jnp.abs(s.f0) < tol) | (s.it > max_iter) | (jnp.abs(s.f0 - s.f1) < eps)

        slope02 = (s.f0 - s.f2) / (s.k0 - s.k2)
        slope12 = (s.f1 - s.f2) / (s.k1 - s.k2)
        denom = slope02 * (s.f0 - s.f1) - s.f0 * (slope02 - slope12)
        new = s.k2 - (s.f2 * (s.f0 - s.f1)) / denom
        fnew = fn(new)
        keep = lambda old, nv: jnp.where(stop, old, nv)
        return S(
            keep(s.k0, s.k1),
            keep(s.k1, s.k2),
            keep(s.k2, new),
            keep(s.f0, s.f1),
            keep(s.f1, s.f2),
            keep(s.f2, fnew),
            jnp.where(stop, s.it, s.it + 1),
            jnp.where(stop, s.nfev, s.nfev + 1),
            stop,
        )

    final = lax.while_loop(cond, body, init)
    return RootResult(
        x=final.k0,
        f_value=final.f0,
        iterations=final.it,
        function_calls=final.nfev,
        converged=jnp.abs(final.f0) < tol,
        bracketed=jnp.asarray(True),  # not a bracketing method
    )


def itp(fn, lower, upper, kappa1=0.3, kappa2=2.1, n0=1.0, tol=1e-12, eps=1e-12,
        max_iter=200, variant="fixed") -> RootResult:
    """ITP method (nlsolver.h:4184-4249; Oliveira & Takahashi, ACM TOMS
    47(1), 2020).

    Default fixes two reference quirks; ``variant="reference"`` reproduces
    them for trajectory parity:
      * the reference's projection radius ``r = eps 2^(n_max - 1) - (b-a)/2``
        never shrinks with the iteration count j (the paper's
        ``eps 2^(n_max - j)``), so ITP loses its bisection-like worst case:
        once the interpolation lands on a bracket end and the truncation
        step is below one ulp, the step repeats until max_iter (measured:
        40% of a float32 fleet of x^3 - c brackets missed 1e-6);
      * sigma is the 0/1 indicator (mid > interp) rather than the paper's
        +-1 sign, and the projection test is the signed ``mid - interp <= r``
        rather than ``|x_t - mid| <= r``.
    """
    reference = variant == "reference"
    a = jnp.asarray(lower, jnp.result_type(lower, upper, float))
    b = jnp.asarray(upper, a.dtype)
    fa = fn(a)
    fb = fn(b)
    ok = fa * fb < 0
    two_eps = 2 * eps
    n_max = jnp.log2((b - a) / two_eps) + n0

    class S(NamedTuple):
        a: jax.Array
        fa: jax.Array
        b: jax.Array
        fb: jax.Array
        it: jax.Array
        nfev: jax.Array
        x: jax.Array
        fx: jax.Array
        done: jax.Array
        converged: jax.Array

    init = S(a, fa, b, fb, jnp.int32(0), jnp.int32(2), (a + b) / 2,
             jnp.asarray(1e5, a.dtype), ~ok, jnp.asarray(False))

    def cond(s: S):
        return ~s.done

    def body(s: S) -> S:
        b_min_a = s.b - s.a
        exhausted = (b_min_a < two_eps) | (s.it >= max_iter)

        mid = (s.a + s.b) / 2
        delta = kappa1 * b_min_a**kappa2
        interp = (s.fb * s.a - s.fa * s.b) / jnp.where(s.fb == s.fa, 1.0, s.fb - s.fa)
        temp = mid - interp
        if reference:
            r = eps * 2.0 ** (n_max - 1) - b_min_a / 2
            sigma = (temp > 0).astype(s.a.dtype)  # reference's 0/1 indicator
            project = temp <= r
            interp = jnp.where(delta <= jnp.abs(temp), interp + sigma * delta, mid)
        else:
            r = eps * 2.0 ** (n_max - s.it.astype(s.a.dtype)) - b_min_a / 2
            sigma = jnp.sign(temp)
            interp = jnp.where(delta <= jnp.abs(temp), interp + sigma * delta, mid)
            project = jnp.abs(interp - mid) <= r
        xt = jnp.where(project, interp, mid - sigma * r)

        ft = fn(xt)
        nfev = s.nfev + 1
        exact = ft == 0
        same_side = ft * s.fa > 0
        a2 = jnp.where(same_side, xt, s.a)
        fa2 = jnp.where(same_side, ft, s.fa)
        b2 = jnp.where(same_side, s.b, xt)
        fb2 = jnp.where(same_side, s.fb, ft)

        stop = exhausted | exact
        x_out = jnp.where(exhausted, mid, xt)
        keep = lambda old, nv: jnp.where(exhausted, old, nv)
        return S(
            keep(s.a, a2),
            keep(s.fa, fa2),
            keep(s.b, b2),
            keep(s.fb, fb2),
            jnp.where(stop, s.it, s.it + 1),
            jnp.where(exhausted, s.nfev, nfev),
            jnp.where(stop, x_out, s.x),
            jnp.where(exhausted, s.fx, ft),
            stop,
            exact | (exhausted & (b_min_a < two_eps)),
        )

    final = lax.while_loop(cond, body, init)
    res = RootResult(
        x=final.x,
        f_value=final.fx,
        iterations=final.it,
        function_calls=final.nfev,
        converged=final.converged,
        bracketed=jnp.asarray(True),
    )
    return _merge(ok, res, a.dtype)


def chandrupatla(fn, lower, upper, eps_m=1e-10, eps_a=2e-10, max_iter=200) -> RootResult:
    """Chandrupatla's method: IQI/bisection switch via the xi/phi test
    (nlsolver.h:4251-4318)."""
    a = jnp.asarray(lower, jnp.result_type(lower, upper, float))
    b = jnp.asarray(upper, a.dtype)
    fa = fn(a)
    fb = fn(b)
    ok = fa * fb < 0

    class S(NamedTuple):
        a: jax.Array
        fa: jax.Array
        b: jax.Array
        fb: jax.Array
        c: jax.Array
        fc: jax.Array
        t: jax.Array
        it: jax.Array
        nfev: jax.Array
        xm: jax.Array
        fm: jax.Array
        done: jax.Array

    init = S(a, fa, b, fb, b, jnp.asarray(0.0, a.dtype), jnp.asarray(0.5, a.dtype),
             jnp.int32(0), jnp.int32(2), a, fa, ~ok)

    def cond(s: S):
        return ~s.done

    def body(s: S) -> S:
        xt = s.b + s.t * (s.a - s.b)
        ft = fn(xt)
        nfev = s.nfev + 1
        sign_change = ft * s.fb < 0
        c2 = jnp.where(sign_change, s.a, s.b)
        fc2 = jnp.where(sign_change, s.fa, s.fb)
        a2 = jnp.where(sign_change, s.b, s.a)
        fa2 = jnp.where(sign_change, s.fb, s.fa)
        b2 = xt
        fb2 = ft

        b_smaller = jnp.abs(fb2) < jnp.abs(fa2)
        xm = jnp.where(b_smaller, b2, a2)
        fm = jnp.where(b_smaller, fb2, fa2)
        stop1 = (jnp.abs(fm) < eps_a) | (s.it > max_iter)

        tol = 2 * eps_m * jnp.abs(xm) + eps_a
        t_lim = tol / jnp.where(a2 == c2, 1e-300, jnp.abs(a2 - c2))
        stop2 = t_lim > 0.5
        stop = stop1 | stop2

        xi = (a2 - b2) / jnp.where(c2 == b2, 1.0, c2 - b2)
        phi = (fa2 - fb2) / jnp.where(fc2 == fb2, 1.0, fc2 - fb2)
        use_iqi = (phi**2 < xi) & ((1 - phi) ** 2 < (1 - xi))
        t_iqi = fa2 / jnp.where(fb2 == fa2, 1.0, fb2 - fa2) * fc2 / jnp.where(
            fb2 == fc2, 1.0, fb2 - fc2
        ) + (c2 - a2) / jnp.where(b2 == a2, 1.0, b2 - a2) * fa2 / jnp.where(
            fc2 == fa2, 1.0, fc2 - fa2
        ) * fb2 / jnp.where(
            fc2 == fb2, 1.0, fc2 - fb2
        )
        t_new = jnp.where(use_iqi, t_iqi, 0.5)
        t_new = jnp.clip(t_new, t_lim, 1.0 - t_lim)

        return S(
            a2, fa2, b2, fb2, c2, fc2, t_new,
            jnp.where(stop, s.it, s.it + 1), nfev, xm, fm, stop,
        )

    final = lax.while_loop(cond, body, init)
    res = RootResult(
        x=final.xm,
        f_value=final.fm,
        iterations=final.it,
        function_calls=final.nfev,
        converged=jnp.abs(final.fm) < eps_a,
        bracketed=jnp.asarray(True),
    )
    return _merge(ok, res, a.dtype)


ALL_FINDERS = {
    "bisection": bisection,
    "false_position": false_position,
    "brent": brent,
    "ridders": ridders,
    "tiruneh": tiruneh,
    "itp": itp,
    "chandrupatla": chandrupatla,
}
