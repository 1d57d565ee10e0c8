"""Batch-minor CMA-ES fleet: B independent strategies as one lane-parallel
program.

The single-instance ``solvers.cmaes`` under ``vmap`` leaves XLA a [B, n, n]
batched eigendecomposition — exactly the shape ``jnp.linalg.eigh`` is worst
at (thousands of tiny matrices).  This driver keeps the FLEET on the
trailing (lane) axis end-to-end — means [n, B], covariances [n, n, B],
populations [n, lam, B] — the repo's batch-minor layout rule
(solvers/bfgs_fleet.py, ops/smallchol.py), and plugs in the batched
parallel-order Jacobi eigensolver (``linalg.jacobi``) or XLA's batched
``eigh`` where the reference uses tinyqr's iterated QR
(tinyqr.h:317-434 via nlsolver.h:4539).

Every other update is elementwise over the lanes; the n-sized
contractions (sampling y = B D z, C^{-1/2} y_w, the rank-mu update) are
unrolled over the small n/mu axes into B-wide elementwise FMAs instead
of B tiny matrix products.

Algorithm identical to ``solvers.cmaes`` (Hansen tutorial, arXiv:1604.00772)
including projection-repair bounds, the stagnation-gated restart variance
kick (reference intent nlsolver.h:4566-4568), and per-lane termination on
max_iter / stagnation / condition number / sigma collapse.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import Bounds, make_result
from .bfgs_fleet import colwise
from .cmaes import _params


@dataclass(frozen=True)
class CMAESFleetConfig:
    pop_size: int = 0          # 0 => 4 + floor(3 ln n)
    sigma0: float = 0.5
    max_iter: int = 500
    f_tol: float = 1e-12
    best_value_no_change: int = 50
    cond_max: float = 1e14
    kick_tol: float = 1e-6
    kick_patience: int = 10
    # eigensolver for C = B D^2 B^T: "jacobi" (batched parallel-order
    # Jacobi, linalg.jacobi) or "xla" (batched jnp.linalg.eigh)
    eigh_method: str = "jacobi"
    sweeps: int = 8
    # Hansen's lazy eigendecomposition (tutorial code's `eigeneval` gating):
    # recompute B, D every k generations and sample from the stale basis in
    # between — C itself accumulates every generation.  Where the
    # eigendecomposition dominates the fleet step, throughput scales almost
    # linearly with this interval (its share on a GPU: chip_smoke.py);
    # the tutorial's guidance is ~1/(c1+cmu)/n/10 generations of staleness
    # being statistically invisible.  1 = recompute every generation
    # (bit-identical to the eager path).  Two staleness consequences at
    # interval k: (a) the cond>cond_max termination test lags by up to k-1
    # generations (it reads the last computed spectrum); (b) a restart
    # variance kick would otherwise keep sampling from the pre-kick basis —
    # so any kick forces a refresh on the NEXT generation (state.kicked).
    eigen_interval: int = 1
    # Deferred covariance accumulation (requires eigen_interval > 1): C is
    # only USED at eigen refreshes, so instead of streaming the [n, n, B]
    # tensor twice per generation the per-generation rank-1/rank-mu
    # FACTORS (p_c [n, B], ytop [n, mu, B], the lane decay scalar) are
    # buffered and C is materialized once per refresh as
    #   C' = (prod a_i) C + sum_i (prod_{j>i} a_j)(c1 p_c p_c^T + cmu sum_l w_l y_l y_l^T)
    # — mathematically identical to the eager recurrence (f32 roundoff;
    # parity-tested), with per-generation HBM traffic dropping from
    # ~2 n^2 B to ~n (mu+1) B (whether that stream bounds the step on a
    # GPU is not measured).
    defer_covariance: bool = False


class CMAESFleetState(NamedTuple):
    mean: jax.Array        # [n, B]
    sigma: jax.Array       # [B]
    C: jax.Array           # [n, n, B]
    D: jax.Array           # [n, B]    sqrt-eigenvalues of C (possibly stale)
    Bv: jax.Array          # [n, n, B] eigenbasis of C (possibly stale)
    p_sigma: jax.Array     # [n, B]
    p_c: jax.Array         # [n, B]
    best_x: jax.Array      # [n, B]
    best_value: jax.Array  # [B]
    prev_best: jax.Array   # [B]
    iteration: jax.Array   # [B] int32
    nfev: jax.Array        # [B] int32
    no_change: jax.Array   # [B] int32
    gen: jax.Array         # () int32 fleet-global generation counter
    kicked: jax.Array      # () bool — a lane kicked last gen; force refresh
    a_buf: jax.Array       # [K, B] per-gen covariance decay (defer mode)
    pc_buf: jax.Array      # [K, n, B] per-gen evolution paths (defer mode)
    y_buf: jax.Array       # [K, n, mu, B] per-gen top-mu steps (defer mode)
    filled: jax.Array      # () int32 — buffered gens since last refresh
    key: jax.Array
    done: jax.Array        # [B] bool
    converged: jax.Array   # [B] bool


def _eigh_bm(C, config: CMAESFleetConfig):
    """Eigendecomposition of [n, n, B] by the configured backend; returns
    (eigvals [n, B], eigvecs [n, n, B]), unsorted (CMA-ES is order-free)."""
    if config.eigh_method == "jacobi":
        from ..linalg.jacobi import eigh_jacobi

        return eigh_jacobi(C, sweeps=config.sweeps, sort=False)
    if config.eigh_method == "xla":
        w, v = jnp.linalg.eigh(jnp.moveaxis(C, -1, 0))
        return jnp.moveaxis(w, 0, -1), jnp.moveaxis(v, 0, -1)
    raise ValueError(
        f"unknown eigh_method {config.eigh_method!r}; 'jacobi' or 'xla'"
    )


def _materialize(C, a_buf, pc_buf, y_buf, filled, c1, cmu, w, mu, K):
    """Apply the buffered covariance window in one pass (defer mode):
    C' = (prod_i a_i) C + sum_i (prod_{j>i} a_j) U_i with
    U_i = c1 pc_i pc_i^T + cmu sum_l w_l y_il y_il^T.  Slots >= ``filled``
    are masked (decay 1, contribution 0) so kick-forced partial windows
    materialize correctly."""
    dtype = C.dtype
    B = C.shape[-1]
    idx = jnp.arange(K)
    valid = idx < filled                                    # [K]
    a_m = jnp.where(valid[:, None], a_buf, jnp.ones_like(a_buf))
    suffix_incl = jnp.cumprod(a_m[::-1], axis=0)[::-1]      # [K, B]
    prod_all = suffix_incl[0]
    suffix_excl = jnp.concatenate(
        [suffix_incl[1:], jnp.ones((1, B), dtype)], axis=0
    )
    Cm = prod_all[None, None, :] * C
    for i in range(K):
        coeff = jnp.where(valid[i], suffix_excl[i], jnp.zeros_like(prod_all))
        pc = pc_buf[i]
        Cm = Cm + (coeff * c1) * (pc[:, None, :] * pc[None, :, :])
        for el in range(mu):
            yl = y_buf[i, :, el, :]
            Cm = Cm + (coeff * (cmu * w[el])) * (
                yl[:, None, :] * yl[None, :, :]
            )
    return (Cm + jnp.swapaxes(Cm, 0, 1)) * 0.5


def init(fn, X0: jax.Array, config: CMAESFleetConfig, key: jax.Array) -> CMAESFleetState:
    n, B = X0.shape
    dtype = X0.dtype
    f0 = colwise(fn)(X0)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype)[:, :, None], (n, n, B))
    if config.defer_covariance:
        if config.eigen_interval < 2:
            raise ValueError(
                "defer_covariance requires eigen_interval > 1 (the buffers "
                "amortize over the refresh window)"
            )
        K = config.eigen_interval
        _, mu = _params(n, config.pop_size)[:2]
    else:
        K, mu = 1, 1                       # dummy one-slot buffers
    return CMAESFleetState(
        mean=X0,
        sigma=jnp.full((B,), config.sigma0, dtype),
        C=eye,
        D=jnp.ones((n, B), dtype),
        Bv=eye,
        p_sigma=jnp.zeros((n, B), dtype),
        p_c=jnp.zeros((n, B), dtype),
        best_x=X0,
        best_value=f0,
        prev_best=jnp.full((B,), jnp.inf, dtype),
        iteration=jnp.zeros((B,), jnp.int32),
        nfev=jnp.ones((B,), jnp.int32),
        no_change=jnp.zeros((B,), jnp.int32),
        gen=jnp.int32(0),
        kicked=jnp.asarray(False),
        a_buf=jnp.ones((K, B), dtype),
        pc_buf=jnp.zeros((K, n, B), dtype),
        y_buf=jnp.zeros((K, n, mu, B), dtype),
        filled=jnp.int32(0),
        key=key,
        done=jnp.zeros((B,), bool),
        converged=jnp.zeros((B,), bool),
    )


def step(
    fn,
    state: CMAESFleetState,
    config: CMAESFleetConfig,
    bounds: Optional[Bounds] = None,
) -> CMAESFleetState:
    n, B = state.mean.shape
    dtype = state.mean.dtype
    lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n = _params(
        n, config.pop_size
    )
    w = jnp.asarray(weights, dtype)                        # [mu]

    if config.defer_covariance:
        # deferred-covariance lazy mode: C was last materialized at the
        # previous refresh; the buffers hold the window since.  Refresh
        # when the window is full (or a kick forces it): materialize,
        # then eigh.
        K = config.eigen_interval
        did_refresh = (state.filled >= K) | state.kicked

        def refresh(ops):
            C, a_buf, pc_buf, y_buf, filled = ops
            Cm = _materialize(
                C, a_buf, pc_buf, y_buf, filled, c1, cmu, w, mu, K
            )
            ev, Q = _eigh_bm(Cm, config)
            return Cm, jnp.sqrt(jnp.maximum(ev, 1e-20)), Q

        C_base, D, Bv = lax.cond(
            did_refresh,
            refresh,
            lambda ops: (ops[0], state.D, state.Bv),
            (state.C, state.a_buf, state.pc_buf, state.y_buf, state.filled),
        )
        filled0 = jnp.where(did_refresh, 0, state.filled)
    elif config.eigen_interval > 1:
        # lazy eigendecomposition: refresh B, D every eigen_interval
        # generations (scalar fleet-global pred -> real cond, the eigh is
        # skipped entirely on stale generations); C itself accumulates
        # every generation
        def refresh(C):
            ev, Q = _eigh_bm(C, config)
            return jnp.sqrt(jnp.maximum(ev, 1e-20)), Q

        D, Bv = lax.cond(
            (state.gen % config.eigen_interval == 0) | state.kicked,
            refresh,
            lambda C: (state.D, state.Bv),
            state.C,
        )
    else:
        ev, Bv = _eigh_bm(state.C, config)
        D = jnp.sqrt(jnp.maximum(ev, 1e-20))
    eigvals = D * D                                        # [n, B]
    cond = jnp.max(eigvals, axis=0) / jnp.min(eigvals, axis=0)

    improved = state.best_value < state.prev_best - config.f_tol
    no_change = jnp.where(improved, 0, state.no_change + 1)
    hit_tol = no_change >= config.best_value_no_change
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | (cond > config.cond_max)
        | (state.sigma < 1e-18)
    )
    halted = state._replace(
        no_change=no_change, done=jnp.ones_like(state.done), converged=hit_tol
    )

    key, k_z = jax.random.split(state.key)
    z = jax.random.normal(k_z, (n, lam, B), dtype)
    Dz = D[:, None, :] * z                                 # [n, lam, B]
    # y = B (D z): contraction over the small k axis unrolled into FMAs
    y = jnp.zeros((n, lam, B), dtype)
    for k in range(n):
        y = y + Bv[:, k, :][:, None, :] * Dz[k][None, :, :]
    xs = state.mean[:, None, :] + state.sigma[None, None, :] * y
    if bounds is not None:
        # bounds are "broadcastable against x" (core/objective.py) — accept
        # scalars and [n] alike
        lo = jnp.broadcast_to(jnp.asarray(bounds.lower, dtype), (n,)).reshape(n, 1, 1)
        hi = jnp.broadcast_to(jnp.asarray(bounds.upper, dtype), (n,)).reshape(n, 1, 1)
        xs = jnp.clip(xs, lo, hi)
        y = (xs - state.mean[:, None, :]) / state.sigma[None, None, :]
    values = colwise(fn)(xs.reshape(n, lam * B)).reshape(lam, B)

    order = jnp.argsort(values, axis=0)                    # [lam, B]
    order_mu = order[:mu]                                  # [mu, B]
    ytop = jnp.take_along_axis(y, order_mu[None, :, :], axis=1)   # [n, mu, B]
    y_w = jnp.sum(ytop * w[None, :, None], axis=1)         # [n, B]
    new_mean = state.mean + state.sigma[None, :] * y_w

    # C^{-1/2} y_w = B D^-1 B^T y_w
    t = jnp.sum(Bv * y_w[:, None, :], axis=0)              # [n, B] (B^T y_w)
    ci = jnp.sum(Bv * (t / D)[None, :, :], axis=1)         # [n, B]
    p_sigma = (1 - cs) * state.p_sigma + jnp.sqrt(cs * (2 - cs) * mu_eff) * ci
    ps_norm = jnp.sqrt(jnp.sum(p_sigma * p_sigma, axis=0))  # [B]
    sigma = state.sigma * jnp.exp((cs / damps) * (ps_norm / chi_n - 1))
    if config.kick_tol > 0:
        vbest = jnp.take_along_axis(values, order[:1], axis=0)[0]
        vmu = jnp.take_along_axis(values, order[mu - 1 : mu], axis=0)[0]
        collapsed = (jnp.abs(vbest - vmu) < config.kick_tol) & (
            no_change >= config.kick_patience
        )
        sigma = jnp.where(collapsed, sigma * jnp.exp(0.2 + cs / damps), sigma)
        any_kick = jnp.any(collapsed & ~done_now)
    else:
        any_kick = jnp.asarray(False)

    it1 = (state.iteration + 1).astype(dtype)
    hsig = (
        ps_norm / jnp.sqrt(1 - (1 - cs) ** (2 * it1)) / chi_n
    ) < (1.4 + 2 / (n + 1))
    p_c = (1 - cc) * state.p_c + hsig[None, :] * jnp.sqrt(
        cc * (2 - cc) * mu_eff
    ) * y_w
    delta_hsig = (1 - hsig.astype(dtype)) * cc * (2 - cc)
    if config.defer_covariance:
        # buffer this generation's factors instead of streaming [n, n, B]
        a_t = (1.0 - c1 - cmu) + c1 * delta_hsig           # [B]
        a_buf = lax.dynamic_update_index_in_dim(
            state.a_buf, a_t, filled0, axis=0
        )
        pc_buf = lax.dynamic_update_index_in_dim(
            state.pc_buf, p_c, filled0, axis=0
        )
        y_buf = lax.dynamic_update_index_in_dim(
            state.y_buf, ytop, filled0, axis=0
        )
        C = C_base
        new_filled = filled0 + 1
    else:
        rank1 = p_c[:, None, :] * p_c[None, :, :]          # [n, n, B]
        rank_mu = jnp.zeros((n, n, B), dtype)
        for l in range(mu):
            yl = ytop[:, l, :]
            rank_mu = rank_mu + w[l] * yl[:, None, :] * yl[None, :, :]
        C = (
            (1 - c1 - cmu) * state.C
            + c1 * (rank1 + delta_hsig[None, None, :] * state.C)
            + cmu * rank_mu
        )
        C = (C + jnp.swapaxes(C, 0, 1)) / 2
        a_buf, pc_buf, y_buf = state.a_buf, state.pc_buf, state.y_buf
        new_filled = state.filled

    gen_best = jnp.take_along_axis(values, order[:1], axis=0)[0]     # [B]
    x_gen = jnp.take_along_axis(xs, order[:1][None, :, :], axis=1)[:, 0, :]
    better = gen_best < state.best_value
    best_x = jnp.where(better[None, :], x_gen, state.best_x)
    best_value = jnp.where(better, gen_best, state.best_value)

    worked = CMAESFleetState(
        mean=new_mean,
        sigma=sigma,
        C=C,
        D=D,
        Bv=Bv,
        p_sigma=p_sigma,
        p_c=p_c,
        best_x=best_x,
        best_value=best_value,
        prev_best=state.best_value,
        iteration=state.iteration + 1,
        nfev=state.nfev + lam,
        no_change=no_change,
        gen=state.gen + 1,
        kicked=any_kick,
        a_buf=a_buf,
        pc_buf=pc_buf,
        y_buf=y_buf,
        filled=new_filled,
        key=key,
        done=jnp.zeros_like(state.done),
        converged=jnp.zeros_like(state.converged),
    )
    return _merge(done_now, halted, worked)


def _merge(pred, a: CMAESFleetState, b: CMAESFleetState) -> CMAESFleetState:
    """Per-lane select a-where-pred else b — except ``key`` and ``gen``,
    which are fleet-global (one draw / one counter covers all lanes) and
    always advance with ``b`` (typed PRNG keys also cannot pass through
    jnp.where)."""
    out = {}
    for f in CMAESFleetState._fields:
        if f in ("key", "gen", "kicked", "filled"):
            out[f] = getattr(b, f)
            continue
        av, bv = getattr(a, f), getattr(b, f)
        p = pred.reshape((1,) * (av.ndim - 1) + (-1,))
        out[f] = jnp.where(p, av, bv)
    return CMAESFleetState(**out)


def drive_fleet_scan(step_fn, state: CMAESFleetState, trips: int) -> CMAESFleetState:
    """Fixed-trip driver (lax.scan) for benchmarking: every run does
    identical work; finished lanes stay frozen via the fleet ``_merge``
    (the core ``drive_scan``'s tree_where assumes leading-batch layouts)."""

    def body(s, _):
        s2 = step_fn(s)
        return _merge(s.done, s, s2), None

    final, _ = lax.scan(body, state, None, length=trips)
    return final


def drive_fleet(step_fn, state: CMAESFleetState) -> CMAESFleetState:
    def body(s):
        s2 = step_fn(s)
        return _merge(s.done, s, s2)     # freeze finished lanes, advance key

    return lax.while_loop(lambda s: jnp.any(~s.done), body, state)


def minimize_fleet(
    fn,
    X0: jax.Array,                       # [n, B] batch-minor start points
    config: CMAESFleetConfig = CMAESFleetConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
):
    """Minimize B independent instances of ``fn`` ([n] -> scalar).

    Returns a SolverResult with per-lane fields; ``x`` stays [n, B]."""
    if key is None:
        key = jax.random.key(0)
    X0 = jnp.asarray(X0)
    if bounds is not None:
        n = X0.shape[0]
        lo = jnp.broadcast_to(jnp.asarray(bounds.lower, X0.dtype), (n,)).reshape(-1, 1)
        hi = jnp.broadcast_to(jnp.asarray(bounds.upper, X0.dtype), (n,)).reshape(-1, 1)
        X0 = jnp.clip(X0, lo, hi)
    state = init(fn, X0, config, key)
    state = drive_fleet(lambda s: step(fn, s, config, bounds), state)
    return make_result(
        x=state.best_x,
        f_value=state.best_value,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )
