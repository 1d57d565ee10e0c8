"""Smoke run of nlsolver_tpu's main path on one GPU.

    python chip_smoke.py               # every phase below, one card
    python chip_smoke.py --four-cards  # only the multi-device path, 4 cards

Each phase drives the public API (``minimize``, ``fit_fleet``, ``root``) at
the fleet sizes the repo's benches use, compares the card's answer with a
plain reference (scipy, known optima, the row engines, the same program on
the host CPU backend, float64 numpy, the native RNG oracles) and prints one
JSON line: its numbers, tolerances, precision, wall time and compile time.
A phase that fails raises, and the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}`` as JAX reports the
device.  Without a GPU the script exits non-zero before printing anything.

All data is made from ``--seed``.  The phase functions take their sizes as
an argument so the test suite can run each one at a tiny size on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL_ROOT_REL = 1e-6


class Sizes(NamedTuple):
    de_B: int
    de_dim: int
    de_pop: int
    de_gens: int
    de_cpu_lanes: int
    bfgs_B: int
    bfgs_n: int
    bfgs_row_lanes: int
    nlls_B: int
    nlls_m: int
    nlls_row_lanes: int
    cmaes_B: int
    cmaes_n: int
    cmaes_gens: int
    swarm_B: int
    swarm_dim: int
    swarm_cpu_lanes: int
    pso_iters: int
    sann_iters: int
    roots_B: int
    parity_pairs: int  # 0 = every golden pair
    four_B: int


# The fleet sizes of the repo's bench scenarios (nlsolver_tpu/benches).
FULL = Sizes(
    de_B=8192, de_dim=10, de_pop=64, de_gens=200, de_cpu_lanes=256,
    bfgs_B=65536, bfgs_n=16, bfgs_row_lanes=256,
    nlls_B=262144, nlls_m=32, nlls_row_lanes=1024,
    cmaes_B=4096, cmaes_n=16, cmaes_gens=50,
    swarm_B=2048, swarm_dim=100, swarm_cpu_lanes=64, pso_iters=200,
    sann_iters=1000,
    roots_B=2_000_000,
    parity_pairs=0,
    four_B=8192,
)
TINY = Sizes(
    de_B=64, de_dim=3, de_pop=8, de_gens=20, de_cpu_lanes=16,
    bfgs_B=64, bfgs_n=4, bfgs_row_lanes=16,
    nlls_B=256, nlls_m=8, nlls_row_lanes=32,
    cmaes_B=16, cmaes_n=4, cmaes_gens=5,
    swarm_B=32, swarm_dim=4, swarm_cpu_lanes=16, pso_iters=10, sann_iters=20,
    roots_B=1000,
    parity_pairs=3,
    four_B=64,
)


class PhaseFailed(AssertionError):
    pass


class float64:
    """Context in which JAX creates float64 arrays (restores the setting)."""

    def __enter__(self):
        import jax

        self.before = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax

        jax.config.update("jax_enable_x64", self.before)
        return False


ROOT_METHODS = (("brent", {"tol": 1e-7}), ("itp", {"tol": 1e-7, "eps": 1e-7}))


def check(cond, what: str) -> None:
    if not bool(cond):
        raise PhaseFailed(what)


class Runner:
    """AOT-compiles and runs jitted programs, keeping compile and run time
    apart; remembers every executable built for the default device.  Each
    program runs twice and the second, warm run is the one timed."""

    def __init__(self):
        self.compile_s = 0.0
        self.run_s = 0.0
        self.executables = []   # (name, compiled)

    def __call__(self, name, fn, *args):
        import jax

        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        self.compile_s += time.perf_counter() - t0
        out = jax.block_until_ready(compiled(*args))
        t1 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        t2 = time.perf_counter()
        self.run_s += t2 - t1
        self.executables.append((name, compiled))
        return out, t2 - t1


def on_cpu(tree):
    import jax

    return jax.device_put(tree, jax.devices("cpu")[0])


def ks_pvalue(a, b) -> float:
    from scipy import stats

    return float(stats.ks_2samp(np.asarray(a), np.asarray(b)).pvalue)


# --------------------------------------------------------------------------
# phases: each fills ``res`` with its numbers and raises on a failed check
# --------------------------------------------------------------------------


def phase_single(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """NM, BFGS and L-BFGS-B on 2-D Rosenbrock; Brent and ITP on x^3 - 2."""
    import jax.numpy as jnp
    from scipy import optimize

    import nlsolver_tpu
    from nlsolver_tpu.core import Bounds
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import bfgs, lbfgsb, nelder_mead

    rosen = PROBLEMS["rosenbrock"].fn
    x0 = jnp.asarray([-0.5, -0.5], jnp.float32)
    box = Bounds(jnp.full((2,), -2.0, jnp.float32), jnp.full((2,), 2.0, jnp.float32))
    np_rosen = lambda x: 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2
    cases = {
        "nelder_mead": (nelder_mead.NelderMeadConfig(eps=1e-12, max_iter=5000),
                        None, "Nelder-Mead"),
        "bfgs": (bfgs.BFGSConfig(grad_eps=1e-6, max_iter=1000), None, "BFGS"),
        "lbfgsb": (lbfgsb.LBFGSBConfig(max_iter=1000), box, "L-BFGS-B"),
    }
    res["tolerance"] = {"x_abs_vs_scipy": 1e-3, "root_rel": TOL_ROOT_REL}
    for name, (cfg, bounds, sp_method) in cases.items():
        out, _ = run(name, lambda x, cfg=cfg, b=bounds: nlsolver_tpu.minimize(
            rosen, x, name, cfg, bounds=b), x0)
        sp = optimize.minimize(
            np_rosen, np.asarray([-0.5, -0.5]), method=sp_method,
            bounds=[(-2, 2)] * 2 if bounds is not None else None,
            options={"xatol": 1e-10, "fatol": 1e-14} if sp_method == "Nelder-Mead"
            else {"gtol": 1e-10} if sp_method == "BFGS" else {"ftol": 1e-15, "gtol": 1e-12},
        )
        dx = float(np.max(np.abs(np.asarray(out.x, np.float64) - sp.x)))
        res[f"{name}_dx_vs_scipy"] = dx
        res[f"{name}_iterations"] = int(out.iterations)
        check(dx <= 1e-3, f"{name}: |x - x_scipy| = {dx:.3g} > 1e-3")

    cube = lambda x: x * x * x - 2.0
    ref = optimize.brentq(lambda x: x ** 3 - 2.0, 0.0, 2.0, xtol=1e-15)
    for method, kw in ROOT_METHODS:
        out, _ = run(f"root_{method}", lambda a, b, m=method, kw=kw:
                     nlsolver_tpu.root(cube, a, b, method=m, **kw),
                     jnp.float32(0.0), jnp.float32(2.0))
        rel = abs(float(out.x) - ref) / ref
        res[f"root_{method}_rel_err"] = rel
        check(rel <= TOL_ROOT_REL, f"root {method}: rel err {rel:.3g}")


def phase_de_fleet(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Lane-axis DE on Rastrigin, both partner samplings, against the same
    program on the host CPU backend for the first lanes."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import de, de_batched

    fn = PROBLEMS["rastrigin"].fn
    B, n, lanes = sz.de_B, sz.de_dim, sz.de_cpu_lanes
    # starts inside the global basin, so the run measures how far each
    # engine converges in de_gens generations (TF32-rounded donors would
    # stall it); success = f < 1e-3
    x0 = jnp.full((B, n), 0.5, jnp.float32)
    keys = jax.random.split(jax.random.key(seed), B)
    res["tolerance"] = {"success_fraction_abs": 0.05, "ks_pvalue_min": 1e-3}
    for sampling in ("uniform", "rotation"):
        cfg = de.DEConfig(pop_size=sz.de_pop, max_iter=sz.de_gens,
                          best_value_no_change=1 << 30, eps=0.0,
                          partner_sampling=sampling)
        solve = lambda x, k, cfg=cfg: nlsolver_tpu.minimize(
            fn, x, "de", cfg, layout="batched", keys=k)
        dev, secs = run(f"de_{sampling}", solve, x0, keys)
        cpu = jax.jit(solve)(*on_cpu((x0[:lanes], keys[:lanes])))
        init_best = jnp.min(de_batched.init(fn, x0, cfg, keys).scores, axis=1)
        f_dev, f_cpu = np.asarray(dev.f_value), np.asarray(cpu.f_value)
        frac_dev = float(np.mean(f_dev < 1e-3))
        frac_dev_first = float(np.mean(f_dev[:lanes] < 1e-3))
        frac_cpu = float(np.mean(f_cpu < 1e-3))
        p = ks_pvalue(f_dev, f_cpu)
        res[sampling] = {
            "success_fraction": frac_dev,
            "success_fraction_first_lanes": frac_dev_first,
            "success_fraction_cpu": frac_cpu,
            "median_best": float(np.median(f_dev)),
            "median_best_cpu": float(np.median(f_cpu)),
            "ks_pvalue_vs_cpu": p,
            "instance_generations_per_s": B * sz.de_gens / secs,
        }
        check(np.all(np.isfinite(f_dev)) and np.all(np.isfinite(np.asarray(dev.x))),
              f"{sampling}: non-finite results")
        check(np.all(f_dev <= np.asarray(init_best)),
              f"{sampling}: a lane ended worse than its initial best")
        check(abs(frac_dev_first - frac_cpu) <= 0.05,
              f"{sampling}: success fraction {frac_dev_first} vs CPU {frac_cpu}")
        check(p >= 1e-3, f"{sampling}: final-best distribution differs from "
              f"the CPU's (KS p = {p:.3g})")


def _quadratic_fleet(n, B, seed):
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.key(seed))
    centers = jax.random.normal(k1, (n, B), jnp.float32)
    scales = jax.random.uniform(k2, (n, B), jnp.float32, 0.5, 3.0)
    return centers, scales


def phase_bfgs_fleet(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Batch-minor BFGS fleet on convex quadratics with known minima."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu
    from nlsolver_tpu.solvers import bfgs, bfgs_fleet

    n, B, lanes = sz.bfgs_n, sz.bfgs_B, sz.bfgs_row_lanes
    centers, scales = _quadratic_fleet(n, B, seed)
    X0 = jnp.zeros((n, B), jnp.float32)
    cfg = bfgs_fleet.BFGSFleetConfig(max_iter=100, grad_eps=1e-6)

    def solve(X0, c, s):
        fn_cols = lambda X: jnp.sum(s * (X - c) ** 2, axis=0)
        return nlsolver_tpu.minimize(None, X0, "bfgs", cfg, layout="fleet",
                                     fn_cols=fn_cols)

    out, secs = run("bfgs_fleet", solve, X0, centers, scales)
    row_cfg = bfgs.BFGSConfig(max_iter=100, grad_eps=1e-6)

    def row(c, s):
        fn = lambda x: jnp.sum(s * (x - c) ** 2)
        return nlsolver_tpu.minimize(fn, jnp.zeros((n,), jnp.float32), "bfgs", row_cfg)

    ref, _ = run("bfgs_row", lambda c, s: jax.vmap(row)(c, s),
                 centers[:, :lanes].T, scales[:, :lanes].T)
    x = np.asarray(out.x)
    err_opt = float(np.max(np.abs(x - np.asarray(centers))))
    err_row = float(np.max(np.abs(x[:, :lanes] - np.asarray(ref.x).T)))
    res.update({
        "tolerance": {"x_abs_vs_optimum": 1e-4, "x_abs_vs_row_engine": 1e-5},
        "max_abs_err_vs_optimum": err_opt,
        "max_abs_err_vs_row_engine": err_row,
        "max_iterations": int(jnp.max(out.iterations)),
        "inverse_hessian_bytes": n * n * B * 4,
        "instances_per_s": B / secs,
    })
    check(err_opt <= 1e-4, f"|x - x*| = {err_opt:.3g} > 1e-4")
    check(err_row <= 1e-5, f"|x - x_row| = {err_row:.3g} > 1e-5")


def phase_nlls_fleet(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Exp-decay curve fits through ``fit_fleet``, Cholesky and QR solves."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu

    B, m, lanes = sz.nlls_B, sz.nlls_m, sz.nlls_row_lanes
    t = jnp.linspace(0.0, 2.0, m, dtype=jnp.float32)
    k1, k2 = jax.random.split(jax.random.key(seed))
    amps = jax.random.uniform(k1, (B,), jnp.float32, 1.0, 3.0)
    rates = jax.random.uniform(k2, (B,), jnp.float32, 0.5, 2.0)
    ys = amps[:, None] * jnp.exp(-rates[:, None] * t[None, :])
    truth = np.stack([np.asarray(amps), np.asarray(rates)])

    def residual(p, y):
        return p[0] * jnp.exp(-p[1] * t) - y

    ref, _ = run("nlls_row", lambda ys: nlsolver_tpu.fit_batched(
        residual, jnp.ones((lanes, 2), jnp.float32), nlsolver_tpu.NLLSConfig(),
        data=ys), ys[:lanes])
    res["tolerance"] = {"frac_within_1e-3_rel_of_truth_min": 0.99,
                        "x_abs_vs_row_engine": 1e-4}
    for solve in ("cholesky", "qr"):
        cfg = nlsolver_tpu.NLLSFleetConfig(solve=solve)
        out, secs = run(f"nlls_{solve}", lambda ys, cfg=cfg: nlsolver_tpu.fit_fleet(
            residual, jnp.ones((2, B), jnp.float32), cfg, data=ys), ys)
        x = np.asarray(out.x)
        rel = np.max(np.abs(x - truth) / np.abs(truth), axis=0)
        frac = float(np.mean(rel <= 1e-3))
        err_row = float(np.max(np.abs(x[:, :lanes] - np.asarray(ref.x).T)))
        res[solve] = {"frac_within_1e-3_rel": frac,
                      "max_abs_err_vs_row_engine": err_row,
                      "fits_per_s": B / secs}
        check(frac >= 0.99, f"{solve}: only {frac:.4f} of fits within 1e-3")
        check(err_row <= 1e-4, f"{solve}: |x - x_row| = {err_row:.3g}")


def phase_cmaes_fleet(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """CMA-ES fleet with the jnp Jacobi and XLA's batched eigh: time per
    generation, the eigendecomposition's share of it, and the accuracy of
    both against float64 numpy on the fleet's own covariances."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    import nlsolver_tpu
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import cmaes_fleet

    fn = PROBLEMS["rastrigin"].fn
    n, B, G = sz.cmaes_n, sz.cmaes_B, sz.cmaes_gens
    X0 = jnp.full((n, B), 2.0, jnp.float32)
    key = jax.random.key(seed)
    res["tolerance"] = {"reconstruction_rel": 1e-5, "eigenvalues_rel": 1e-5}
    for method in ("jacobi", "xla"):
        cfg = cmaes_fleet.CMAESFleetConfig(
            max_iter=G, best_value_no_change=1 << 30, f_tol=0.0, kick_tol=0.0,
            cond_max=float("inf"), eigh_method=method)
        out, _ = run(f"cmaes_{method}", lambda X, k, cfg=cfg: nlsolver_tpu.minimize(
            fn, X, "cmaes", cfg, layout="fleet", key=k), X0, key)
        check(np.all(np.isfinite(np.asarray(out.f_value))), f"{method}: non-finite")

        # lanes may stop early (sigma collapse), so time G fixed generations
        def generations(X, k, cfg=cfg):
            s = cmaes_fleet.init(fn, X, cfg, k)
            return cmaes_fleet.drive_fleet_scan(
                lambda st: cmaes_fleet.step(fn, st, cfg), s, G).C

        C, secs = run(f"cmaes_{method}_fixed_generations", generations, X0, key)
        (w, V), _ = run(f"eigh_{method}",
                        lambda C, cfg=cfg: cmaes_fleet._eigh_bm(C, cfg), C)

        # G dependent decompositions in one program, as inside the fleet's
        # generation loop (one decomposition alone pays launch costs the
        # loop does not)
        def chain(C, cfg=cfg):
            def body(C, _):
                w, _ = cmaes_fleet._eigh_bm(C, cfg)
                return C + 1e-7 * jnp.max(w) * jnp.eye(n, dtype=C.dtype)[..., None], None
            return lax.scan(body, C, None, length=G)[0]

        _, eigh_secs = run(f"eigh_{method}_x{G}", chain, C)
        eigh_secs /= G
        recon = jnp.einsum("ik...,k...,jk...->ij...", V, w, V,
                           precision=lax.Precision.HIGHEST)
        rec_err = float(jnp.max(jnp.abs(recon - C)) / jnp.max(jnp.abs(C)))
        C64 = np.moveaxis(np.asarray(C, np.float64), -1, 0)
        w64 = np.linalg.eigh(C64)[0]
        w_dev = np.sort(np.moveaxis(np.asarray(w, np.float64), -1, 0), axis=1)
        w_err = float(np.max(np.abs(w_dev - w64)) / np.max(np.abs(w64)))
        gen_ms = 1e3 * secs / G
        res[method] = {
            "api_generations_max": int(np.max(np.asarray(out.iterations))),
            "ms_per_generation": gen_ms,
            "eigh_ms": 1e3 * eigh_secs,
            "eigh_share_of_generation": 1e3 * eigh_secs / gen_ms,
            "reconstruction_rel_err": rec_err,
            "eigenvalues_rel_err_vs_f64": w_err,
        }
        check(rec_err <= 1e-5, f"{method}: reconstruction {rec_err:.3g}")
        check(w_err <= 1e-5, f"{method}: eigenvalues {w_err:.3g}")


def phase_pso_sann(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """PSO and SANN lane fleets on 100-D Rastrigin against the host CPU
    backend on the first lanes (same keys).

    Lanes are independent given their keys, and rounding differences make
    the card's and the CPU's lanes independent draws from one
    distribution of final best values.  The check is a two-sample
    Kolmogorov-Smirnov test at p >= 1e-3: it fails in one run in a
    thousand when nothing is wrong, and fails whenever the card's engine
    converges to a visibly different level (for example with rounded
    products)."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import pso, sann

    fn = PROBLEMS["rastrigin"].fn
    B, n, lanes = sz.swarm_B, sz.swarm_dim, sz.swarm_cpu_lanes
    # the bench scenario's start: every coordinate on a Rastrigin ridge
    x0 = jnp.full((B, n), -0.5, jnp.float32)
    keys = jax.random.split(jax.random.key(seed), B)
    start = float(fn(x0[0]))
    res["tolerance"] = {"ks_pvalue_min": 1e-3}
    configs = {
        "pso": pso.PSOConfig(n_particles=32, max_iter=sz.pso_iters,
                             best_value_no_change=1 << 30, eps=0.0),
        "sann": sann.SANNConfig(max_iter=sz.sann_iters),
    }
    for method, cfg in configs.items():
        solve = lambda x, k, m=method, cfg=cfg: nlsolver_tpu.minimize(
            fn, x, m, cfg, layout="batched", keys=k)
        dev, secs = run(method, solve, x0, keys)
        cpu = jax.jit(solve)(*on_cpu((x0[:lanes], keys[:lanes])))
        f_dev, f_cpu = np.asarray(dev.f_value), np.asarray(cpu.f_value)
        p = ks_pvalue(f_dev, f_cpu)
        res[method] = {"median_best": float(np.median(f_dev)),
                       "median_best_cpu": float(np.median(f_cpu)),
                       "start_value": start, "ks_pvalue_vs_cpu": p,
                       "instance_iterations_per_s":
                           B * float(np.mean(np.asarray(dev.iterations))) / secs}
        check(np.all(np.isfinite(f_dev)), f"{method}: non-finite results")
        check(np.all(f_dev <= start), f"{method}: a lane ended above its start")
        check(p >= 1e-3, f"{method}: KS p = {p:.3g} against the CPU")


def phase_roots(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Brent and ITP over a batch of brackets of x^3 - c, closed-form roots."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu

    B = sz.roots_B
    cs = jnp.linspace(0.1, 7.9, B, dtype=jnp.float32)
    exact = np.cbrt(np.asarray(cs, np.float64))
    lo, hi = jnp.float32(0.0), jnp.float32(2.0)
    res["tolerance"] = {"rel": TOL_ROOT_REL}
    for method, kw in ROOT_METHODS:
        def solve(cs, m=method, kw=kw):
            return jax.vmap(lambda c: nlsolver_tpu.root(
                lambda x: x * x * x - c, lo, hi, method=m, **kw).x)(cs)

        x, secs = run(f"roots_{method}", solve, cs)
        rel = float(np.max(np.abs(np.asarray(x, np.float64) - exact) / exact))
        res[method] = {"max_rel_err": rel, "roots_per_s": B / secs}
        check(rel <= TOL_ROOT_REL, f"{method}: rel err {rel:.3g}")


def phase_parity(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """float64: the reference RNG re-creations against the native oracles
    (bit-exact), and the golden trajectories of the reference binary
    (reports how many pairs stay at dx == 0)."""
    with float64():
        _parity(sz, res, run)


def _parity(sz: Sizes, res: dict, run: Runner) -> None:
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_reference_rngs import TestMT19937
    from test_trajectory_parity import DX_TOL
    from trajectory_common import compare_pair, load_golden

    from nlsolver_tpu import native
    from nlsolver_tpu.random import mt19937, reference_rngs as rr

    check(native.available(), "native RNG oracles could not be built")
    N = 4096 if sz.parity_pairs == 0 else 256
    streams = {}
    for kind in ("splitmix", "xoshiro", "xorshift", "halton", "recurrent"):
        state, nxt = rr.make(kind, dtype=jnp.float64)
        (us, _), _ = run(f"rng_{kind}", lambda s, nxt=nxt: rr.sample(s, nxt, N),
                         state)
        ref = getattr(native, f"{kind}_seq")(N)
        streams[kind] = bool(np.array_equal(np.asarray(us, np.float64), ref))
    from jax import lax

    def mt_stream(s):
        return lax.scan(lambda s, _: mt19937.next_canonical(s)[::-1], s, None,
                        length=8)[1]

    us, _ = run("rng_mt19937", mt_stream, mt19937.init(42))
    streams["mt19937"] = [float(v) for v in us] == TestMT19937.U
    res["rng_streams_bit_exact"] = streams
    res["rng_draws_per_stream"] = N
    check(all(streams.values()), f"RNG streams not bit-exact: {streams}")

    golden = load_golden()
    pairs = sorted(DX_TOL)
    if sz.parity_pairs:
        pairs = pairs[:sz.parity_pairs]
    exact, per_pair, counter_mismatch = 0, {}, []
    t0 = time.perf_counter()
    for solver, problem in pairs:
        rows = golden[(solver, problem)]
        if solver.startswith("root_") or solver in ("gd_anneal", "brent_min"):
            # these re-run (and re-compile) once per prefix length k:
            # check the first, middle and last prefix only
            rows = [rows[0], rows[len(rows) // 2], rows[-1]]
        per_k = compare_pair(solver, problem, rows)
        dx = max(r["dx"] for r in per_k)
        exact += dx == 0.0
        if not all(r["iters_match"] for r in per_k):
            counter_mismatch.append(f"{solver}/{problem}")
        per_pair[f"{solver}/{problem}"] = dx
    run.compile_s += time.perf_counter() - t0   # jit-and-run, not split
    res["golden_pairs"] = len(pairs)
    res["golden_pairs_dx_zero"] = exact
    res["golden_pairs_dx_zero_on_cpu"] = sum(
        1 for p in pairs if DX_TOL[p][0] == 0.0)
    res["golden_pairs_iteration_counter_mismatch"] = counter_mismatch
    res["golden_max_dx"] = per_pair


def phase_memory(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Compiled memory of the largest program so far, and the peak bytes
    the device allocator has handed out in this process."""
    import jax

    def total(c):
        m = c.memory_analysis()
        if m is None:
            return 0
        return (m.argument_size_in_bytes + m.output_size_in_bytes
                + m.temp_size_in_bytes)

    check(run.executables, "no program was compiled before the memory phase")
    name, compiled = max(run.executables, key=lambda e: total(e[1]))
    m = compiled.memory_analysis()
    res["largest_program"] = name
    if m is not None:
        res["largest_program_bytes"] = {
            "argument": m.argument_size_in_bytes,
            "output": m.output_size_in_bytes,
            "temp": m.temp_size_in_bytes,
            "generated_code": m.generated_code_size_in_bytes,
        }
    stats = jax.devices()[0].memory_stats()
    res["peak_bytes_in_use"] = None if stats is None else stats["peak_bytes_in_use"]
    res["bytes_limit"] = None if stats is None else stats["bytes_limit"]


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """The tests marked ``gpu``, in this process (the card is already
    this process's)."""
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[outcomes])
    res.update(outcomes.counts)
    res["pytest_exit_code"] = int(rc)
    check(rc == 0 and outcomes.counts["passed"] > 0
          and outcomes.counts["skipped"] == 0, f"gpu tests: {outcomes.counts}")


PHASES = {
    "single": phase_single,
    "de_fleet": phase_de_fleet,
    "bfgs_fleet": phase_bfgs_fleet,
    "nlls_fleet": phase_nlls_fleet,
    "cmaes_fleet": phase_cmaes_fleet,
    "pso_sann": phase_pso_sann,
    "roots": phase_roots,
    "parity": phase_parity,
    "memory": phase_memory,
    "gpu_tests": phase_gpu_tests,
}



# --------------------------------------------------------------------------
# --four-cards: the multi-device path only
# --------------------------------------------------------------------------


def require_four():
    import jax

    n = len(jax.devices())
    if n < 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX sees {n}")


def _spans(x, n: int) -> bool:
    return len(x.sharding.device_set) == n


def _compare(res, name, multi, single, how: str):
    """Record how far a multi-device result is from its reference and hold
    it to ``how``: "bitwise"; "1e-5" (max abs difference, for fleets that
    converge to one optimum); or "ks" (final values of stochastic fleets:
    per-device shapes change the order of floating-point sums on a GPU,
    a last-bit difference flips a greedy selection, and the lanes then
    follow other but equally distributed paths — two-sample KS test at
    p >= 1e-3)."""
    a, b = np.asarray(multi, np.float64), np.asarray(single, np.float64)
    diff = float(np.max(np.abs(a - b)))
    same = bool(np.array_equal(a, b))
    res[name] = {"bitwise_equal": same, "max_abs_diff": diff}
    if how == "bitwise":
        check(same, f"{name}: not bitwise equal (max abs diff {diff:.3g})")
    elif how == "1e-5":
        check(diff <= 1e-5, f"{name}: max abs diff {diff:.3g} > 1e-5")
    else:
        p = ks_pvalue(a.ravel(), b.ravel())
        res[name]["ks_pvalue"] = p
        check(p >= 1e-3, f"{name}: KS p = {p:.3g}")


def phase_four_de(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Population-sharded DE on (dp, pop) = (2, 2) and (4, 1) and the
    one-card mesh; fused island DE on four cards against two.

    With the max-norm objective every step is elementwise or an
    order-free max, so the layouts must agree bitwise: the per-agent RNG
    is layout-invariant.  With Rastrigin the per-device shapes change the
    order of the objective's sum, so the layouts agree in distribution."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu
    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import de

    objectives = {"maxnorm": lambda x: jnp.max(jnp.abs(x - 0.25)),
                  "rastrigin": PROBLEMS["rastrigin"].fn}
    B = max(sz.four_B // 16, 8)
    x0 = jnp.full((B, 10), 0.5, jnp.float32)
    keys = jax.random.split(jax.random.key(seed), B)
    cfg = de.DEConfig(pop_size=64, max_iter=100, best_value_no_change=1 << 30,
                      eps=0.0)
    for oname, fn in objectives.items():
        out = {}
        for dp, pop, ndev in ((2, 2, 4), (4, 1, 4), (1, 1, 1)):
            mesh = make_mesh(ndev, dp=dp, pop=pop)
            r, _ = run(f"de_sharded_{oname}_{dp}x{pop}", lambda x, k, mesh=mesh, fn=fn:
                       nlsolver_tpu.minimize(fn, x, "de", cfg, layout="sharded",
                                             mesh=mesh, keys=k), x0, keys)
            out[(dp, pop)] = r
        check(_spans(out[(2, 2)].x, 4) and _spans(out[(4, 1)].x, 4),
              "sharded DE result does not span four devices")
        how = "bitwise" if oname == "maxnorm" else "ks"
        _compare(res, f"de_sharded_{oname}_2x2_vs_4x1",
                 out[(2, 2)].x if how == "bitwise" else out[(2, 2)].f_value,
                 out[(4, 1)].x if how == "bitwise" else out[(4, 1)].f_value, how)
        _compare(res, f"de_sharded_{oname}_2x2_vs_one_card",
                 out[(2, 2)].x if how == "bitwise" else out[(2, 2)].f_value,
                 out[(1, 1)].x if how == "bitwise" else out[(1, 1)].f_value, how)

    isl = {}
    for dp, ndev in ((2, 4), (1, 2)):
        mesh = make_mesh(ndev, dp=dp, pop=2)
        r, _ = run(f"de_islands_{dp}x2", lambda x, k, mesh=mesh:
                   nlsolver_tpu.minimize(objectives["maxnorm"], x, "de", cfg,
                                         layout="islands", mesh=mesh, keys=k,
                                         fused=True), x0, keys)
        isl[dp] = r
    check(_spans(isl[2].x, 4), "island DE result does not span four devices")
    _compare(res, "de_islands_maxnorm_four_vs_two_cards", isl[2].x, isl[1].x,
             "bitwise")


def phase_four_fleets(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Lane-sharded BFGS, NLLS, PSO, SANN and CMA-ES fleets over four
    cards, each against the same fleet on one card."""
    import jax
    import jax.numpy as jnp

    import nlsolver_tpu
    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import (bfgs_fleet, cmaes_fleet, nlls_fleet, pso,
                                      sann)

    B = sz.four_B
    mesh4 = make_mesh(4, dp=2, pop=2)
    one = make_mesh(1, dp=1, pop=1)
    rastrigin = PROBLEMS["rastrigin"].fn

    centers, scales = _quadratic_fleet(16, B, seed)
    bcfg = bfgs_fleet.BFGSFleetConfig(max_iter=100, grad_eps=1e-6)
    fn_cols = lambda X: jnp.sum((X - 1.5) ** 2 * jnp.arange(1, 17,
                                dtype=X.dtype)[:, None], axis=0)
    X0 = centers
    got = {}
    for tag, mesh in (("four", mesh4), ("one", one)):
        r, _ = run(f"bfgs_fleet_{tag}", lambda X, mesh=mesh: nlsolver_tpu.minimize(
            None, X, "bfgs", bcfg, layout="sharded", mesh=mesh, fn_cols=fn_cols), X0)
        got[tag] = r
    check(_spans(got["four"].x, 4), "BFGS fleet does not span four devices")
    _compare(res, "bfgs_fleet", got["four"].x, got["one"].x, "1e-5")

    m = 32
    t = jnp.linspace(0.0, 2.0, m, dtype=jnp.float32)
    amps = 1.0 + 2.0 * (scales[0] - 0.5) / 2.5
    rates = 0.5 + 1.5 * (scales[1] - 0.5) / 2.5
    ys = amps[:, None] * jnp.exp(-rates[:, None] * t[None, :])
    residual = lambda p, y: p[0] * jnp.exp(-p[1] * t) - y
    ncfg = nlls_fleet.NLLSFleetConfig()
    for tag, mesh in (("four", mesh4), ("one", one)):
        r, _ = run(f"nlls_fleet_{tag}", lambda X, ys, mesh=mesh:
                   nlsolver_tpu.fit_fleet_sharded(residual, X, ncfg, mesh, data=ys),
                   jnp.ones((2, B), jnp.float32), ys)
        got[tag] = r
    check(_spans(got["four"].x, 4), "NLLS fleet does not span four devices")
    _compare(res, "nlls_fleet", got["four"].x, got["one"].x, "1e-5")

    keys = jax.random.split(jax.random.key(seed), B)
    x0 = jnp.full((B, 16), 5.12, jnp.float32)
    swarms = {
        "pso_fleet": ("pso_batched", pso.PSOConfig(
            n_particles=16, max_iter=100, best_value_no_change=1 << 30, eps=0.0)),
        "sann_fleet": ("sann", sann.SANNConfig(max_iter=300)),
    }
    for name, (method, cfg) in swarms.items():
        for tag, mesh in (("four", mesh4), ("one", one)):
            r, _ = run(f"{name}_{tag}", lambda x, k, mesh=mesh, method=method, cfg=cfg:
                       nlsolver_tpu.minimize(rastrigin, x, method, cfg,
                                             layout="sharded", mesh=mesh, keys=k),
                       x0, keys)
            got[tag] = r
        check(_spans(got["four"].x, 4), f"{name} does not span four devices")
        _compare(res, name, got["four"].f_value, got["one"].f_value, "ks")

    ccfg = cmaes_fleet.CMAESFleetConfig(max_iter=50, best_value_no_change=1 << 30)
    X0c = jnp.full((16, B), 2.0, jnp.float32)
    for tag, mesh in (("four", mesh4), ("one", one)):
        r, _ = run(f"cmaes_fleet_{tag}", lambda X, k, mesh=mesh: nlsolver_tpu.minimize(
            rastrigin, X, "cmaes", ccfg, layout="sharded", mesh=mesh, key=k),
            X0c, jax.random.key(seed))
        got[tag] = r
    check(_spans(got["four"].x, 4), "CMA-ES fleet does not span four devices")
    _compare(res, "cmaes_fleet", got["four"].f_value, got["one"].f_value, "ks")


def phase_four_lbfgs(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Dimension-sharded L-BFGS over four cards against single-device
    L-BFGS on the same coupled quadratic (<= 1e-5)."""
    import jax.numpy as jnp
    from jax import lax

    import nlsolver_tpu
    from nlsolver_tpu.parallel import make_mesh

    n = sz.four_B * 16
    mesh = make_mesh(4, dp=1, pop=4)
    targets = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    w = jnp.linspace(1.0, 4.0, n, dtype=jnp.float32)
    loc = n // 4

    def shard(v):
        return lax.dynamic_slice(v, (lax.axis_index("pop") * loc,), (loc,))

    # f(x) = sum w (x - t)^2 + mean(x)^2: the mean couples every shard
    def fn_local(x):
        mean = lax.psum(jnp.sum(x), "pop") / n
        return jnp.sum(shard(w) * (x - shard(targets)) ** 2) + jnp.where(
            lax.axis_index("pop") == 0, mean ** 2, 0.0)

    def grad_local(x):
        mean = lax.psum(jnp.sum(x), "pop") / n
        return 2.0 * shard(w) * (x - shard(targets)) + 2.0 * mean / n

    def fn_global(x):
        return jnp.sum(w * (x - targets) ** 2) + jnp.mean(x) ** 2

    x0 = jnp.zeros((n,), jnp.float32)
    multi, _ = run("lbfgs_dim_sharded", lambda x: nlsolver_tpu.minimize(
        fn_local, x, "lbfgs", layout="sharded", mesh=mesh,
        grad_local=grad_local), x0)
    single, _ = run("lbfgs_single", lambda x: nlsolver_tpu.minimize(
        fn_global, x, "lbfgs"), x0)
    check(_spans(multi.x, 4), "dimension-sharded L-BFGS does not span four devices")
    diff = float(jnp.max(jnp.abs(multi.x - single.x)))
    res["lbfgs_dim"] = n
    res["lbfgs_max_abs_diff_vs_single"] = diff
    check(diff <= 1e-5, f"dimension-sharded L-BFGS differs by {diff:.3g}")


def phase_four_memory(sz: Sizes, res: dict, run: Runner, seed: int) -> None:
    """Every one of the four devices held data in this run."""
    import jax

    peaks = []
    for d in jax.devices()[:4]:
        stats = d.memory_stats()
        peaks.append(None if stats is None else stats["peak_bytes_in_use"])
    res["peak_bytes_in_use_per_device"] = peaks
    check(all(p is None or p > 0 for p in peaks),
          f"a device held nothing: {peaks}")


FOUR_PHASES = {
    "four_de": phase_four_de,
    "four_fleets": phase_four_fleets,
    "four_lbfgs": phase_four_lbfgs,
    "four_memory": phase_four_memory,
}

def run_phase(name, fn, sz, run, seed, precision="float32"):
    """Run one phase and print its JSON line; a failure is printed with
    its numbers so far and raised again."""
    res = {"phase": name, "precision": precision}
    before = (run.compile_s, run.run_s)
    t0 = time.perf_counter()
    try:
        fn(sz, res, run, seed)
    except BaseException as e:
        res.update(ok=False, error=f"{type(e).__name__}: {e}")
        print(json.dumps(res), flush=True)
        raise
    res.update(
        ok=True,
        wall_s=time.perf_counter() - t0,
        compile_s=run.compile_s - before[0],
        run_s=run.run_s - before[1],
    )
    print(json.dumps(res), flush=True)
    return res


def env_phase() -> dict:
    import jax

    from nlsolver_tpu.utils.compile_cache import enable_compile_cache
    from nlsolver_tpu.utils.device import (card_name_and_power_limit,
                                           describe, require_gpu)

    require_gpu()
    cache = enable_compile_cache()
    card = card_name_and_power_limit()
    print(card, flush=True)
    res = {"phase": "env", **describe(), "jax": jax.__version__,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "compile_cache_dir": cache, "nvidia_smi": card, "ok": True}
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from nlsolver_tpu.utils.device import describe

    env_phase()
    run = Runner()
    if args.four_cards:
        require_four()
        for name, fn in FOUR_PHASES.items():
            run_phase(name, fn, FULL, run, args.seed)
    else:
        for name, fn in PHASES.items():
            precision = "float64" if name == "parity" else "float32"
            run_phase(name, fn, FULL, run, args.seed, precision)
    print(json.dumps({"ok": True, "device": describe()}), flush=True)


if __name__ == "__main__":
    main()
