"""Benchmark scenarios for the BASELINE.json configs.

Each scenario returns a dict with a throughput metric and context; the
repo-root ``bench.py`` prints the headline (batched DE) as one JSON line
and can run the full suite with ``--all``.

Methodology: median-of-runs, each run ending in ``block_until_ready``;
fixed-trip scan driver so every run does identical work.  Percent-of-peak
figures divide by the card's data-sheet rates in ``PEAKS``.
"""
from __future__ import annotations

import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.driver import drive_scan
from ..problems import PROBLEMS
from ..solvers import bfgs, de, nelder_mead, pso, rootfind, sann
from ..solvers import nlls as nlls_mod


# Data-sheet peaks per device kind (``jax.devices()[0].device_kind``).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense rates
# without sparsity, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0,
        "fp32_tflops": 67.0,        # outside the tensor cores
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "hbm_gb": 80.0,
        "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense)",
    },
}


def peaks(device_kind: str) -> dict:
    """Data-sheet peaks of ``device_kind``; a kind not in ``PEAKS`` is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates recorded for device kind {device_kind!r}; "
            f"known kinds: {sorted(PEAKS)}"
        ) from None


def _timed(run, runs=5, warmup=2):
    for _ in range(warmup):
        jax.block_until_ready(run())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times)


def bench_nm_rosenbrock(runs=5, chain=64):
    """Config #1: single-instance NM on Rosenbrock (README example).

    A lone solve is dominated by dispatch, so the measured unit is a chain
    of ``chain`` dependent solves inside one program (each restarted from
    a perturbation of the previous solution) — device latency per solve."""
    from jax import lax

    p = PROBLEMS["rosenbrock"]
    cfg = nelder_mead.NelderMeadConfig()
    x0 = jnp.full((2,), -0.5, jnp.float32)

    @jax.jit
    def run(x0):
        def body(x, i):
            res = nelder_mead.minimize(p.fn, x, cfg)
            # restart from a perturbed solution (data dependency, real work)
            return res.x + 0.5 * jnp.sin(i + res.x), res.f_value

        x, fs = lax.scan(body, x0, jnp.arange(chain, dtype=jnp.float32))
        return fs

    med, mn = _timed(lambda: run(x0), runs)
    res = jax.jit(lambda x: nelder_mead.minimize(p.fn, x, cfg))(x0)
    return {
        "name": "nm_rosenbrock_single",
        "solve_time_us": med * 1e6 / chain,
        "iterations": int(res.iterations),
        "iters_per_sec": float(res.iterations) * chain / med,
    }


def bench_de_batched(
    B=8192, dim=10, pop=64, iters=200, runs=5, fast: bool = True,
    eval_dtype=None,
):
    """Config #2: batched-population DE on Rastrigin.

    ``fast=True`` uses the column-major driver (solvers/de_batched.py) with
    rotation partner sampling; ``fast=False`` measures the
    reference-semantics row driver.  ``eval_dtype=jnp.bfloat16`` evaluates
    the objective in bf16 with f32 solver state.
    """
    from ..core import with_eval_dtype
    from ..solvers import de_batched as deb

    fn = PROBLEMS["rastrigin"].fn
    if eval_dtype is not None:
        fn = with_eval_dtype(fn, eval_dtype)
    x0 = jnp.full((B, dim), -0.5, jnp.float32)

    if fast:
        cfg = de.DEConfig(
            pop_size=pop, max_iter=1 << 30, best_value_no_change=1 << 30,
            eps=0.0, partner_sampling="rotation",
        )
        keys = jax.random.split(jax.random.key(0), B)

        @jax.jit
        def run(x0, keys):
            state = deb.init(fn, x0, cfg, keys)
            final = drive_scan(lambda s: deb.step(fn, s, cfg), state, iters)
            return jnp.min(final.scores, axis=-1)

    else:
        cfg = de.DEConfig(
            pop_size=pop, max_iter=1 << 30, best_value_no_change=1 << 30, eps=0.0
        )
        keys = jax.random.split(jax.random.key(0), B)

        @jax.jit
        def run(x0, keys):
            states = jax.vmap(lambda x, k: de.init(fn, x, cfg, k))(x0, keys)
            final = drive_scan(jax.vmap(lambda s: de.step(fn, s, cfg)), states, iters)
            return jnp.min(final.scores, axis=-1)

    med, mn = _timed(lambda: run(x0, keys), runs)
    # roofline models (per generation): minimal HBM traffic = population +
    # scores read and written once; transcendental work = one cos per
    # element of the trial population (Rastrigin)
    bytes_per_gen = (2 * B * pop * dim + 2 * B * pop) * 4
    trans_per_gen = B * pop * dim
    return {
        "name": "de_batched" + ("_fast" if fast else "_row")
        + ("_bf16" if eval_dtype is not None else ""),
        "instances": B,
        "generations": iters,
        "iters_per_sec": B * iters / med,
        "median_ms": med * 1e3,
        "min_ms": mn * 1e3,
        "model_gbps": bytes_per_gen * iters / med / 1e9,
        "model_gtrans_per_sec": trans_per_gen * iters / med / 1e9,
    }


def bench_pso_sann_100d(B=256, dim=100, iters=200, runs=5, fast: bool = True):
    """Config #3: PSO + SANN fleets on 100-D Rastrigin/Ackley.

    ``fast=True`` (default) runs the lane-axis fleet engines
    (solvers/pso_batched.py, solvers/sann_batched.py: instance batch on
    the trailing axis, gather-free swarm-best); ``fast=False`` measures
    the row-layout vmapped drivers — kept as the A/B."""
    from ..solvers import pso_batched as psb, sann_batched as snb

    out = {}
    for pname in ("rastrigin", "ackley"):
        fn = PROBLEMS[pname].fn
        cfg = pso.PSOConfig(n_particles=32, max_iter=1 << 30, best_value_no_change=1 << 30, eps=0.0)
        keys = jax.random.split(jax.random.key(0), B)
        if fast:
            x0b = jnp.full((B, dim), -0.5, jnp.float32)

            @jax.jit
            def run(x0b, keys):
                lower, upper = psb._derived_bounds(x0b.T)
                state = psb.init(fn, x0b, cfg, keys, lower, upper)
                final = psb.drive_fleet_scan(
                    lambda s: psb.step(fn, s, cfg), state, iters
                )
                return final.swarm_best_value

            med, _ = _timed(lambda: run(x0b, keys), runs)
        else:
            x0 = jnp.full((dim,), -0.5, jnp.float32)
            lower, upper = -jnp.abs(x0), jnp.abs(x0)

            @jax.jit
            def run(keys):
                states = jax.vmap(lambda k: pso.init(fn, x0, cfg, k, lower, upper))(keys)
                final = drive_scan(
                    jax.vmap(lambda s: pso.step(fn, s, cfg, lower, upper, False)),
                    states,
                    iters,
                )
                return final.swarm_best_value

            med, _ = _timed(lambda: run(keys), runs)
        out[f"pso_{pname}_100d_iters_per_sec"] = B * iters / med

    scfg = sann.SANNConfig(max_iter=1 << 30)
    keys = jax.random.split(jax.random.key(0), B)
    fn = PROBLEMS["rastrigin"].fn
    if fast:
        x0b = jnp.full((B, dim), -0.5, jnp.float32)

        @jax.jit
        def run_sann(x0b, keys):
            state = snb.init(fn, x0b, scfg, keys)
            final = snb.drive_fleet_scan(
                lambda s: snb.step(fn, s, scfg), state, iters
            )
            return final.best_value

        med, _ = _timed(lambda: run_sann(x0b, keys), runs)
    else:
        x0 = jnp.full((dim,), -0.5, jnp.float32)

        @jax.jit
        def run_sann(keys):
            states = jax.vmap(lambda k: sann.init(fn, x0, scfg, k))(keys)
            final = drive_scan(jax.vmap(lambda s: sann.step(fn, s, scfg)), states, iters)
            return final.best_value

        med, _ = _timed(lambda: run_sann(keys), runs)
    out["sann_rastrigin_100d_iters_per_sec"] = B * iters / med
    out["name"] = "pso_sann_100d" + ("_fast" if fast else "_row")
    out["instances"] = B
    out["engine"] = "lane_fleet" if fast else "row_vmap"
    # PSO rastrigin: 32 particles x 100 dims x one cos per element per gen
    out["model_gtrans_per_sec"] = (
        B * 32 * dim * out["pso_rastrigin_100d_iters_per_sec"] / B / 1e9
    )
    # PSO HBM model: at dim=100 x 32 particles the per-gen state traffic
    # dominates (unlike 10-D DE).  Streams per generation over [n, P, B]
    # f32: positions r+w, velocities r+w, best_positions r+w, plus the
    # two uniform draws materialized+consumed (~4) and the eval read = ~11.
    out["model_gbps"] = (
        11 * dim * 32 * 4 * out["pso_rastrigin_100d_iters_per_sec"] / 1e9
    )
    # SANN rastrigin: (temperature_iter-1)=9 sequential proposals per
    # outer iteration, each B x dim cos — PLUS ~3 transcendental-class ops
    # per Box-Muller normal (log/sqrt/sincos), n x B normals per proposal,
    # so the true transcendental count is ~4x the objective-only model
    out["sann_model_gtrans_per_sec"] = (
        9 * dim * out["sann_rastrigin_100d_iters_per_sec"] / 1e9
    )
    out["sann_model_gtrans_per_sec_incl_rng"] = (
        4 * out["sann_model_gtrans_per_sec"]
    )
    return out


def bench_bfgs_batch(B=10000, dim=16, runs=5):
    """Config #4a: 10k batched BFGS + More-Thuente on smooth convex
    instances (shifted quadratic bowls with per-instance curvature)."""
    key = jax.random.key(0)
    k1, k2 = jax.random.split(key)
    centers = jax.random.normal(k1, (B, dim), jnp.float32)
    scales = jax.random.uniform(k2, (B, dim), jnp.float32, 0.5, 3.0)
    cfg = bfgs.BFGSConfig(max_iter=30)

    @jax.jit
    def run():
        def solve(c, s):
            fn = lambda x: jnp.sum(s * (x - c) ** 2)
            return bfgs.minimize(fn, jnp.zeros(dim, jnp.float32), cfg)

        return jax.vmap(solve)(centers, scales)

    med, mn = _timed(lambda: run().x, runs)
    res = run()
    total_iters = int(jnp.sum(res.iterations))
    # vmapped while_loop executes max(iterations) trips for the whole
    # batch; per trip the dominant HBM traffic is H [B, n, n] read+write
    trips = int(jnp.max(res.iterations))
    bytes_total = trips * 2 * B * dim * dim * 4
    return {
        "name": "bfgs_batch",
        "instances": B,
        "median_ms": med * 1e3,
        "solved_frac": float(jnp.mean((res.f_value < 1e-4))),
        "iters_per_sec": total_iters / med,
        "model_gbps": bytes_total / med / 1e9,
    }


def bench_bfgs_fleet(B=10000, dim=16, runs=5, linesearch="more_thuente"):
    """Config #4a, batch-minor layout: the same 10k-instance BFGS workload
    as bench_bfgs_batch but with the fleet on the trailing (lane) axis and
    the fused update+direction (solvers/bfgs_fleet.py).
    ``linesearch="speculative"`` swaps the sequential More-Thuente
    recurrence for the depth-1 batched grid search
    (linesearch/speculative.py) — the latency-chain redesign."""
    from ..solvers import bfgs_fleet

    key = jax.random.key(0)
    k1, k2 = jax.random.split(key)
    centers = jax.random.normal(k1, (dim, B), jnp.float32)
    scales = jax.random.uniform(k2, (dim, B), jnp.float32, 0.5, 3.0)
    cfg = bfgs_fleet.BFGSFleetConfig(max_iter=30, linesearch=linesearch)
    fn_cols = lambda X: jnp.sum(scales * (X - centers) ** 2, axis=0)

    run = jax.jit(
        lambda: bfgs_fleet.minimize_fleet(fn_cols, jnp.zeros((dim, B), jnp.float32), cfg)
    )
    med, mn = _timed(lambda: run().x, runs)
    res = run()
    total_iters = int(jnp.sum(res.iterations))
    trips = int(jnp.max(res.iterations))
    bytes_total = trips * 2 * B * dim * dim * 4      # H [n, n, B] r+w per trip
    return {
        "name": "bfgs_fleet",
        "instances": B,
        "median_ms": med * 1e3,
        "solved_frac": float(jnp.mean((res.f_value < 1e-4))),
        "iters_per_sec": total_iters / med,
        "linesearch": linesearch,
        "model_gbps": bytes_total / med / 1e9,
    }


def bench_rootfinder_batch(B=100000, runs=5):
    """Config #4b: Brent + ITP over a large batch of bracketed scalar roots."""
    shifts = jnp.linspace(0.1, 1.9, B).astype(jnp.float32)

    @jax.jit
    def run_brent():
        return jax.vmap(
            lambda c: rootfind.brent(lambda x: jnp.cos(x) - c * x, 0.0, 2.0, tol=1e-6)
        )(shifts).x

    @jax.jit
    def run_itp():
        return jax.vmap(
            lambda c: rootfind.itp(lambda x: jnp.cos(x) - c * x, 0.0, 2.0, tol=1e-6, eps=1e-6)
        )(shifts).x

    med_b, _ = _timed(run_brent, runs)
    med_i, _ = _timed(run_itp, runs)
    return {
        "name": "rootfinder_batch",
        "instances": B,
        "brent_roots_per_sec": B / med_b,
        "itp_roots_per_sec": B / med_i,
    }


def bench_lm_fleet(B=4096, m=32, runs=5):
    """Config #5: batched nonlinear least-squares fits (exp decay curves).

    Headline ``fits_per_sec`` rides the batch-minor NLLS fleet
    (solvers/nlls_fleet.py, Cholesky solve); the vmapped scalar driver is
    kept as ``vmapped_scalar_fits_per_sec`` for the A/B."""
    from ..solvers import nlls_fleet as nf

    key = jax.random.key(0)
    t = jnp.linspace(0.0, 2.0, m, dtype=jnp.float32)
    k1, k2 = jax.random.split(key)
    amps = jax.random.uniform(k1, (B,), jnp.float32, 1.0, 3.0)
    rates = jax.random.uniform(k2, (B,), jnp.float32, 0.5, 2.0)
    ys = amps[:, None] * jnp.exp(-rates[:, None] * t[None, :])
    cfg = nlls_mod.NLLSConfig(max_iter=30)

    def residual(p, y_i):
        return p[0] * jnp.exp(-p[1] * t) - y_i

    run = jax.jit(
        lambda: nlls_mod.fit_batched(residual, jnp.ones((B, 2), jnp.float32), cfg, data=ys)
    )
    med_v, _ = _timed(lambda: run().x, runs)

    solve = "cholesky"
    fcfg = nf.NLLSFleetConfig(max_iter=30, solve=solve)
    run_f = jax.jit(
        lambda: nf.fit_fleet(residual, jnp.ones((2, B), jnp.float32), fcfg, data=ys)
    )
    med, _ = _timed(lambda: run_f().x, runs)
    res = run_f()
    # per trip: residual + 2-col Jacobian = ~3 exp evaluations of [B, m]
    trips = int(jnp.max(res.iterations))
    return {
        "name": "lm_fleet",
        "instances": B,
        "engine": f"nlls_fleet[{solve}]",
        "median_ms": med * 1e3,
        "fits_per_sec": B / med,
        "vmapped_scalar_fits_per_sec": B / med_v,
        "fleet_speedup_vs_vmapped": med_v / med,
        "solved_frac": float(jnp.mean(res.f_value < 1e-6)),
        "model_gtrans_per_sec": trips * 3 * B * m / med / 1e9,
    }


def bench_roofline_micro(runs=5):
    """Measured device ceilings that anchor every scenario's %-of-peak
    figure.  Three microbenchmarks:

      * ``stream_gbps`` — triad ``y' = 2y + x`` over 256 MiB f32 (3 HBM
        streams per iteration, not CSE-/hoist-able since the carry
        changes); the achievable-bandwidth ceiling.
      * ``cos_gelems_per_sec`` — dependent ``jnp.cos`` chain over 64M f32;
        the transcendental ceiling that bounds every Rastrigin/Ackley
        objective evaluation.
      * ``matmul_tflops_default_precision`` — 4096^3 f32 matmul chain at
        XLA's default precision (TF32 tensor cores on a GPU), compared
        with the data-sheet TF32 rate.

    Every ceiling is measured as the DIFFERENCE between a long and a short
    chain of the same program, which cancels the fixed dispatch cost.
    """
    N = 1 << 26                                   # 64M f32 = 256 MiB
    x = jax.random.normal(jax.random.key(0), (N // 1024, 1024), jnp.float32)

    def per_iter_seconds(make_run, short, long):
        t_s, _ = _timed(make_run(short), runs)
        t_l, _ = _timed(make_run(long), runs)
        return max(t_l - t_s, 1e-9) / (long - short)

    def triad(length):
        @jax.jit
        def run(x, y):
            def body(y, _):
                return 2.0 * y + x, ()
            y, _ = jax.lax.scan(body, y, None, length=length)
            return y
        return lambda: run(x, x + 1.0)

    sec = per_iter_seconds(triad, 16, 144)
    stream_gbps = 3 * N * 4 / sec / 1e9

    def coschain(length):
        @jax.jit
        def run(y):
            def body(y, _):
                return jnp.cos(y), ()
            y, _ = jax.lax.scan(body, y, None, length=length)
            return y
        return lambda: run(x)

    sec = per_iter_seconds(coschain, 4, 36)
    cos_gelems = N / sec / 1e9

    M = 4096
    a = jax.random.normal(jax.random.key(1), (M, M), jnp.float32)

    def mmchain(length):
        @jax.jit
        def run(a, b):
            def body(b, _):
                b = a @ b
                return b / jnp.max(jnp.abs(b)), ()
            b, _ = jax.lax.scan(body, b, None, length=length)
            return b
        return lambda: run(a, a)

    sec = per_iter_seconds(mmchain, 4, 36)
    matmul_tflops = 2 * M**3 / sec / 1e12

    spec = peaks(jax.devices()[0].device_kind)
    return {
        "name": "roofline_micro",
        "stream_gbps": stream_gbps,
        "stream_pct_of_spec": 100 * stream_gbps / spec["hbm_gbps"],
        "cos_gelems_per_sec": cos_gelems,
        "matmul_tflops_default_precision": matmul_tflops,
        "matmul_pct_of_tf32_spec": 100 * matmul_tflops / spec["tf32_tflops"],
        "peaks_source": spec["source"],
    }


def bench_eigh_batched(B=4096, n=16, runs=5, sweeps=8, reps=20):
    """Batched small-matrix symmetric eigendecomposition head-to-head:
    the tinyqr-class kernel (tinyqr.h:317-434's role) on its real fleet
    shape — thousands of [n, n] covariance matrices.

    Contenders: batched ``jnp.linalg.eigh`` (XLA; cuSOLVER on a GPU) and
    the parallel-order Jacobi in pure jnp (batch-minor).  Each timed run
    decomposes the batch ``reps`` times back-to-back (data dependency via
    +eps*I re-symmetrize) so the measurement amortizes dispatch.
    """
    from ..linalg.jacobi import eigh_jacobi

    key = jax.random.key(0)
    G = jax.random.normal(key, (B, n, n), jnp.float32)
    eye = jnp.eye(n, dtype=jnp.float32)
    A_batch = G @ jnp.swapaxes(G, -1, -2) + 0.1 * eye          # [B, n, n] SPD
    A_bm = jnp.moveaxis(A_batch, 0, -1)                        # [n, n, B]

    def chain(decomp, rebuild):
        def run(A):
            def body(A, _):
                w, V = decomp(A)
                return rebuild(A, w, V), jnp.max(w)
            _, tops = jax.lax.scan(body, A, None, length=reps)
            return tops
        return jax.jit(run)

    rebuild_bM = lambda A, w, V: A + 1e-6 * jnp.max(w) * eye       # [B, n, n]
    rebuild_bm = lambda A, w, V: A + 1e-6 * jnp.max(w) * eye[..., None]  # [n, n, B]
    run_xla = chain(lambda A: jnp.linalg.eigh(A), rebuild_bM)
    run_jac = chain(lambda A: eigh_jacobi(A, sweeps=sweeps, sort=False), rebuild_bm)
    med_x, _ = _timed(lambda: run_xla(A_batch), runs)
    med_j, _ = _timed(lambda: run_jac(A_bm), runs)
    out = {
        "name": "eigh_batched",
        "B": B, "n": n, "sweeps": sweeps,
        "xla_eigh_per_sec": B * reps / med_x,
        "jacobi_eigh_per_sec": B * reps / med_j,
        "jacobi_speedup_vs_xla": med_x / med_j,
    }

    # correctness anchor: jacobi reconstructs A to f32 precision (the
    # einsum check itself must run at HIGHEST or TF32 rounding dominates
    # the reported error on a GPU)
    w, V = eigh_jacobi(A_bm, sweeps=sweeps, sort=False)
    recon = jnp.einsum(
        "ik...,k...,jk...->ij...", V, w, V, precision=jax.lax.Precision.HIGHEST
    )
    out["jacobi_recon_rel_err"] = float(
        jnp.max(jnp.abs(recon - A_bm)) / jnp.max(jnp.abs(A_bm))
    )

    return out


def bench_cmaes_fleet(B=4096, n=16, iters=50, runs=3, methods=("jacobi", "xla")):
    """CMA-ES fleet on 16-D Rastrigin: B independent strategies, one
    eigendecomposition of [n, n] per strategy per generation (the workload
    tinyqr.h:317-434 exists for, at fleet scale).  Reports generations/s
    per eigensolver backend, then the lazy-eigendecomposition and
    deferred-covariance modes on the Jacobi backend.
    """
    from ..solvers import cmaes_fleet

    fn = PROBLEMS["rastrigin"].fn
    X0 = jnp.full((n, B), -0.5, jnp.float32)
    key = jax.random.key(0)

    out = {"name": "cmaes_fleet", "instances": B, "dim": n, "generations": iters}
    variants = [(m, 1, False) for m in methods] + [
        # Hansen's lazy eigendecomposition, then the deferred-covariance
        # mode on top of it
        (methods[0], 5, False),
        (methods[0], 5, True),
        (methods[0], 10, True),
    ]
    for method, interval, defer in variants:
        cfg = cmaes_fleet.CMAESFleetConfig(
            max_iter=1 << 30, best_value_no_change=1 << 30,
            f_tol=0.0, kick_tol=0.0, cond_max=jnp.inf, eigh_method=method,
            eigen_interval=interval, defer_covariance=defer,
        )

        @jax.jit
        def run(X0, key):
            state = cmaes_fleet.init(fn, X0, cfg, key)
            final = cmaes_fleet.drive_fleet_scan(
                lambda s: cmaes_fleet.step(fn, s, cfg), state, iters
            )
            return final.best_value

        med, _ = _timed(lambda: run(X0, key), runs)
        tag = method if interval == 1 else f"{method}_lazy{interval}"
        if defer:
            tag += "_defer"
        out[f"{tag}_gens_per_sec"] = B * iters / med
        out[f"{tag}_median_ms"] = med * 1e3
    if "xla_gens_per_sec" in out:
        others = [v for k, v in out.items()
                  if k.endswith("_gens_per_sec") and not k.startswith("xla")]
        if others:
            out["best_speedup_vs_xla"] = max(others) / out["xla_gens_per_sec"]
    # per generation: C/rank-mu [n, n, B] r+w ~4 streams + populations;
    # transcendentals: lam x n cos per strategy (Rastrigin eval)
    best = max(out[f"{m}_gens_per_sec"] for m in methods)
    lam = 4 + int(3 * np.log(n))
    out["model_gbps"] = (4 * n * n * B + 3 * n * lam * B) * 4 * best / B / 1e9
    out["model_gtrans_per_sec"] = lam * n * best / 1e9
    return out


def bench_qr_shapes(B=4096, runs=5, reps=20):
    """QR regime map over three shapes: XLA's batched Householder QR
    against the jnp wavefront, whose value is the batch-minor fleet layout
    and trailing-batch least squares."""
    rows = [bench_qr_batched(B=B, m=m, n=n, runs=runs, reps=reps)
            for (m, n) in ((16, 16), (16, 8), (32, 8))]
    return {"name": "qr_shapes", "rows": rows}


def bench_qr_batched(B=4096, m=16, n=16, runs=5, reps=20):
    """Batched small-matrix QR head-to-head (tinyqr.h:253-310's role at
    fleet scale): vmapped ``jnp.linalg.qr`` vs the Sameh-Kuck parallel
    Givens wavefront (linalg/qr_parallel.py), and the implicit-Q^T
    least-squares pipeline.  ``bench_qr_shapes`` maps the shape regimes."""
    from ..linalg.qr_parallel import least_squares_parallel, qr_parallel

    key = jax.random.key(0)
    A_batch = jax.random.normal(key, (B, m, n), jnp.float32)   # [B, m, n]
    A_bm = jnp.moveaxis(A_batch, 0, -1)                        # [m, n, B]

    def chain(run_one, A):
        @jax.jit
        def run(A):
            def body(A, _):
                r = run_one(A)
                return A + 1e-6 * jnp.max(jnp.abs(r)), jnp.max(r)
            _, tops = jax.lax.scan(body, A, None, length=reps)
            return tops
        return lambda: run(A)

    med_x, _ = _timed(chain(lambda A: jnp.linalg.qr(A)[1], A_batch), runs)
    med_p, _ = _timed(
        chain(lambda A: qr_parallel(A, compute_q=False).R, A_bm), runs
    )
    out = {
        "name": "qr_batched", "B": B, "m": m, "n": n,
        "xla_qr_per_sec": B * reps / med_x,
        "parallel_qr_per_sec": B * reps / med_p,
        "parallel_speedup_vs_xla": med_x / med_p,
    }

    # correctness anchor at f32
    Q, R = qr_parallel(A_bm)
    rec = jnp.einsum(
        "ik...,kj...->ij...", Q, R, precision=jax.lax.Precision.HIGHEST
    )
    out["recon_rel_err"] = float(
        jnp.max(jnp.abs(rec - A_bm)) / jnp.max(jnp.abs(A_bm))
    )

    y = jax.random.normal(jax.random.key(1), (m, B), jnp.float32)
    med_ls, _ = _timed(
        chain(lambda A: least_squares_parallel(A, y), A_bm), runs
    )
    out["parallel_lstsq_per_sec"] = B * reps / med_ls

    return out


def bench_nlls_fleet(B=16384, m=32, runs=3):
    """Config #5 head-to-head: the vmapped
    scalar LM driver (bench_lm_fleet's engine) vs the batch-minor fleet
    (solvers/nlls_fleet.py) under each solve backend."""
    from ..solvers import nlls_fleet as nf

    key = jax.random.key(0)
    t = jnp.linspace(0.0, 2.0, m, dtype=jnp.float32)
    k1, k2 = jax.random.split(key)
    amps = jax.random.uniform(k1, (B,), jnp.float32, 1.0, 3.0)
    rates = jax.random.uniform(k2, (B,), jnp.float32, 0.5, 2.0)
    ys = amps[:, None] * jnp.exp(-rates[:, None] * t[None, :])

    def residual(p, y_i):
        return p[0] * jnp.exp(-p[1] * t) - y_i

    out = {"name": "nlls_fleet", "instances": B, "m": m}
    run_ref = jax.jit(
        lambda: nlls_mod.fit_batched(
            residual, jnp.ones((B, 2), jnp.float32),
            nlls_mod.NLLSConfig(max_iter=30), data=ys,
        )
    )
    med, _ = _timed(lambda: run_ref().x, runs)
    out["vmapped_scalar_fits_per_sec"] = B / med
    out["vmapped_scalar_median_ms"] = med * 1e3

    for solve in ("cholesky", "qr"):
        cfg = nf.NLLSFleetConfig(max_iter=30, solve=solve)
        run_fl = jax.jit(
            lambda cfg=cfg: nf.fit_fleet(
                residual, jnp.ones((2, B), jnp.float32), cfg, data=ys
            )
        )
        med_f, _ = _timed(lambda: run_fl().x, runs)
        out[f"fleet_{solve}_fits_per_sec"] = B / med_f
        out[f"fleet_{solve}_median_ms"] = med_f * 1e3
        out[f"fleet_{solve}_speedup_vs_vmapped"] = med / med_f
        res = run_fl()
        out[f"fleet_{solve}_solved_frac"] = float(
            jnp.mean(res.f_value < 1e-6)
        )
    return out


def bench_latency_single(runs=5, chain=64):
    """Per-solve device latency for single instances of NM, DE, and BFGS.

    Each metric chains ``chain`` *dependent* solves inside one program
    (every restart point derives from the previous solution), so the
    reported us/solve is device latency including all solver iterations,
    not dispatch."""
    from jax import lax

    p = PROBLEMS["rosenbrock"]
    x0 = jnp.full((2,), -0.5, jnp.float32)
    out = {"name": "latency_single", "chain": chain}

    def measure(solve, tag):
        @jax.jit
        def run(x0):
            def body(x, i):
                res = solve(x, i)
                return res.x + 0.5 * jnp.sin(i + res.x), res.f_value

            _, fs = lax.scan(body, x0, jnp.arange(chain, dtype=jnp.float32))
            return fs

        med, _ = _timed(lambda: run(x0), runs)
        out[f"{tag}_solve_time_us"] = med * 1e6 / chain
        res = solve(x0, jnp.float32(0.0))
        out[f"{tag}_iterations"] = int(res.iterations)
        out[f"{tag}_us_per_iteration"] = (
            med * 1e6 / chain / max(int(res.iterations), 1)
        )

    nm_cfg = nelder_mead.NelderMeadConfig()
    measure(lambda x, i: nelder_mead.minimize(p.fn, x, nm_cfg), "nm")
    de_cfg = de.DEConfig(pop_size=32, max_iter=100)
    de_key = jax.random.key(0)
    measure(
        lambda x, i: de.minimize(
            p.fn, x, de_cfg, key=jax.random.fold_in(de_key, i.astype(jnp.int32))
        ),
        "de",
    )
    bfgs_cfg = bfgs.BFGSConfig(max_iter=50)
    measure(lambda x, i: bfgs.minimize(p.fn, x, bfgs_cfg), "bfgs")
    return out


def _knee(rows, bkey, tkey, frac=0.8):
    """Smallest batch whose throughput reaches ``frac`` of the sweep's
    best — the saturation knee the round-3 verdict asked to be measured
    rather than asserted."""
    best = max(r[tkey] for r in rows)
    for r in sorted(rows, key=lambda r: r[bkey]):
        if r[tkey] >= frac * best:
            return r[bkey], r[tkey], r[tkey] / best
    return rows[-1][bkey], rows[-1][tkey], 1.0


def bench_saturation(runs=3):
    """Round-3 verdict #2a: sweep every latency-bound scenario's batch to
    its measured throughput knee (smallest B within 80% of the sweep's
    best throughput), instead of diagnosing 'batch too small' at a pinned
    B.  Also A/Bs the speculative depth-1 linesearch against More-Thuente
    on the BFGS fleet at each point (#2b)."""
    out = {"name": "saturation", "sweeps": {}}

    # --- BFGS fleet: More-Thuente vs speculative over the B ladder ------
    rows = []
    for B in (1024, 4096, 16384, 65536):
        for ls in ("more_thuente", "speculative"):
            r = bench_bfgs_fleet(B=B, runs=runs, linesearch=ls)
            rows.append({
                "B": B, "linesearch": ls,
                "iters_per_sec": r["iters_per_sec"],
                "median_ms": r["median_ms"],
                "solved_frac": r["solved_frac"],
                "model_gbps": r["model_gbps"],
            })
    mt = [r for r in rows if r["linesearch"] == "more_thuente"]
    sp = [r for r in rows if r["linesearch"] == "speculative"]
    kb, kt, _ = _knee(mt, "B", "iters_per_sec")
    out["sweeps"]["bfgs_fleet"] = {
        "rows": rows,
        "knee_B": kb,
        "knee_iters_per_sec": kt,
        "speculative_speedup_at_B": {
            str(a["B"]): b["median_ms"] / a["median_ms"]
            for a, b in zip(sp, mt)
        },
    }

    # --- LM fit fleet ---------------------------------------------------
    rows = []
    for B in (1024, 4096, 16384, 65536):
        r = bench_lm_fleet(B=B, runs=runs)
        rows.append({
            "B": B, "fits_per_sec": r["fits_per_sec"],
            "median_ms": r["median_ms"],
            "model_gtrans_per_sec": r["model_gtrans_per_sec"],
        })
    kb, kt, _ = _knee(rows, "B", "fits_per_sec")
    out["sweeps"]["lm_fleet"] = {
        "rows": rows, "knee_B": kb, "knee_fits_per_sec": kt,
    }

    # --- root finders ---------------------------------------------------
    rows = []
    for B in (20000, 100000, 500000, 2000000):
        r = bench_rootfinder_batch(B=B, runs=runs)
        rows.append({
            "B": B,
            "brent_roots_per_sec": r["brent_roots_per_sec"],
            "itp_roots_per_sec": r["itp_roots_per_sec"],
        })
    kb, kt, _ = _knee(rows, "B", "brent_roots_per_sec")
    out["sweeps"]["rootfinder"] = {
        "rows": rows, "knee_B": kb, "knee_brent_roots_per_sec": kt,
    }

    # --- 100-D PSO/SANN: lane-fleet engines vs the row drivers ----------
    rows = []
    for B in (256, 2048, 8192, 32768):
        r = bench_pso_sann_100d(B=B, runs=runs, fast=True)
        row = {
            "B": B, "engine": "lane_fleet",
            "pso_rastrigin_iters_per_sec": r["pso_rastrigin_100d_iters_per_sec"],
            "sann_iters_per_sec": r["sann_rastrigin_100d_iters_per_sec"],
            "model_gtrans_per_sec": r["model_gtrans_per_sec"],
            "sann_model_gtrans_per_sec": r["sann_model_gtrans_per_sec"],
        }
        if B <= 8192:  # the row engine A/B
            rr = bench_pso_sann_100d(B=B, runs=runs, fast=False)
            row["row_pso_iters_per_sec"] = rr["pso_rastrigin_100d_iters_per_sec"]
            row["row_sann_iters_per_sec"] = rr["sann_rastrigin_100d_iters_per_sec"]
        rows.append(row)
    kb, kt, _ = _knee(rows, "B", "pso_rastrigin_iters_per_sec")
    out["sweeps"]["pso_sann_100d"] = {
        "rows": rows, "knee_B": kb, "knee_pso_iters_per_sec": kt,
    }
    kbs, kts, _ = _knee(rows, "B", "sann_iters_per_sec")
    out["sweeps"]["pso_sann_100d"]["sann_knee_B"] = kbs
    out["sweeps"]["pso_sann_100d"]["sann_knee_iters_per_sec"] = kts

    # --- NLLS fleet (the flagship config-#5 engine): find its knee ------
    rows = []
    for B in (4096, 16384, 65536, 262144):
        r = bench_nlls_fleet(B=B, runs=runs)
        best_key = max(
            (k for k in r if k.endswith("_fits_per_sec")), key=lambda k: r[k]
        )
        rows.append({
            "B": B,
            "vmapped_scalar_fits_per_sec": r["vmapped_scalar_fits_per_sec"],
            "best_backend": best_key.replace("_fits_per_sec", ""),
            "best_fits_per_sec": r[best_key],
        })
    kb, kt, _ = _knee(rows, "B", "best_fits_per_sec")
    out["sweeps"]["nlls_fleet"] = {
        "rows": rows, "knee_B": kb, "knee_fits_per_sec": kt,
    }
    return out


ALL_BENCHES = {
    "nm_rosenbrock": bench_nm_rosenbrock,
    "de_batched": bench_de_batched,
    "pso_sann_100d": bench_pso_sann_100d,
    "bfgs_batch": bench_bfgs_batch,
    "bfgs_fleet": bench_bfgs_fleet,
    "rootfinder_batch": bench_rootfinder_batch,
    "lm_fleet": bench_lm_fleet,
    "eigh_batched": bench_eigh_batched,
    "cmaes_fleet": bench_cmaes_fleet,
    "qr_batched": bench_qr_batched,
    "nlls_fleet": bench_nlls_fleet,
    "latency_single": bench_latency_single,
    "saturation": bench_saturation,
}
