"""Shared machinery for trajectory-level parity against the reference binary.

Golden data: tests/data/reference_trajectories.tsv, produced by
tools/traj_probe.cpp — for each deterministic (solver, problem) pair and each
k it records where the reference lands when run with ``max_iter=k`` from
x0 = (-0.5, -0.5) (full f64 precision).  Because every run with ``max_iter=k``
of a deterministic solver is the k-iteration prefix of the ``max_iter=K``
run, one traced scan on our side (nlsolver_tpu.trace.trajectory) yields the
whole comparison set — except for solvers whose update depends on max_iter
itself (gd_anneal) and the inline-loop scalar solvers, which are re-run per k
exactly like the reference.

All our-side runs use reference-parity settings: FD derivatives accuracy=1
(the reference's fin_diff/fin_diff_h defaults), variant="reference" /
reference_update=True quirk flags where applicable.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp

from nlsolver_tpu import trace
from nlsolver_tpu.deriv import Deriv
from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.random import mt19937
from nlsolver_tpu.solvers import (bfgs, brent, cgd, de_reference, gd, lm,
                                  nelder_mead, rootfind)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "reference_trajectories.tsv")

FD = Deriv(mode="fd", accuracy=1)
X0 = (-0.5, -0.5)


def quartic1d(x):
    return ((x * x) * (x * x)) - 3.0 * (x * x) + x


def cubic(x):
    return x * x * x - 2.0 * x - 5.0


def load_golden():
    """-> {(solver, problem): [row...]}, row = dict(k, f, iters, nfev, gfev,
    hfev, x: tuple)."""
    out = {}
    with open(GOLDEN) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            solver, problem = parts[0], parts[1]
            row = {
                "k": int(parts[2]),
                "f": float(parts[3]),
                "iters": int(parts[4]),
                "nfev": int(parts[5]),
                "gfev": int(parts[6]),
                "hfev": int(parts[7]),
                "x": tuple(float(v) for v in parts[8:]),
            }
            out.setdefault((solver, problem), []).append(row)
    for rows in out.values():
        rows.sort(key=lambda r: r["k"])
    return out


def _problem_fn(problem):
    return PROBLEMS[problem].fn


def _x0(problem):
    return jnp.asarray(X0, jnp.float64)


# ---- our-side runners: (problem, ks) -> {k: dict(x, f, iters, nfev, gfev)} --

def _from_trace(tr, ks, final_eval=False):
    """final_eval: the reference's GD/CGD/BFGS evaluate f(x) once more at
    return ("evaluate at current parameters", e.g. nlsolver.h:2976-2978) —
    our `minimize` mirrors that (+1 in _finalize) but the raw trace counters
    don't, so add it here."""
    out = {}
    for k in ks:
        i = k - 1
        out[k] = {
            "x": jax.tree.map(lambda a: a[i], tr["x"]),
            "f": tr["f"][i],
            "iters": int(tr["iteration"][i]),
            "nfev": int(tr["nfev"][i]) + int(final_eval),
        }
    return out


def run_nm(problem, ks):
    K = max(ks)
    cfg = nelder_mead.NelderMeadConfig(variant="reference", max_iter=K + 1)
    tr = jax.jit(
        lambda x0: trace.trajectory("nelder_mead", _problem_fn(problem), x0,
                                    cfg, num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks)


def _run_gd_traced(step_type, alpha, problem, ks):
    K = max(ks)
    cfg = gd.GDConfig(step_type=step_type, alpha=alpha, max_iter=K + 1,
                      deriv=FD, variant="reference")
    tr = jax.jit(
        lambda x0: trace.trajectory("gd", _problem_fn(problem), x0, cfg,
                                    num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks, final_eval=True)


GD_ALPHA = {"booth": 0.05, "rosenbrock": 0.001}


def run_gd_fixed(problem, ks):
    return _run_gd_traced("fixed", GD_ALPHA[problem], problem, ks)


def run_gd_bigstep(problem, ks):
    return _run_gd_traced("bigstep", 1.0, problem, ks)


def run_gd_linesearch(problem, ks):
    return _run_gd_traced("linesearch", 1.0, problem, ks)


def run_gd_page(problem, ks):
    # PAGE's internal RNG draw only feeds a `u > p` test with p = 0 (the
    # reference's size_t division, nlsolver.h:2944), so the correction
    # branch fires every iteration and the trajectory is RNG-independent.
    return _run_gd_traced("page", GD_ALPHA[problem], problem, ks)


def run_gd_anneal(problem, ks):
    # the anneal schedule alpha/(1+iter/max_iter) depends on max_iter
    # (nlsolver.h:2997) — each k is a different dynamical system; run per k.
    fn = _problem_fn(problem)
    out = {}
    for k in ks:
        cfg = gd.GDConfig(step_type="anneal", alpha=GD_ALPHA[problem],
                          max_iter=k, deriv=FD, variant="reference")
        res = jax.jit(partial(gd.minimize, fn, config=cfg))(_x0(problem))
        out[k] = {"x": res.x, "f": float(res.f_value),
                  "iters": int(res.iterations),
                  "nfev": int(res.function_calls)}
    return out


def run_cgd(problem, ks):
    K = max(ks)
    cfg = cgd.CGDConfig(max_iter=K + 1, deriv=FD)
    tr = jax.jit(
        lambda x0: trace.trajectory("cgd", _problem_fn(problem), x0, cfg,
                                    num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks, final_eval=True)


def run_bfgs(problem, ks):
    K = max(ks)
    cfg = bfgs.BFGSConfig(max_iter=K + 1, deriv=FD, reference_update=True)
    tr = jax.jit(
        lambda x0: trace.trajectory("bfgs", _problem_fn(problem), x0, cfg,
                                    num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks, final_eval=True)


def run_lm(problem, ks):
    K = max(ks)
    cfg = lm.LMConfig(max_iter=K + 1, deriv=FD, variant="reference")
    tr = jax.jit(
        lambda x0: trace.trajectory("lm", _problem_fn(problem), x0, cfg,
                                    num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks)


def run_brent_min(problem, ks):
    out = {}
    for k in ks:
        cfg = brent.BrentConfig(max_iter=k, lower=-5.0, upper=5.0)
        res = jax.jit(partial(brent.minimize_scalar, quartic1d, cfg))()
        # golden rows carry the reference's swapped slots
        # (nlsolver.h:3424-3425): its "x" is f(x*), its "f_value" is x*.
        out[k] = {"x": jnp.asarray([res.f_value]), "f": float(res.x),
                  "iters": int(res.iterations),
                  "nfev": int(res.function_calls)}
    return out


# stochastic family: the reference DE replayed draw-for-draw on the
# bit-parity reference RNGs (solvers/de_reference.py)
DE_CONFIGS = {
    "de_rand_xorshift": dict(strategy="random", rng="xorshift"),
    "de_best_xorshift": dict(strategy="best", rng="xorshift"),
    "de_rand_xoshiro": dict(strategy="random", rng="xoshiro"),
    "de_rand_recurrent": dict(strategy="random", rng="recurrent"),
    "de_rand_halton": dict(strategy="random", rng="halton"),
    # user-RNG interop: std::mt19937(42) + uniform_real_distribution via
    # the reference_rngs.register hook (random/mt19937.py)
    "de_rand_mt": dict(strategy="random", rng="mt"),
}

mt19937.register_mt("mt", seed=42)


def _run_de(solver, problem, ks):
    K = max(ks)
    cfg = de_reference.DEReferenceConfig(max_iter=K + 1, **DE_CONFIGS[solver])
    tr = jax.jit(
        lambda x0: trace.trajectory("de_reference", _problem_fn(problem), x0,
                                    cfg, num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks)


_ROOT_FNS = {
    "root_bisection": lambda k: rootfind.bisection(cubic, 1.0, 3.0, 1e-6, k),
    "root_false_position": lambda k: rootfind.false_position(
        cubic, 1.0, 3.0, 1e-6, k, variant="reference"),
    "root_brent": lambda k: rootfind.brent(cubic, 1.0, 3.0, 1e-12, k),
    "root_ridders": lambda k: rootfind.ridders(cubic, 1.0, 3.0, 1e-12, 1e-12, k),
    "root_itp": lambda k: rootfind.itp(cubic, 1.0, 3.0, 0.3, 2.1, 1.0,
                                       1e-12, 1e-12, k, variant="reference"),
    "root_chandrupatla": lambda k: rootfind.chandrupatla(cubic, 1.0, 3.0,
                                                         1e-10, 2e-10, k),
    "root_tiruneh": lambda k: rootfind.tiruneh(cubic, (1.0, 2.0, 3.0),
                                               1e-6, 1e-12, k),
}


def _run_root(solver, problem, ks):
    out = {}
    for k in ks:
        res = jax.jit(partial(_ROOT_FNS[solver], k))()
        out[k] = {"x": jnp.asarray([res.x]), "f": float(res.f_value),
                  "iters": int(res.iterations),
                  "nfev": int(res.function_calls)}
    return out


RUNNERS = {
    "nm": run_nm,
    "gd_fixed": run_gd_fixed,
    "gd_anneal": run_gd_anneal,
    "gd_bigstep": run_gd_bigstep,
    "gd_linesearch": run_gd_linesearch,
    "gd_page": run_gd_page,
    "cgd": run_cgd,
    "bfgs": run_bfgs,
    "lm": run_lm,
    "brent_min": run_brent_min,
}
RUNNERS.update({name: partial(_run_root, name) for name in _ROOT_FNS})
RUNNERS.update({name: partial(_run_de, name) for name in DE_CONFIGS})


def run_sann(problem, ks, rng="xorshift"):
    K = max(ks)
    from nlsolver_tpu.solvers import sann_reference
    cfg = sann_reference.SANNReferenceConfig(max_iter=K + 1, rng=rng)
    tr = jax.jit(
        lambda x0: trace.trajectory("sann_reference", _problem_fn(problem),
                                    x0, cfg, num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks)


def run_pso_acc(problem, ks, rng="xorshift"):
    K = max(ks)
    from nlsolver_tpu.solvers import pso_reference
    cfg = pso_reference.PSOAccReferenceConfig(max_iter=K + 1, rng=rng)
    tr = jax.jit(
        lambda x0: trace.trajectory("pso_acc_reference", _problem_fn(problem),
                                    x0, cfg, num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks)


def run_nmpso(problem, ks, rng="xorshift"):
    K = max(ks)
    from nlsolver_tpu.solvers import nmpso_reference
    cfg = nmpso_reference.NMPSOReferenceConfig(max_iter=K + 1, rng=rng)
    tr = jax.jit(
        lambda x0: trace.trajectory("nmpso_reference", _problem_fn(problem),
                                    x0, cfg, num_steps=K)
    )(_x0(problem))
    return _from_trace(tr, ks)


RUNNERS["sann_xorshift"] = run_sann
RUNNERS["pso_acc_xorshift"] = run_pso_acc
RUNNERS["nmpso_xorshift"] = run_nmpso
RUNNERS["sann_xoshiro"] = partial(run_sann, rng="xoshiro")
RUNNERS["sann_recurrent"] = partial(run_sann, rng="recurrent")
RUNNERS["pso_acc_xoshiro"] = partial(run_pso_acc, rng="xoshiro")
RUNNERS["nmpso_xoshiro"] = partial(run_nmpso, rng="xoshiro")


def compare_pair(solver, problem, golden_rows, max_k=None):
    """Run our side and compare; returns a summary dict."""
    rows = [r for r in golden_rows if max_k is None or r["k"] <= max_k]
    ks = [r["k"] for r in rows]
    ours = RUNNERS[solver](problem, ks)
    per_k = []
    for r in rows:
        o = ours[r["k"]]
        dx = float(jnp.max(jnp.abs(jnp.asarray(r["x"]) - o["x"])))
        df = abs(r["f"] - float(o["f"]))
        per_k.append({
            "k": r["k"], "dx": dx, "df": df,
            "iters_match": r["iters"] == o["iters"],
            "nfev_match": r["nfev"] == o["nfev"],
        })
    return per_k
