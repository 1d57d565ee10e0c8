"""Smoke tests for the benchmark scenarios at tiny sizes on CPU.

The benches are the perf surface (bench.py); these keep every scenario's
code path green without a GPU — numbers are meaningless here, only
result-key contracts and crash-freedom are asserted.
"""
import os
import subprocess
import sys

import pytest

from nlsolver_tpu import benches


def test_de_batched_smoke():
    out = benches.bench_de_batched(B=16, dim=3, pop=8, iters=3, runs=1)
    assert out["iters_per_sec"] > 0
    assert "model_gbps" in out


def test_bfgs_batch_smoke():
    out = benches.bench_bfgs_batch(B=32, dim=4, runs=1)
    assert out["solved_frac"] > 0.9
    assert out["model_gbps"] > 0


def test_bfgs_fleet_smoke():
    out = benches.bench_bfgs_fleet(B=32, dim=4, runs=1)
    assert out["solved_frac"] > 0.9


def test_rootfinder_smoke():
    out = benches.bench_rootfinder_batch(B=64, runs=1)
    assert out["brent_roots_per_sec"] > 0


def test_lm_fleet_smoke():
    out = benches.bench_lm_fleet(B=16, m=8, runs=1)
    assert out["solved_frac"] > 0.9
    assert "model_gtrans_per_sec" in out
    # the headline now rides the batch-minor fleet; the vmapped scalar
    # driver stays as the A/B
    assert out["engine"].startswith("nlls_fleet")
    assert out["vmapped_scalar_fits_per_sec"] > 0


def test_pso_sann_100d_smoke():
    for fast in (True, False):
        out = benches.bench_pso_sann_100d(B=8, dim=4, iters=2, runs=1, fast=fast)
        assert out["pso_rastrigin_100d_iters_per_sec"] > 0
        assert out["sann_rastrigin_100d_iters_per_sec"] > 0
        assert out["engine"] == ("lane_fleet" if fast else "row_vmap")


def test_latency_single_smoke():
    out = benches.bench_latency_single(runs=1, chain=2)
    for tag in ("nm", "de", "bfgs"):
        assert out[f"{tag}_solve_time_us"] > 0
        assert out[f"{tag}_iterations"] > 0


def test_eigh_batched_smoke():
    out = benches.bench_eigh_batched(B=32, n=4, runs=1, reps=2)
    assert out["jacobi_recon_rel_err"] < 1e-4
    assert out["jacobi_eigh_per_sec"] > 0
    assert out["xla_eigh_per_sec"] > 0


def test_cmaes_fleet_smoke():
    out = benches.bench_cmaes_fleet(B=16, n=3, iters=3, runs=1,
                                    methods=("jacobi",))
    assert out["jacobi_gens_per_sec"] > 0


def test_qr_batched_smoke():
    out = benches.bench_qr_batched(B=32, m=6, n=4, runs=1, reps=2)
    assert out["recon_rel_err"] < 1e-4
    assert out["parallel_lstsq_per_sec"] > 0


def test_attach_peaks_contract():
    import importlib

    bench_mod = importlib.import_module("bench")
    micro = {"stream_gbps": 700.0, "cos_gelems_per_sec": 40.0}
    out = bench_mod.attach_peaks(
        {"model_gbps": 70.0, "model_gtrans_per_sec": 20.0}, micro
    )
    assert out["pct_hbm_peak"] == 10.0
    assert out["pct_cos_peak"] == 50.0


def test_qr_shapes_smoke():
    out = benches.bench_qr_shapes(B=32, runs=1, reps=2)
    assert len(out["rows"]) == 3
    for row in out["rows"]:
        assert row["recon_rel_err"] < 1e-3


def test_peaks_known_kind():
    spec = benches.peaks("NVIDIA H100 80GB HBM3")
    assert spec["hbm_gbps"] == 3350.0 and spec["tf32_tflops"] == 495.0
    assert "data sheet" in spec["source"]


def test_peaks_unknown_kind_raises():
    with pytest.raises(ValueError, match="no peak rates recorded for"):
        benches.peaks("cpu")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_script_refuses_non_gpu_device(script):
    """Both measurement entry points fail on the CPU, name the device they
    found, and print no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, script], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "cpu" in out.stderr and "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout
