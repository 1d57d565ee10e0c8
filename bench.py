"""Throughput benchmark — batched solver iterations/s on one GPU.

Headline (stdout, ONE JSON line): batched Differential Evolution over 8192
independent 10-D Rastrigin instances, 64 agents each, 200 generations via
the fixed-trip scan driver — per-instance solver iterations per second.

``python bench.py --all`` additionally runs the roofline microbenchmarks
(measured device ceilings: HBM stream, cos throughput, f32 matmul) and
every BASELINE.json config scenario, printing each on stderr with
achieved %-of-measured-peak numbers.  ``--out FILE`` writes the full
suite as one JSON artifact.

The benchmark runs on a GPU only: any other default device, or any failed
scenario, makes it exit non-zero.
"""
import json
import sys

NORTH_STAR = 1.0e5  # BASELINE.json: >=1e5 batched solver iterations/s/chip


def attach_peaks(out: dict, micro: dict) -> dict:
    """Convert a scenario's analytic traffic/op models into fractions of
    the MEASURED device ceilings (not the data sheet), so 'fast' is
    falsifiable: pct_hbm_peak ~100 means the scenario streams at the
    card's achievable bandwidth; pct_cos_peak ~100 means the
    transcendental throughput is saturated."""
    for key, peak, name in (
        ("model_gbps", micro["stream_gbps"], "pct_hbm_peak"),
        ("model_gtrans_per_sec", micro["cos_gelems_per_sec"], "pct_cos_peak"),
    ):
        if key in out:
            out[name] = round(100 * out[key] / peak, 1)
    return out


def main():
    from nlsolver_tpu.utils.compile_cache import enable_compile_cache
    from nlsolver_tpu.utils.device import (card_name_and_power_limit,
                                           describe, require_gpu)

    require_gpu()
    enable_compile_cache()

    from nlsolver_tpu.benches import (
        ALL_BENCHES,
        bench_de_batched,
        bench_roofline_micro,
    )

    device = {**describe(), "nvidia_smi": card_name_and_power_limit()}
    print(f"# device {json.dumps(device)}", file=sys.stderr)
    artifact = {"device": device}
    failed = []
    if "--all" in sys.argv:
        micro = bench_roofline_micro()
        print(f"# {json.dumps(micro)}", file=sys.stderr)
        artifact["roofline_micro"] = micro
        for name, fn in ALL_BENCHES.items():
            try:
                out = attach_peaks(fn(), micro)
            except Exception as e:  # report every scenario, then fail
                print(f"# {name} FAILED: {e!r}", file=sys.stderr)
                artifact[name] = {"error": repr(e)}
                failed.append(name)
                continue
            print(f"# {json.dumps(out)}", file=sys.stderr)
            artifact[name] = out

    head = bench_de_batched()
    print(
        f"# median={head['median_ms']:.2f}ms min={head['min_ms']:.2f}ms; "
        f"{head['instances']} instances x {head['generations']} DE generations",
        file=sys.stderr,
    )
    headline = {
        "metric": "batched_de_solver_iterations_per_sec_per_chip",
        "value": round(head["iters_per_sec"], 1),
        "unit": "iter/s",
        "vs_baseline": round(head["iters_per_sec"] / NORTH_STAR, 3),
        "device": device,
    }
    if "--out" in sys.argv:
        artifact["headline"] = {**headline, **head}
        i = sys.argv.index("--out") + 1
        path = sys.argv[i] if i < len(sys.argv) else "BENCH_ALL.json"
        if path.startswith("--"):
            path = "BENCH_ALL.json"
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"# wrote {path}", file=sys.stderr)
    if failed:
        raise SystemExit(f"failed scenarios: {', '.join(failed)}")
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
