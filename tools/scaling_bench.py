"""Scaling-efficiency benchmark harness (BASELINE.json north star:
>=80% scaling efficiency from 1 host to 2+ hosts).

Weak scaling: per-device problem count is held fixed while the mesh grows,
so perfect scaling is constant wall time.  Efficiency(d) = t(1) / t(d).
Fixed work per run: eps=0 and an exact generation budget, so every device
count executes the identical number of generations.

Modes (all shard over a (dp, pop) jax.sharding.Mesh):
  dp       — embarrassingly-parallel fleets: de_batched sharded over dp,
             no cross-device communication (upper bound on efficiency);
  sharded  — parallel/de_sharded.py: population split over the pop axis
             with an all_gather of partners every generation
             (communication-heavy lower bound);
  island   — parallel/de_island.py: shard-local evolution with ring
             ppermute migration every ``--migrate`` generations (the
             recommended production configuration).

Without several GPUs, multi-device runs use virtual CPU devices (run with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and ``--cpu``), which
validates the harness and the sharded programs but no interconnect — CPU
"devices" share the host's cores, so the efficiency printed there is
meaningless (the harness flags it ``emulated: true``).  On a GPU host the
same invocation without ``--cpu`` uses its cards; across hosts, run one
process per host with ``jax.distributed.initialize``
(parallel/distributed.py).

Usage:
  python tools/scaling_bench.py --devices 1,2,4,8 --mode island \
      --per-device 256 --generations 100 [--cpu] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma-separated device counts (each must divide the available devices)")
    ap.add_argument("--mode", default="island", choices=("dp", "sharded", "island"))
    ap.add_argument("--per-device", type=int, default=256,
                    help="problem instances per device (weak scaling)")
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--generations", type=int, default=100)
    ap.add_argument("--migrate", type=int, default=10, help="island migration interval")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--problem", default="rastrigin")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual devices; set "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=N first)")
    ap.add_argument("--json", default=None, help="also write results to this file")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers.de import DEConfig

    fn = PROBLEMS[args.problem].fn
    avail = len(jax.devices())
    counts = [int(c) for c in args.devices.split(",")]
    counts = [c for c in counts if c <= avail]
    emulated = jax.devices()[0].platform == "cpu" and avail > os.cpu_count()

    cfg = DEConfig(
        pop_size=args.pop, max_iter=args.generations, eps=0.0,
        best_value_no_change=1 << 30,
        partner_sampling="rotation" if args.mode == "dp" else "uniform",
    )

    def run_once(n_dev):
        # dp mode: all devices on the dp axis; sharded/island split pop too
        if args.mode == "dp":
            mesh = make_mesh(n_dev, dp=n_dev, pop=1)
        else:
            pop_ax = min(n_dev, 4) if n_dev > 1 else 1
            mesh = make_mesh(n_dev, dp=n_dev // pop_ax, pop=pop_ax)
        dp = mesh.shape["dp"]
        B = args.per_device * n_dev
        # keep B divisible by dp
        B -= B % dp
        x0 = jnp.full((B, args.dim), -0.5, jnp.float32)
        keys = jax.random.split(jax.random.key(0), B)

        if args.mode == "dp":
            from jax.sharding import NamedSharding, PartitionSpec as P

            from nlsolver_tpu.solvers import de_batched

            sh = NamedSharding(mesh, P("dp"))
            x0 = jax.device_put(x0, NamedSharding(mesh, P("dp", None)))
            keys = jax.device_put(keys, sh)
            solve = jax.jit(
                lambda x0, k: de_batched.minimize_batched(fn, x0, cfg, keys=k)
            )
        elif args.mode == "sharded":
            from nlsolver_tpu.parallel import minimize_sharded

            solve = jax.jit(
                lambda x0, k: minimize_sharded(fn, x0, cfg, mesh, k)
            )
        else:
            from nlsolver_tpu.parallel import minimize_islands

            solve = jax.jit(
                lambda x0, k: minimize_islands(
                    fn, x0, cfg, mesh, k, migration_interval=args.migrate
                )
            )

        jax.block_until_ready(solve(x0, keys).f_value)  # compile + warm
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            jax.block_until_ready(solve(x0, keys).f_value)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        return {
            "devices": n_dev,
            "mesh": dict(mesh.shape),
            "instances": B,
            "median_s": med,
            "instance_generations_per_sec": B * args.generations / med,
        }

    results = []
    for c in counts:
        r = run_once(c)
        results.append(r)
        print(f"# {json.dumps(r)}", file=sys.stderr)

    t1 = results[0]["median_s"] if results else float("nan")
    for r in results:
        r["weak_scaling_efficiency"] = t1 / r["median_s"]

    report = {
        "metric": f"weak_scaling_{args.mode}",
        "problem": args.problem,
        "per_device_instances": args.per_device,
        "pop": args.pop,
        "generations": args.generations,
        "platform": jax.devices()[0].platform,
        "emulated": bool(emulated),
        "results": results,
    }
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
