"""Compare two ``bench.py --all --out`` artifacts and flag perf regressions.

    python tools/bench_compare.py old.json new.json

Walks both artifacts, pairs every numeric throughput metric (leaf names
ending in _per_sec / _gbps / _gflops / _tflops) by its JSON path, and
prints the ratio new/old.  Exit code 1 if any
paired throughput regressed more than ``--tol`` (default 20%; the
run-to-run spread on a GPU is not measured yet, so set the bound from
repeated runs before relying on it).  Compare two artifacts only when both
were taken on the same card in one session.

Scenario-structure changes are reported, not failed: metrics present in
only one artifact are listed as added/removed.
"""
import argparse
import json
import sys

def flatten(obj, prefix=""):
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix[:-1]] = float(obj)
    return out


def is_throughput(path):
    """True for measured rates only — suffix match, never substrings (a
    substring list containing 'n'/'m'/'B' silently dropped every
    *gens_per_sec / *iters_per_sec metric and gutted the gate; caught in
    the round-4 self-review)."""
    leaf = path.rsplit(".", 1)[-1]
    if "pct" in leaf or "speedup" in leaf:
        return False
    return leaf.endswith(
        ("_per_sec", "_gbps", "_gflops", "_tflops", "_tflops_default_precision")
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--tol", type=float, default=0.20,
                    help="allowed fractional regression (default 0.20)")
    args = ap.parse_args()

    old = flatten(json.load(open(args.old)))
    new = flatten(json.load(open(args.new)))
    old_t = {k: v for k, v in old.items() if is_throughput(k)}
    new_t = {k: v for k, v in new.items() if is_throughput(k)}

    shared = sorted(set(old_t) & set(new_t))
    regressions = []
    print(f"{'metric':70s} {'old':>12s} {'new':>12s} {'ratio':>7s}")
    for k in shared:
        o, n = old_t[k], new_t[k]
        ratio = n / o if o else float("inf")
        flag = ""
        if ratio < 1.0 - args.tol:
            flag = "  <-- REGRESSION"
            regressions.append((k, ratio))
        print(f"{k:70s} {o:12.3g} {n:12.3g} {ratio:6.2f}x{flag}")

    added = sorted(set(new_t) - set(old_t))
    removed = sorted(set(old_t) - set(new_t))
    if added:
        print(f"\nnew metrics ({len(added)}):")
        for k in added:
            print(f"  + {k} = {new_t[k]:.3g}")
    if removed:
        print(f"\nremoved metrics ({len(removed)}):")
        for k in removed:
            print(f"  - {k} (was {old_t[k]:.3g})")

    if regressions:
        print(f"\n{len(regressions)} regression(s) beyond {args.tol:.0%}:")
        for k, r in regressions:
            print(f"  {k}: {r:.2f}x")
        sys.exit(1)
    print(f"\nno throughput regression beyond {args.tol:.0%} "
          f"across {len(shared)} shared metrics")


if __name__ == "__main__":
    main()
