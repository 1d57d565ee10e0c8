"""Round-5 features tour: the lane-axis PSO/SANN fleet engines and the
bounded multistart tier.

1. `minimize(layout="batched")` runs thousands of independent PSO swarms
   (or SANN chains) with the INSTANCE batch on the trailing axis
   (solvers/pso_batched.py / sann_batched.py), and the engines shard over
   a device mesh via `layout="sharded"` (parallel/fleet_sharded.py).
2. `minimize(..., restarts=k, bounds=...)` samples the extra starts
   inside the given box — the bounded multistart tier that cracks
   problems whose classical search domain is far from the reference's
   x0=(-0.5, ...) convention (PARITY.md `b-ms{k}` tags).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import nlsolver_tpu
from nlsolver_tpu.core import Bounds
from nlsolver_tpu.problems import PROBLEMS

TINY = os.environ.get("NLSOLVER_EXAMPLE_TINY") == "1"


def main():
    # ---- lane-axis PSO fleet: B independent swarms, one program --------
    p = PROBLEMS["rastrigin"]
    B, dim = (16, 2) if TINY else (4096, 10)
    x0 = jnp.full((B, dim), -0.5, jnp.float32)
    keys = jax.random.split(jax.random.key(0), B)
    res = jax.jit(
        lambda x0, keys: nlsolver_tpu.minimize(
            p.fn, x0, method="pso", layout="batched", keys=keys
        )
    )(x0, keys)
    solved = int(jnp.sum(res.f_value < 1e-2))
    print(f"PSO lane fleet: {B} x {dim}-D Rastrigin swarms in one program; "
          f"{solved}/{B} at f < 1e-2 "
          f"(median iterations {int(jnp.median(res.iterations))})")

    # ---- lane-axis SANN fleet ------------------------------------------
    from nlsolver_tpu.solvers.sann import SANNConfig

    res = jax.jit(
        lambda x0, keys: nlsolver_tpu.minimize(
            p.fn, x0, method="sann", layout="batched",
            config=SANNConfig(max_iter=200 if TINY else 2000), keys=keys,
        )
    )(x0, keys)
    print(f"SANN lane fleet: median best f = {float(jnp.median(res.f_value)):.4f} "
          f"over {B} chains")

    # ---- bounded multistart: McCormick via its classical domain --------
    m = PROBLEMS["mccormick"]
    bounds = Bounds(lower=jnp.asarray(m.lower), upper=jnp.asarray(m.upper))
    res = nlsolver_tpu.minimize(
        m.fn, jnp.full((m.dim,), -0.5), method="nmpso",
        restarts=4 if TINY else 8, bounds=bounds, key=jax.random.key(1),
    )
    print(f"McCormick bounded multistart: f = {float(res.f_value):.4f} "
          f"(true minimum {m.fmin}), "
          f"dx = {float(m.distance_to_nearest_minimum(res.x)):.4f}")


if __name__ == "__main__":
    main()
