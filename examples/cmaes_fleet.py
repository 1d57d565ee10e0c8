"""CMA-ES at fleet scale: thousands of independent strategies on one card.

The reference's CMA-ES (nlsolver.h:4321-4579) never compiled, and its
eigendecomposition engine (tinyqr's iterated QR, tinyqr.h:317-434) handles
one matrix at a time.  This framework's fleet driver keeps B strategies
lane-parallel end-to-end — means [n, B], covariances [n, n, B] — and
decomposes ALL covariance matrices per generation with the batched
parallel-order Jacobi eigensolver (`eigh_method="xla"` uses XLA's batched
``jnp.linalg.eigh`` instead).

Run:  python examples/cmaes_fleet.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import nlsolver_tpu
from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig


def main():
    p = PROBLEMS["himmelblau"]
    tiny = os.environ.get("NLSOLVER_EXAMPLE_TINY") == "1"
    B, n = (32 if tiny else 512), 2

    # spread the fleet's start points over the search box: each lane is an
    # independent CMA-ES instance, so one program explores 512 basins
    key = jax.random.key(0)
    X0 = jax.random.uniform(key, (n, B), jnp.float32, -4.0, 4.0)

    cfg = CMAESFleetConfig(max_iter=80 if tiny else 300, eigh_method="jacobi")
    res = jax.jit(
        lambda X0, k: nlsolver_tpu.minimize(
            p.fn, X0, method="cmaes", layout="fleet", config=cfg, key=k
        )
    )(X0, jax.random.key(1))

    d = jax.vmap(p.distance_to_nearest_minimum, in_axes=1)(res.x)
    hits = int(jnp.sum(d <= 0.05))
    print(f"{B} CMA-ES strategies on Himmelblau (4 global minima):")
    print(f"  solved: {hits}/{B} lanes within 0.05 of a minimum")
    print(f"  median f: {float(jnp.median(res.f_value)):.2e}")
    # count how many distinct minima the fleet found
    minima = p.minima_array                              # [4, 2]
    nearest = jnp.argmin(
        jnp.sum((res.x.T[:, None, :] - minima[None]) ** 2, axis=-1), axis=1
    )
    found = sorted(set(int(m) for m, di in zip(nearest, d) if di <= 0.05))
    print(f"  distinct minima found: {len(found)}/4 {found}")


if __name__ == "__main__":
    main()
