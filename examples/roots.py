"""Root-finder tour — counterpart of the reference's roots.cpp.

Same demo problem f(x) = x^3 - x - 2 on [-4, 8] (real root ~1.5213797),
all seven finders, then the fleet twist: 100k simultaneous bracketed roots
in one vmapped program.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from nlsolver_tpu.solvers.rootfind import ALL_FINDERS, brent, tiruneh


def f(x):
    return x**3 - x - 2.0


def main():
    for name, finder in ALL_FINDERS.items():
        if name == "tiruneh":
            r = tiruneh(f, (1.9, 2.0, 2.1))
        else:
            r = finder(f, -4.0, 8.0)
        print(
            f"{name:15s} x = {float(r.x):.10f}  f(x) = {float(r.f_value):+.3e}  "
            f"iters = {int(r.iterations)}  nfev = {int(r.function_calls)}  "
            f"converged = {bool(r.converged)}"
        )

    # batched: 100k parameterized roots, one compiled program
    B = 1000 if os.environ.get("NLSOLVER_EXAMPLE_TINY") == "1" else 100_000
    cs = jnp.linspace(0.5, 5.0, B)
    res = jax.jit(
        jax.vmap(lambda c: brent(lambda x: x**3 - x - c, -4.0, 8.0))
    )(cs)
    resid = res.x**3 - res.x - cs
    print(
        f"\nbatched brent over {B} instances: "
        f"max |f(x)| = {float(jnp.max(jnp.abs(resid))):.2e}"
    )


if __name__ == "__main__":
    main()
