"""Solver tour — the JAX counterpart of the reference's example.cpp.

The reference demos every solver on the 2-D Rosenbrock from x0 = (-0.5, -0.5)
(/root/reference/example.cpp); this does the same through this framework's
API, then shows what the reference cannot: solving 4096 instances at once
with one vmapped program.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CI smoke mode: tiny shapes so the demo surface is exercised cheaply
TINY = os.environ.get("NLSOLVER_EXAMPLE_TINY") == "1"

import jax
import jax.numpy as jnp

import nlsolver_tpu
from nlsolver_tpu.solvers.brent import BrentConfig, minimize_scalar


def rosenbrock(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


def main():
    x0 = jnp.asarray([-0.5, -0.5])
    key = jax.random.key(42)

    from nlsolver_tpu.solvers.gd import GDConfig

    configs = {"gd": GDConfig(step_type="linesearch")}
    for method in (
        "nelder_mead",
        "de",
        "pso",
        "sann",
        "nmpso",
        "gd",
        "cgd",
        "bfgs",
        "lm",
        "cmaes",
    ):
        res = nlsolver_tpu.minimize(
            rosenbrock, x0, method=method, config=configs.get(method), key=key
        )
        print(f"{method:12s} x = {res.x}  f = {float(res.f_value):.3e}  "
              f"iters = {int(res.iterations)}  nfev = {int(res.function_calls)}")

    # 1-D minimization (reference Brent class)
    res = minimize_scalar(lambda x: (x - 2.0) ** 2 + 1.0, BrentConfig())
    print(f"{'brent':12s} x = {float(res.x):.6f}  f = {float(res.f_value):.6f}")

    # what the reference cannot do: 4096 simultaneous instances, one program
    keys = jax.random.split(key, 64 if TINY else 4096)
    batch = jax.jit(
        jax.vmap(lambda k: nlsolver_tpu.minimize(rosenbrock, x0, method="de", key=k))
    )(keys)
    print(
        f"\nbatched DE over {batch.x.shape[0]} instances: "
        f"best f = {float(jnp.min(batch.f_value)):.3e}, "
        f"median f = {float(jnp.median(batch.f_value)):.3e}"
    )


if __name__ == "__main__":
    main()
