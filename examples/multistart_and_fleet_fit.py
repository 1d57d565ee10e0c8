"""Round-4 features tour: the multistart meta-driver and the batch-minor
NLLS fleet.

1. `minimize(..., restarts=k)` solves problems the reference's single
   trajectory cannot (its own test harness fails Shekel for every solver
   config, reference_test_matrix.tsv) — k keyed starts run as ONE vmapped
   program, so wall-clock is ~one solve.
2. `fit_fleet` runs thousands of curve fits with the fleet on the lane
   axis and a selectable linear-solve backend (`solve="cholesky"` on the
   normal equations, or `solve="qr"` on the augmented system).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import nlsolver_tpu
from nlsolver_tpu.problems import PROBLEMS

TINY = os.environ.get("NLSOLVER_EXAMPLE_TINY") == "1"


def main():
    # ---- multistart: Shekel (4-D, multimodal, reference fails it) ------
    p = PROBLEMS["shekel"]
    x0 = jnp.full((p.dim,), -0.5)
    single = nlsolver_tpu.minimize(p.fn, x0, method="nelder_mead",
                                   key=jax.random.key(0))
    multi = nlsolver_tpu.minimize(p.fn, x0, method="nelder_mead",
                                  key=jax.random.key(0), restarts=16)
    print("Shekel from (-0.5, ...):")
    print(f"  single start : f = {float(single.f_value):9.4f}  "
          f"dx to minimum = {float(p.distance_to_nearest_minimum(single.x)):.3f}")
    print(f"  16 restarts  : f = {float(multi.f_value):9.4f}  "
          f"dx to minimum = {float(p.distance_to_nearest_minimum(multi.x)):.3f}  "
          f"(total evals: {int(multi.function_calls)})")

    # ---- fleet fit: B exponential-decay curve fits ---------------------
    B, m = (64, 16) if TINY else (4096, 32)
    t = jnp.linspace(0.0, 2.0, m, dtype=jnp.float32)
    k1, k2, k3 = jax.random.split(jax.random.key(1), 3)
    amps = jax.random.uniform(k1, (B,), jnp.float32, 1.0, 3.0)
    rates = jax.random.uniform(k2, (B,), jnp.float32, 0.5, 2.0)
    ys = amps[:, None] * jnp.exp(-rates[:, None] * t[None, :])
    ys = ys + 0.01 * jax.random.normal(k3, ys.shape)

    def residual(params, y_i):
        return params[0] * jnp.exp(-params[1] * t) - y_i

    solve = "cholesky"
    res = nlsolver_tpu.fit_fleet(
        residual,
        jnp.ones((2, B), jnp.float32),
        # noisy data: the cost floor is the noise level, so terminate on
        # a realistic f_delta rather than the 1e-12 default
        nlsolver_tpu.NLLSFleetConfig(max_iter=50, f_delta=1e-7, solve=solve),
        data=ys,
    )
    amp_err = float(jnp.max(jnp.abs(res.x[0] - amps)))
    rate_err = float(jnp.max(jnp.abs(res.x[1] - rates)))
    print(f"\n{B} exponential fits (fleet, solve={solve!r}):")
    print(f"  converged lanes: {int(jnp.sum(res.converged))}/{B}  "
          f"(median final cost {float(jnp.median(res.f_value)):.2e} "
          f"~ the injected noise floor)")
    print(f"  max parameter error: amp {amp_err:.3f}, rate {rate_err:.3f}")


if __name__ == "__main__":
    main()
