"""Heavy-budget Bukin N6 probe — the reproducible evidence behind
PARITY.md's residual note.

Bukin N6 (minimum (-10, 1), domain [-15,-5]x[-3,3]) fails for every
reference config and every tier of this framework's ladder.  This probe
runs deliberately over-budget bounded attempts (DE pop=64 x 10k iters,
NM with 256 restarts x 10x budget, PSO 64 particles x 50k iters) and
prints the best distance achieved: the ridge floor is reachable to
d ~ 0.1-0.3 but no solver in the reference's catalogue localizes
(-10, 1) to the 0.05 criterion.  ~10 min on 2 CPUs.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from nlsolver_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp, dataclasses
import nlsolver_tpu
from nlsolver_tpu.core import Bounds
from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.solvers import de, nelder_mead, pso

p = PROBLEMS["bukin_n6"]
b = Bounds(lower=jnp.asarray(p.lower, jnp.float64), upper=jnp.asarray(p.upper, jnp.float64))
x0 = jnp.full((2,), -0.5, jnp.float64)
keys = jax.random.split(jax.random.key(42), 8)

# (tag, method, config, restarts)
trials = [
    ("de64x10-ms8", "de", dataclasses.replace(de.DEConfig(strategy="random"), pop_size=64, max_iter=10000, best_value_no_change=1000), 8),
    ("nm-ms256x10", "nelder_mead", dataclasses.replace(nelder_mead.NelderMeadConfig(), max_iter=5000), 256),
    ("pso64x10-ms8", "pso", dataclasses.replace(pso.PSOConfig(), n_particles=64, max_iter=50000, best_value_no_change=5000), 8),
]
for tag, m, cfg, r in trials:
    try:
        if m == "nelder_mead":
            res = jax.jit(lambda x0, k: nlsolver_tpu.minimize(p.fn, x0, method=m, config=cfg, key=k, restarts=r, bounds=b))(x0, jax.random.key(7))
            d = float(p.distance_to_nearest_minimum(res.x))
            print(f"{tag}: d={d:.4f} x={res.x}", flush=True)
        else:
            res = jax.jit(jax.vmap(lambda k: nlsolver_tpu.minimize(p.fn, x0, method=m, config=cfg, key=k, restarts=r, bounds=b)))(keys)
            ds = jax.vmap(p.distance_to_nearest_minimum)(res.x)
            print(f"{tag}: pass {int(jnp.sum(ds<=0.05))}/8 best_d={float(jnp.min(ds)):.4f}", flush=True)
    except Exception as e:
        print(tag, "ERROR", repr(e)[:100], flush=True)
