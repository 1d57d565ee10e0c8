"""Per-iteration progress streaming for long fleet solves.

The reference prints a summary only when the solver returns
(solver_status::print, nlsolver.h:131-169).  Here an ``io_callback``-based
hook (``core.driver.attach_progress``) streams (iteration, best value,
active lanes) from the device WHILE the while_loop runs — every k
generations plus once at termination — without breaking jit, vmap, or the
fixed-point structure of the loop.

Run:  python examples/progress_monitor.py
Also measures the hook's overhead against the identical silent solve, on
JAX's default device.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.solvers import de_batched
from nlsolver_tpu.solvers.de import DEConfig


def main():
    tiny = os.environ.get("NLSOLVER_EXAMPLE_TINY") == "1"
    B, dim = (64, 4) if tiny else (2048, 10)
    fn = PROBLEMS["rastrigin"].fn
    cfg = DEConfig(pop_size=64, max_iter=60 if tiny else 400, best_value_no_change=1 << 30,
                   eps=0.0, partner_sampling="rotation")
    x0 = jnp.full((B, dim), -0.5, jnp.float32)
    keys = jax.random.split(jax.random.key(0, impl="rbg"), B)

    def report(iteration, best, active):
        print(f"  gen {iteration:4d}  best f = {best:10.6f}  "
              f"active lanes = {active}", flush=True)

    print(f"{B} x {dim}-D Rastrigin DE fleet, reporting every 50 generations:")
    run = jax.jit(lambda x0, keys: de_batched.minimize_batched(
        fn, x0, cfg, keys=keys, progress=report, progress_every=50).f_value)
    best = run(x0, keys)
    jax.block_until_ready(best)
    print(f"final best over fleet: {float(jnp.min(best)):.6f}")

    # overhead: same solve, silent vs monitored (warm jit, fetch-fenced)
    silent = jax.jit(lambda x0, keys: de_batched.minimize_batched(
        fn, x0, cfg, keys=keys).f_value)
    quiet_cb = lambda iteration, best, active: None
    monitored = jax.jit(lambda x0, keys: de_batched.minimize_batched(
        fn, x0, cfg, keys=keys, progress=quiet_cb, progress_every=50).f_value)

    def timed(f):
        float(jnp.sum(f(x0, keys)))  # warm
        t0 = time.perf_counter()
        for _ in range(3):
            float(jnp.sum(f(x0, keys)))  # device->host fetch fences
        return (time.perf_counter() - t0) / 3

    ts, tm = timed(silent), timed(monitored)
    print(f"silent: {ts*1e3:.1f} ms   monitored: {tm*1e3:.1f} ms   "
          f"overhead: {100*(tm-ts)/ts:.1f}%")


if __name__ == "__main__":
    main()
