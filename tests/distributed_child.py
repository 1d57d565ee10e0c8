"""Child process for the 2-process distributed test (not a test module).

Usage: python distributed_child.py <process_id> <num_processes> <port>

Each process owns 2 virtual CPU devices (XLA_FLAGS set by the parent), so
2 processes form a 4-device global mesh (dp=2 spanning processes — the
cross-host axis — pop=2 within a process).  Runs `minimize_islands` on the global
mesh and prints this process's addressable slice of the result so the
parent can stitch the global vector and compare it bit-for-bit with a
single-process run (per-agent streams are derived with fold_in, so results
are invariant to the mesh/process layout).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

from nlsolver_tpu.parallel import distributed  # noqa: E402

distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, jax.devices()
assert jax.local_device_count() == 2

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from nlsolver_tpu.parallel import de_island, distributed as dist  # noqa: E402
from nlsolver_tpu.problems import PROBLEMS  # noqa: E402
from nlsolver_tpu.solvers.de import DEConfig  # noqa: E402

B, n = 8, 5
mesh = dist.global_mesh(pop=2)
assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"dp": 2, "pop": 2}
# the dp axis must span processes (collectives inside a pop row stay local)
assert mesh.devices[0, 0].process_index == 0
assert mesh.devices[1, 0].process_index == nproc - 1

cfg = DEConfig(pop_size=16, max_iter=150)
fn = PROBLEMS["sphere"].fn

# host-local construction of this process's instance slice, then global
# array assembly — the multi-host data-loading path from the module doc
start, stop = dist.process_slice(B)
x0_all = np.linspace(-2.0, 2.0, B * n, dtype=np.float32).reshape(B, n)
keys_all = jax.random.key_data(jax.random.split(jax.random.key(7), B))
shard = NamedSharding(mesh, P("dp", None))
x0 = jax.make_array_from_process_local_data(shard, x0_all[start:stop])
keys_raw = jax.make_array_from_process_local_data(shard, np.asarray(keys_all)[start:stop])


@jax.jit
def run(x0, keys_raw):
    res = de_island.minimize_islands(
        fn, x0, cfg, mesh, keys=jax.random.wrap_key_data(keys_raw)
    )
    return res.f_value, res.x

f_value, x = run(x0, keys_raw)
jax.block_until_ready((f_value, x))

for s in f_value.addressable_shards:
    if s.replica_id == 0:
        rows = np.asarray(s.data).reshape(-1)
        base = s.index[0].start or 0
        for j, v in enumerate(rows):
            print(f"RESULT {base + j} {v!r}", flush=True)
print(f"OK process={pid}", flush=True)
