"""Multi-host launch helpers.

The reference is a single process by design; scaling this framework across
hosts is the JAX runtime's job (SURVEY.md §5 "Distributed communication
backend"): `jax.distributed.initialize` + one global mesh whose dp axis
spans hosts.  Within a GPU host the cards are joined all to all by NVLink;
between hosts collectives cross the network, so the cheap dp axis is the
one laid across hosts.

Typical launcher (same script on every host, one process per host):

    from nlsolver_tpu.parallel import distributed, make_mesh
    distributed.initialize(coordinator_address="host0:1234",
                           num_processes=2, process_id=rank)
    mesh = distributed.global_mesh(pop=4)
    # shard_map programs from de_sharded / pso_sharded / nlls_sharded work
    # unchanged: the dp axis now spans all hosts' devices.

Host-local data loading: `process_slice(B)` gives this host's instance
range for building its shard of x0s/keys; `jax.make_array_from_process_
local_data` assembles the global arrays.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax

from .mesh import DP_AXIS, POP_AXIS, make_mesh


def initialize(**kwargs) -> None:
    """Initialize the multi-host runtime.

    Pass coordinator_address/num_processes/process_id explicitly: nothing
    on a GPU host announces a cluster.  With explicit kwargs failures
    propagate; without them a single-process
    run that cannot auto-detect a coordinator is fine and stays local.
    Exercised for real (2 CPU processes over a localhost coordinator) by
    tests/test_distributed.py.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        if kwargs:
            raise
        # single-process run without coordinator info: fine


def global_mesh(dp: Optional[int] = None, pop: Optional[int] = None):
    """(dp, pop) mesh over ALL processes' devices.

    The dp (instance) axis is laid out to span hosts — population
    collectives (all_gather/pmin in de_sharded/pso_sharded) then stay
    within a host's devices (NVLink), while the dp axis only carries the
    cheap psum termination bit across the network.
    """
    n = len(jax.devices())
    if pop is None:
        local = jax.local_device_count()
        pop = math.gcd(local, n)
    return make_mesh(n, dp=dp, pop=pop)


def process_slice(batch: int) -> Tuple[int, int]:
    """[start, stop) instance range owned by this process for host-local
    data construction."""
    p = jax.process_count()
    i = jax.process_index()
    per = batch // p
    if batch % p:
        raise ValueError(f"batch {batch} must divide across {p} processes")
    return i * per, (i + 1) * per
