"""Device-mesh helpers.

The reference is single-threaded by design (README.md:143-144); all
parallelism here is new design (SURVEY.md §2 "Parallelism & distributed
communication"): problem instances shard over a data-parallel axis ("dp")
and populations shard over a second axis ("pop"), with global best-member
selection via collectives.  On a GPU host every card reaches every other
over NVLink at the same rate, so the mesh shape follows the algorithm
(how many instances, how large a population), not a physical topology.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DP_AXIS = "dp"     # problem-instance (batch) axis
POP_AXIS = "pop"   # population / agent axis within one problem


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    pop: Optional[int] = None,
) -> Mesh:
    """Build a (dp, pop) mesh over the first ``n_devices`` devices.

    Default split: as square as possible, favoring the dp axis.
    """
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    devices = devices[:n]
    if dp is None and pop is None:
        pop = _largest_factor_leq(n, int(math.isqrt(n)))
        dp = n // pop
    elif dp is None:
        dp = n // pop
    elif pop is None:
        pop = n // dp
    if dp * pop != n:
        raise ValueError(f"dp*pop = {dp}*{pop} != {n} devices")
    arr = np.asarray(devices).reshape(dp, pop)
    return Mesh(arr, (DP_AXIS, POP_AXIS))


def _largest_factor_leq(n: int, k: int) -> int:
    for f in range(k, 0, -1):
        if n % f == 0:
            return f
    return 1


def population_sharding(mesh: Mesh) -> NamedSharding:
    """[B, P, n] arrays: instances over dp, agents over pop, dims replicated."""
    return NamedSharding(mesh, P(DP_AXIS, POP_AXIS, None))


def instance_sharding(mesh: Mesh) -> NamedSharding:
    """[B, ...] arrays sharded over instances only."""
    return NamedSharding(mesh, P(DP_AXIS))
