"""Multi-host batched nonlinear least-squares (BASELINE.json config #5).

A fleet of independent LM fits sharded over the mesh's dp axis: each device
runs ``vmap``-ped fits on its shard; the only cross-device traffic is the
``psum`` that keeps the outer while_loop trip count globally consistent
(same masked-lane SPMD driver as de_sharded).  Per-instance data (t, y
curves) shards with the instances, so arbitrarily large fit fleets scale
linearly across devices and hosts with zero gradient traffic.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from ..core import SolverResult, make_result
from ..core.utils import tree_where
from ..solvers import nlls
from .mesh import DP_AXIS


def fit_sharded(
    residual_fn: Callable,
    x0s: jax.Array,            # [B, n]
    config: nlls.NLLSConfig,
    mesh,
    data=None,                 # optional pytree with leading dim B
) -> SolverResult:
    B = x0s.shape[0]
    dp_size = mesh.shape[DP_AXIS]
    if B % dp_size:
        raise ValueError(f"batch {B} must divide over dp={dp_size}")

    data_specs = jax.tree_util.tree_map(lambda _: P(DP_AXIS), data)
    in_specs = (P(DP_AXIS, None), data_specs) if data is not None else (P(DP_AXIS, None),)
    out_specs = jax.tree_util.tree_map(lambda _: P(DP_AXIS), _result_struct())

    def solve_block(x0_loc, data_loc=None):
        if data_loc is None:
            states = jax.vmap(lambda x0: nlls.init(residual_fn, x0, config))(x0_loc)
            step_one = lambda x0, s: nlls.step(residual_fn, s, config)
            step_all = jax.vmap(lambda s: nlls.step(residual_fn, s, config))
        else:
            states = jax.vmap(
                lambda x0, d: nlls.init(lambda x: residual_fn(x, d), x0, config)
            )(x0_loc, data_loc)
            step_all = jax.vmap(
                lambda s, d: nlls.step(lambda x: residual_fn(x, d), s, config)
            )

        def cond(s):
            still = jnp.sum((~s.done).astype(jnp.int32))
            return lax.psum(still, DP_AXIS) > 0

        def body(s):
            new = step_all(s) if data_loc is None else step_all(s, data_loc)
            return tree_where(s.done, s, new)

        final = lax.while_loop(cond, body, states)
        return (
            final.x,
            final.cost,
            final.iteration,
            final.nfev,
            final.jev,
            final.converged,
        )

    sharded = shard_map(
        solve_block, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    if data is not None:
        x, cost, iters, nfev, jev, conv = sharded(x0s, data)
    else:
        x, cost, iters, nfev, jev, conv = sharded(x0s)
    return make_result(
        x=x,
        f_value=cost,
        iterations=iters,
        function_calls=nfev,
        gradient_calls=jev,
        converged=conv,
    )


def _result_struct():
    # mirror of solve_block's output tuple for out_specs tree mapping
    return (0, 0, 0, 0, 0, 0)
