"""Dimension-sharded L-BFGS for very large n.

The reference's "big axis" pressure points are population size and problem
dimension (SURVEY.md §5: the counterpart of sequence parallelism is
population- and dimension-sharding).  For huge-n smooth problems the n-axis
itself is sharded over the mesh:

  * x, gradient and the [m, n] history rings are split over the ``pop``
    axis (reused as the dimension axis here);
  * the two-loop recursion's only cross-shard operations are inner products
    — each becomes a local partial dot + ``psum``; all axpys stay
    local;
  * the line search evaluates the objective on the sharded point; the
    objective must itself be written shard-locally (it receives this
    shard's slice plus the axis name for its own reductions).

The objective signature here is ``fn_local(x_local) -> partial`` whose
``psum`` over the dim axis is the true objective — the natural form for
separable-plus-coupling objectives at n ~ 1e6+.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from ..core import SolverResult, make_result
from ..core.utils import HIGHEST
from .mesh import POP_AXIS

DIM_AXIS = POP_AXIS  # the mesh's second axis doubles as the dimension axis


def _pdot(a, b):
    return lax.psum(jnp.dot(a, b, precision=HIGHEST), DIM_AXIS)


def minimize_dim_sharded(
    fn_local: Callable,     # local-shard objective contribution
    grad_local: Callable,   # d(global objective)/d(x_local) given x_local
    x0: jax.Array,          # [n] global start point
    mesh,
    memory: int = 10,
    max_iter: int = 100,
    grad_eps: float = 1e-8,
    ls_shrink: float = 0.5,
    ls_max: int = 30,
) -> SolverResult:
    """L-BFGS over a dimension-sharded parameter vector.

    Uses a backtracking Armijo line search (each trial is one psum) rather
    than More-Thuente to keep cross-shard traffic minimal.
    """
    n = x0.shape[0]
    shards = mesh.shape[DIM_AXIS]
    if n % shards:
        raise ValueError(f"dimension {n} must divide over {shards} shards")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(DIM_AXIS),),
        out_specs=(P(DIM_AXIS), P(), P(), P(), P()),
        check_vma=False,
    )
    def solve(x_loc):
        m = memory

        def f_global(xl):
            return lax.psum(fn_local(xl), DIM_AXIS)

        g0 = grad_local(x_loc)
        n_loc = x_loc.shape[0]

        state = dict(
            x=x_loc,
            g=g0,
            f=f_global(x_loc),
            s_hist=jnp.zeros((m, n_loc), x_loc.dtype),
            y_hist=jnp.zeros((m, n_loc), x_loc.dtype),
            rho=jnp.zeros((m,), x_loc.dtype),
            valid=jnp.zeros((m,), bool),
            head=jnp.int32(0),
            it=jnp.int32(0),
            nfev=jnp.int32(1),
            done=jnp.asarray(False),
            conv=jnp.asarray(False),
        )

        def two_loop(g, s_h, y_h, rho, valid, head):
            def first(i, carry):
                q, alphas = carry
                idx = (head - 1 - i) % m
                ok = valid[idx]
                a = jnp.where(ok, rho[idx] * _pdot(s_h[idx], q), 0.0)
                return q - a * y_h[idx], alphas.at[idx].set(a)

            q, alphas = lax.fori_loop(0, m, first, (g, jnp.zeros(m, g.dtype)))
            newest = (head - 1) % m
            ys = _pdot(s_h[newest], y_h[newest])
            yy = _pdot(y_h[newest], y_h[newest])
            gamma = jnp.where(valid[newest] & (yy > 0), ys / yy, 1.0)
            r = gamma * q

            def second(i, r):
                idx = (head + i) % m
                ok = valid[idx]
                b = jnp.where(ok, rho[idx] * _pdot(y_h[idx], r), 0.0)
                return r + (alphas[idx] - b) * s_h[idx]

            return -lax.fori_loop(0, m, second, r)

        def body(st):
            gnorm = jnp.sqrt(_pdot(st["g"], st["g"]))
            hit = gnorm < grad_eps
            done_now = (st["it"] >= max_iter) | hit

            d = two_loop(
                st["g"], st["s_hist"], st["y_hist"], st["rho"],
                st["valid"], st["head"],
            )
            slope = _pdot(st["g"], d)
            bad = slope >= 0
            d = jnp.where(bad, -st["g"], d)
            slope = jnp.where(bad, -_pdot(st["g"], st["g"]), slope)

            # backtracking Armijo: one psum per trial
            def ls_cond(c):
                alpha, f_new, k = c
                return (f_new > st["f"] + 1e-4 * alpha * slope) & (k < ls_max)

            def ls_body(c):
                alpha, _, k = c
                alpha = alpha * ls_shrink
                return alpha, f_global(st["x"] + alpha * d), k + 1

            f1 = f_global(st["x"] + d)
            alpha, f_new, k = lax.while_loop(
                ls_cond, ls_body, (jnp.asarray(1.0, st["x"].dtype), f1, jnp.int32(0))
            )

            s = alpha * d
            x_new = st["x"] + s
            g_new = grad_local(x_new)
            y = g_new - st["g"]
            ys = _pdot(y, s)
            good = ys > 1e-10
            idx = st["head"] % m
            new = dict(
                x=x_new,
                g=g_new,
                f=f_new,
                s_hist=st["s_hist"].at[idx].set(jnp.where(good, s, st["s_hist"][idx])),
                y_hist=st["y_hist"].at[idx].set(jnp.where(good, y, st["y_hist"][idx])),
                rho=st["rho"].at[idx].set(jnp.where(good, 1.0 / ys, st["rho"][idx])),
                valid=st["valid"].at[idx].set(good | st["valid"][idx]),
                head=jnp.where(good, st["head"] + 1, st["head"]),
                it=st["it"] + 1,
                nfev=st["nfev"] + k + 1,
                done=jnp.asarray(False),
                conv=jnp.asarray(False),
            )
            halted = dict(st, done=jnp.asarray(True), conv=hit)
            return {
                key: jnp.where(done_now, halted[key], new[key])
                if jnp.asarray(new[key]).ndim == 0
                else jnp.where(done_now, halted[key], new[key])
                for key in new
            }

        final = lax.while_loop(lambda s: ~s["done"], body, state)
        return final["x"], final["f"], final["it"], final["nfev"], final["conv"]

    x, f, it, nfev, conv = solve(x0)
    return make_result(
        x=x, f_value=f, iterations=it, function_calls=nfev, converged=conv
    )
