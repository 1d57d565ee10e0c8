"""Armijo backtracking line search (reference: armijo_search,
nlsolver.h:1805-1865; c=0.2, rho=0.9).

The reference's ``while`` can spin forever on a non-descent direction; here
the loop is additionally bounded (0.9^200 ~ 7e-10 leaves alpha effectively
zero), which keeps the jitted program total.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.utils import HIGHEST

C = 0.2
RHO = 0.9
MAX_BACKTRACKS = 200


class ArmijoResult(NamedTuple):
    alpha: jax.Array
    nfev: jax.Array


def armijo(fn, x, f0, g0, direction, alpha0) -> ArmijoResult:
    """Backtrack alpha until f(x + alpha d) <= f0 + alpha * c * <g0, d>."""
    dtype = x.dtype
    limit = jnp.dot(g0, direction, precision=HIGHEST) * C

    def phi(alpha):
        return fn(x + alpha * direction)

    alpha = jnp.asarray(alpha0, dtype)
    val = phi(alpha)

    def cond(state):
        alpha, val, k = state
        return (val > f0 + alpha * limit) & (k < MAX_BACKTRACKS)

    def body(state):
        alpha, _, k = state
        alpha = alpha * RHO
        return alpha, phi(alpha), k + 1

    alpha, _, k = lax.while_loop(cond, body, (alpha, val, jnp.int32(0)))
    return ArmijoResult(alpha=alpha, nfev=k + 1)
