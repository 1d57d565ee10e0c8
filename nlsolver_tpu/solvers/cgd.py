"""Conjugate gradient descent (Fletcher-Reeves) with Armijo line search.

Re-creation of the reference's ``ConjugatedGradientDescent``
(nlsolver.h:3037-3129): beta = <g_new, g_new> / <g_old, g_old>
(nlsolver.h:3116-3120), Armijo backtracking restarted from the configured
alpha each iteration (nlsolver.h:3107-3108), termination on max_iter,
||g|| < grad_eps, or infinite gradient norm (nlsolver.h:3100-3101).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import Bounds, Objective, SolverResult, drive, make_result, signed
from ..core.utils import HIGHEST
from ..deriv import Deriv, make_grad
from ..linesearch import armijo


@dataclass(frozen=True)
class CGDConfig:
    """Defaults from nlsolver.h:3046-3050."""

    max_iter: int = 500
    grad_eps: float = 5e-3
    alpha: float = 0.03
    deriv: Deriv = field(default_factory=Deriv)


class CGDState(NamedTuple):
    x: jax.Array
    gradient: jax.Array
    direction: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    gfev: jax.Array
    done: jax.Array
    converged: jax.Array


def init(fn: Objective, x0: jax.Array, config: CGDConfig) -> CGDState:
    grad_fn, g_cost = make_grad(fn, x0.shape[-1], config.deriv)
    g = grad_fn(x0)
    return CGDState(
        x=x0,
        gradient=g,
        direction=-g,
        iteration=jnp.int32(0),
        nfev=jnp.int32(g_cost),
        gfev=jnp.int32(1),
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(fn: Objective, state: CGDState, config: CGDConfig) -> CGDState:
    n = state.x.shape[-1]
    grad_fn, g_cost = make_grad(fn, n, config.deriv)

    grad_norm = jnp.linalg.norm(state.gradient)
    hit_tol = grad_norm < config.grad_eps
    done_now = (
        (state.iteration >= config.max_iter) | hit_tol | jnp.isinf(grad_norm)
    )
    halted = state._replace(done=jnp.asarray(True), converged=hit_tol)

    f0 = fn(state.x)  # armijo overload evaluates f(x) (nlsolver.h:1853)
    ls = armijo(fn, state.x, f0, state.gradient, state.direction, config.alpha)
    new_x = state.x + ls.alpha * state.direction

    denom = jnp.dot(state.gradient, state.gradient, precision=HIGHEST)
    new_grad = grad_fn(new_x)
    beta = jnp.dot(new_grad, new_grad, precision=HIGHEST) / denom  # Fletcher-Reeves
    new_dir = beta * state.direction - new_grad

    worked = CGDState(
        x=new_x,
        gradient=new_grad,
        direction=new_dir,
        iteration=state.iteration + 1,
        nfev=state.nfev + 1 + ls.nfev + g_cost,
        gfev=state.gfev + 1,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(fn, state: CGDState, flip_sign: bool) -> SolverResult:
    f_val = fn(state.x)
    return make_result(
        x=state.x,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev + 1,
        gradient_calls=state.gfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: CGDConfig = CGDConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key=None,
    _minimize: bool = True,
) -> SolverResult:
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config)
    state = drive(lambda s: step(sfn, s, config), state)
    return _finalize(sfn, state, flip_sign=not _minimize)


def maximize(fn, x0, config: CGDConfig = CGDConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
