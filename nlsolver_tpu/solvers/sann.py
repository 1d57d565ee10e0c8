"""Simulated Annealing (SANN).

Re-creation of the reference's ``SANN`` class (nlsolver.h:2744-2815), an
R-optim-style Boltzmann-annealing sampler:

  * cooling schedule t = T_max / log(iter + e - 1) (nlsolver.h:2792-2793);
  * Gaussian Markov kernel: p_try = p + (t / T_max) * N(0, I)
    (nlsolver.h:2795-2800);
  * standard Metropolis acceptance against the CURRENT chain value:
    accept when f(p_try) <= f(p) or U < exp(-(f(p_try) - f(p)) / t).
    The reference compares against the best value seen so far instead
    (nlsolver.h:2803-2804), which permanently freezes the chain once it
    random-walks into a high-energy region (nothing near a bad point beats
    the global best, so every proposal is rejected forever); set
    ``metropolis_vs_best=True`` for parity with that behavior;
  * ``temperature_iter - 1`` inner proposals per outer iteration (the
    reference's inner loop runs j = 1 .. temperature_iter-1,
    nlsolver.h:2794), terminating only on max_iter (nlsolver.h:2787).

The inner loop is a ``lax.scan`` over the proposals of one temperature
stage; the proposals are inherently sequential (a Markov chain), so the
batch axis for throughput is problem instances via ``vmap``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core import (
    Bounds,
    Objective,
    SolverResult,
    drive,
    make_result,
    signed,
)


@dataclass(frozen=True)
class SANNConfig:
    """Defaults from nlsolver.h:2757-2759."""

    max_iter: int = 5000
    temperature_iter: int = 10
    temperature_max: float = 10.0
    metropolis_vs_best: bool = False  # reference-parity quirk (see module doc)


class SANNState(NamedTuple):
    p: jax.Array            # current Markov-chain point
    f_p: jax.Array          # objective at p
    x_best: jax.Array       # best point seen
    best_value: jax.Array
    iteration: jax.Array
    nfev: jax.Array
    key: jax.Array
    done: jax.Array
    converged: jax.Array


E_MINUS_1 = 1.7182818  # reference truncation (nlsolver.h:2779)


def init(fn: Objective, x0: jax.Array, config: SANNConfig, key: jax.Array) -> SANNState:
    val = fn(x0)
    return SANNState(
        p=x0,
        f_p=val,
        x_best=x0,
        best_value=val,
        iteration=jnp.int32(0),
        nfev=jnp.int32(1),
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )


def step(fn: Objective, state: SANNState, config: SANNConfig) -> SANNState:
    dtype = state.p.dtype
    n = state.p.shape[-1]

    done_now = state.iteration >= config.max_iter
    halted = state._replace(done=jnp.asarray(True))

    t = config.temperature_max / jnp.log(
        state.iteration.astype(dtype) + E_MINUS_1
    )
    scale = t / config.temperature_max

    def proposal(carry, k):
        p, f_p, x_best, best_value = carry
        k_step, k_accept = jax.random.split(k)
        p_try = p + scale * jax.random.normal(k_step, (n,), dtype)
        val = fn(p_try)
        anchor = best_value if config.metropolis_vs_best else f_p
        diff = val - anchor
        u = jax.random.uniform(k_accept, (), dtype=dtype)
        accept = (diff <= 0.0) | (u < jnp.exp(-diff / t))
        p = jnp.where(accept, p_try, p)
        f_p = jnp.where(accept, val, f_p)
        better = accept & (val <= best_value)
        x_best = jnp.where(better, p_try, x_best)
        best_value = jnp.where(better, val, best_value)
        return (p, f_p, x_best, best_value), None

    n_inner = config.temperature_iter - 1
    key, k_inner = jax.random.split(state.key)
    (p, f_p, x_best, best_value), _ = lax.scan(
        proposal,
        (state.p, state.f_p, state.x_best, state.best_value),
        jax.random.split(k_inner, n_inner),
    )

    worked = SANNState(
        p=p,
        f_p=f_p,
        x_best=x_best,
        best_value=best_value,
        iteration=state.iteration + 1,
        nfev=state.nfev + n_inner,
        key=key,
        done=jnp.asarray(False),
        converged=jnp.asarray(False),
    )
    from ..core.utils import tree_where

    return tree_where(done_now, halted, worked)


def _finalize(state: SANNState, flip_sign: bool) -> SolverResult:
    f_val = state.best_value
    return make_result(
        x=state.x_best,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.done,  # SANN terminates only on max_iter (:2787)
    )


def minimize(
    fn: Objective,
    x0: jax.Array,
    config: SANNConfig = SANNConfig(),
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    _minimize: bool = True,
) -> SolverResult:
    if key is None:
        key = jax.random.key(0)
    sfn = signed(fn, _minimize)
    state = init(sfn, x0, config, key)
    state = drive(lambda s: step(sfn, s, config), state)
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: SANNConfig = SANNConfig(), bounds=None, *, key=None):
    return minimize(fn, x0, config, bounds, key=key, _minimize=False)
