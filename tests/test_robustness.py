"""Failure-mode and dtype robustness.

SURVEY.md §5 "failure detection": the reference's recoveries are algorithmic
(BFGS H-reset, LM lambda escalation, linesearch bailouts, bracket guards).
These tests drive those paths plus float32 behavior — the dtype everything
runs in on the device (the f64 parity tests run under x64 on CPU).
"""
import jax
import jax.numpy as jnp
import pytest

from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.solvers import bfgs, de, lm, nelder_mead, rootfind
from nlsolver_tpu.solvers.bfgs import BFGSConfig
from nlsolver_tpu.solvers.de import DEConfig
from nlsolver_tpu.solvers.lm import LMConfig
from nlsolver_tpu.solvers.nelder_mead import NelderMeadConfig

TOL = 0.05


@pytest.mark.parametrize(
    "name", ["sphere", "rosenbrock", "booth", "matyas", "ackley"]
)
def test_float32_convergence(name, key):
    # f32 is the fleets' execution dtype; parity tests run f64 — make sure the
    # algorithms don't silently depend on double precision
    p = PROBLEMS[name]
    x0 = jnp.full((p.dim,), -0.5, jnp.float32)
    res = jax.jit(lambda x: nelder_mead.minimize(p.fn, x, NelderMeadConfig()))(x0)
    assert res.x.dtype == jnp.float32
    assert float(p.distance_to_nearest_minimum(res.x.astype(jnp.float64))) <= TOL

    res = jax.jit(lambda x, k: de.minimize(p.fn, x, DEConfig(), key=k))(x0, key)
    assert float(p.distance_to_nearest_minimum(res.x.astype(jnp.float64))) <= TOL


def test_bfgs_recovers_from_nan_region():
    # sqrt produces NaN gradients for x<0 regions; BFGS must terminate
    # cleanly (reset path + isinf/isnan guards), not hang or return garbage
    fn = lambda x: jnp.sqrt(jnp.abs(x[0]) + 1e-12) + (x[1] - 1.0) ** 2
    res = jax.jit(lambda x: bfgs.minimize(fn, x, BFGSConfig(max_iter=50)))(
        jnp.asarray([0.5, -0.5])
    )
    assert int(res.iterations) <= 50  # terminated


def test_bfgs_reset_on_nonconvex_start():
    # start where the Hessian is indefinite: curvature check must reset H=I
    # and still reach the minimum
    p = PROBLEMS["styblinski_tang"]
    res = jax.jit(lambda x: bfgs.minimize(p.fn, x, BFGSConfig()))(
        jnp.asarray([-0.5, -0.5])
    )
    assert float(p.distance_to_nearest_minimum(res.x)) <= TOL


def test_lm_on_flat_objective():
    # zero gradient everywhere: LM must stop on f_delta, not NaN-loop
    fn = lambda x: jnp.asarray(3.14, x.dtype)
    res = jax.jit(lambda x: lm.minimize(fn, x, LMConfig()))(jnp.ones(2))
    assert bool(res.converged)
    assert float(res.f_value) == pytest.approx(3.14)


def test_objective_returning_nan_terminates_everywhere():
    fn = lambda x: jnp.where(jnp.sum(x * x) > 0.5, jnp.nan, jnp.sum(x * x))
    res = jax.jit(lambda x: lm.minimize(fn, x, LMConfig(max_iter=30)))(
        jnp.asarray([1.0, 1.0])
    )
    assert int(res.iterations) <= 30


def test_rootfinder_identical_endpoints():
    r = jax.jit(lambda: rootfind.bisection(lambda x: x, 2.0, 2.0))()
    assert not bool(r.bracketed)


def test_de_zero_width_init(key):
    # x0 = 0 makes the reference's width-style init collapse the population
    # to the origin; solver must still terminate (std_err = 0 -> converged)
    fn = PROBLEMS["sphere"].fn
    res = jax.jit(lambda x, k: de.minimize(fn, x, DEConfig(), key=k))(
        jnp.zeros(2), key
    )
    assert bool(res.converged)


def test_maximize_all_families(key):
    neg_sphere = lambda x: -jnp.sum((x - 1.0) ** 2)
    from nlsolver_tpu.solvers import cgd, cmaes, gd, lbfgs, nmpso, pso, sann

    for mod in (nelder_mead, de, pso, sann, nmpso, cgd, bfgs, lbfgs, cmaes):
        res = jax.jit(lambda x, k: mod.maximize(neg_sphere, x, key=k))(
            jnp.asarray([0.3, -0.2]), key
        )
        assert float(res.f_value) > -0.25, (mod.__name__, float(res.f_value))
