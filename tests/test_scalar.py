"""Brent minimizer + the seven root finders, single and vmapped batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsolver_tpu.solvers import brent as brent_min
from nlsolver_tpu.solvers.brent import BrentConfig
from nlsolver_tpu.solvers.rootfind import (
    ALL_FINDERS,
    bisection,
    brent,
    chandrupatla,
    false_position,
    itp,
    ridders,
    tiruneh,
)

BRACKETING = ["bisection", "false_position", "brent", "ridders", "itp", "chandrupatla"]


def f_cubic(x):
    return x**3 - 2.0 * x - 5.0  # real root ~2.0945514815


def f_cos(x):
    return jnp.cos(x) - x  # root ~0.7390851332


def f_decreasing(x):
    return 1.0 - x  # root at 1; f decreasing (breaks the reference's update)


ROOT = {"cubic": 2.0945514815423265, "cos": 0.7390851332151607, "dec": 1.0}


@pytest.mark.parametrize("name", BRACKETING)
def test_bracketing_finders(name):
    finder = ALL_FINDERS[name]
    tol = 1e-3 if name == "ridders" else 1e-5  # ridders caps at 5 iterations
    r = jax.jit(lambda: finder(f_cubic, 1.0, 3.0))()
    assert bool(r.bracketed)
    assert abs(float(r.x) - ROOT["cubic"]) < tol, (name, float(r.x))
    r = jax.jit(lambda: finder(f_cos, 0.0, 2.0))()
    assert abs(float(r.x) - ROOT["cos"]) < tol, (name, float(r.x))


@pytest.mark.parametrize("name", BRACKETING)
def test_sign_aware_on_decreasing(name):
    # the reference loses the bracket when f decreases through the root
    finder = ALL_FINDERS[name]
    r = jax.jit(lambda: finder(f_decreasing, 0.0, 3.0))()
    assert abs(float(r.x) - 1.0) < 1e-3, (name, float(r.x))


@pytest.mark.parametrize("name", BRACKETING)
def test_unbracketed_flagged(name):
    finder = ALL_FINDERS[name]
    r = jax.jit(lambda: finder(f_cubic, 3.0, 5.0))()  # no root in [3,5]
    assert not bool(r.bracketed)
    assert not bool(r.converged)


def test_tiruneh():
    r = jax.jit(lambda: tiruneh(f_cos, (-100.0, 0.0, 100.0)))()
    assert abs(float(r.x) - ROOT["cos"]) < 1e-4, float(r.x)


def test_vmapped_rootfinding_batch():
    # a batch of shifted roots solved in one compiled program
    shifts = jnp.linspace(0.5, 1.5, 64)
    g = lambda shift: brent(lambda x: jnp.cos(x) - x * shift, 0.0, 2.0)
    res = jax.jit(jax.vmap(g))(shifts)
    # residuals at the found roots are ~0
    resid = jnp.cos(res.x) - res.x * shifts
    assert float(jnp.max(jnp.abs(resid))) < 1e-9


def test_brent_minimizer():
    # min of (x-2)^2 + 1 on [-5, 5]
    res = jax.jit(
        lambda: brent_min.minimize_scalar(lambda x: (x - 2.0) ** 2 + 1.0)
    )()
    assert abs(float(res.x) - 2.0) < 1e-6
    assert abs(float(res.f_value) - 1.0) < 1e-9
    assert bool(res.converged)


def test_brent_minimizer_maximize():
    res = jax.jit(
        lambda: brent_min.minimize_scalar(lambda x: -((x + 1.0) ** 2), _minimize=False)
    )()
    assert abs(float(res.x) + 1.0) < 1e-6
    assert abs(float(res.f_value)) < 1e-9


def test_brent_minimizer_boundary():
    # monotone function: minimizer at the boundary
    res = jax.jit(
        lambda: brent_min.minimize_scalar(lambda x: x, BrentConfig(lower=0.0, upper=1.0))
    )()
    assert float(res.x) < 1e-5


def test_brent_minimizer_vmapped():
    centers = jnp.linspace(-3.0, 3.0, 32)
    res = jax.jit(
        jax.vmap(lambda c: brent_min.minimize_scalar(lambda x: (x - c) ** 2))
    )(centers)
    assert float(jnp.max(jnp.abs(res.x - centers))) < 1e-5


@pytest.mark.parametrize("variant", ["fixed", "reference"])
def test_itp_float32_fleet(variant):
    """The reference's ITP never shrinks its projection radius, so in
    float32 a step that lands on a bracket end repeats until max_iter; the
    default (the paper's radius eps 2^(n_max - j)) keeps ITP's
    bisection-like worst case."""
    cs = jnp.linspace(0.1, 7.9, 2000, dtype=jnp.float32)
    res = jax.jit(jax.vmap(lambda c: itp(
        lambda x: x * x * x - c, jnp.float32(0.0), jnp.float32(2.0),
        tol=1e-7, eps=1e-7, variant=variant)))(cs)
    exact = np.cbrt(np.asarray(cs, np.float64))
    rel = np.abs(np.asarray(res.x, np.float64) - exact) / exact
    if variant == "fixed":
        assert float(rel.max()) <= 1e-6
        assert int(jnp.max(res.iterations)) <= 30
    else:
        assert int(jnp.max(res.iterations)) == 200
        assert float(rel.max()) > 1e-6
