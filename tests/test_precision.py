"""Precision guard: every matrix product in a solver step runs at HIGHEST.

At default precision a float32 ``dot_general`` may run in TF32 on a GPU,
which rounds every operand to a 10-bit mantissa.  The CPU never does, so
no numerical test here can see the difference; instead each engine's
whole solve is traced and every ``dot_general`` in the jaxpr (loop
bodies, branches and custom rules included) must carry
``Precision.HIGHEST`` on both operands.
"""
import jax
import jax.numpy as jnp
import pytest
from jax import lax
from jax.extend import core as jex_core

import nlsolver_tpu
from nlsolver_tpu.core import Bounds
from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.solvers import (bfgs, cgd, cmaes, cmaes_fleet, de, gd,
                                  lbfgs, lbfgsb, lm)

F32 = jnp.float32
rosen = PROBLEMS["rosenbrock"].fn


def _subjaxprs(value):
    if isinstance(value, jex_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def dot_precisions(jaxpr):
    """Precision params of every dot_general, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                out.extend(dot_precisions(sub))
    return out


def _exp_residual(p, y):
    t = jnp.linspace(0.0, 2.0, y.shape[0], dtype=y.dtype)
    return p[0] * jnp.exp(-p[1] * t) - y


def _fleet_data():
    return jnp.ones((4, 6), F32), jnp.ones((2, 4), F32)


x2 = jnp.asarray([-0.5, -0.5], F32)
ENGINES = {
    "de_batched_uniform": lambda: nlsolver_tpu.minimize(
        rosen, jnp.ones((4, 2), F32), "de",
        de.DEConfig(pop_size=8, max_iter=3), layout="batched"),
    "bfgs": lambda: nlsolver_tpu.minimize(
        rosen, x2, "bfgs", bfgs.BFGSConfig(max_iter=3)),
    "bfgs_fleet": lambda: nlsolver_tpu.minimize(
        rosen, jnp.ones((2, 4), F32), "bfgs", layout="fleet"),
    "lbfgs": lambda: nlsolver_tpu.minimize(
        rosen, x2, "lbfgs", lbfgs.LBFGSConfig(max_iter=3)),
    "lbfgsb": lambda: nlsolver_tpu.minimize(
        rosen, x2, "lbfgsb", lbfgsb.LBFGSBConfig(max_iter=3),
        bounds=Bounds(jnp.full((2,), -2.0, F32), jnp.full((2,), 2.0, F32))),
    "cgd": lambda: nlsolver_tpu.minimize(
        rosen, x2, "cgd", cgd.CGDConfig(max_iter=3)),
    "gd_linesearch": lambda: nlsolver_tpu.minimize(
        rosen, x2, "gd", gd.GDConfig(step_type="linesearch", max_iter=3)),
    "lm": lambda: nlsolver_tpu.minimize(
        rosen, x2, "lm", lm.LMConfig(max_iter=3)),
    "cmaes": lambda: nlsolver_tpu.minimize(
        rosen, x2, "cmaes", cmaes.CMAESConfig(max_iter=3),
        key=jax.random.key(0)),
    "cmaes_fleet_jacobi": lambda: nlsolver_tpu.minimize(
        rosen, jnp.ones((2, 4), F32), "cmaes",
        cmaes_fleet.CMAESFleetConfig(max_iter=3), layout="fleet",
        key=jax.random.key(0)),
    "cmaes_fleet_xla": lambda: nlsolver_tpu.minimize(
        rosen, jnp.ones((2, 4), F32), "cmaes",
        cmaes_fleet.CMAESFleetConfig(max_iter=3, eigh_method="xla"),
        layout="fleet", key=jax.random.key(0)),
    "nlls_fit": lambda: nlsolver_tpu.fit(
        lambda p: _exp_residual(p, jnp.ones((6,), F32)),
        jnp.ones((2,), F32)),
    "nlls_fleet_cholesky": lambda: nlsolver_tpu.fit_fleet(
        _exp_residual, _fleet_data()[1],
        nlsolver_tpu.NLLSFleetConfig(max_iter=3), data=_fleet_data()[0]),
    "nlls_fleet_qr": lambda: nlsolver_tpu.fit_fleet(
        _exp_residual, _fleet_data()[1],
        nlsolver_tpu.NLLSFleetConfig(max_iter=3, solve="qr"),
        data=_fleet_data()[0]),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_every_product_is_highest(engine):
    jaxpr = jax.make_jaxpr(ENGINES[engine])().jaxpr
    precisions = dot_precisions(jaxpr)
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    bad = [p for p in precisions if p != highest]
    assert not bad, f"{engine}: {len(bad)} of {len(precisions)} products " \
        f"below HIGHEST: {bad[:4]}"
