"""Batch-minor NLLS fleet (solvers/nlls_fleet.py): parity with the vmapped
scalar driver across both solve backends."""
import jax
import jax.numpy as jnp
import pytest

from nlsolver_tpu.solvers import nlls as nlls_mod
from nlsolver_tpu.solvers import nlls_fleet as nf


@pytest.fixture(scope="module")
def expfit():
    B, m = 64, 32
    t = jnp.linspace(0.0, 2.0, m, dtype=jnp.float32)
    k1, k2 = jax.random.split(jax.random.key(0))
    amps = jax.random.uniform(k1, (B,), jnp.float32, 1.0, 3.0)
    rates = jax.random.uniform(k2, (B,), jnp.float32, 0.5, 2.0)
    ys = amps[:, None] * jnp.exp(-rates[:, None] * t[None, :])
    residual = lambda p, y_i: p[0] * jnp.exp(-p[1] * t) - y_i
    return residual, ys, amps, rates


@pytest.mark.parametrize("solve", ["cholesky", "qr"])
def test_fleet_solves_expfits(expfit, solve):
    residual, ys, amps, rates = expfit
    B = ys.shape[0]
    cfg = nf.NLLSFleetConfig(max_iter=30, solve=solve)
    res = jax.jit(
        lambda X: nf.fit_fleet(residual, X, cfg, data=ys)
    )(jnp.ones((2, B), jnp.float32))
    assert res.x.shape == (2, B)
    assert float(jnp.mean((res.f_value < 1e-6))) == 1.0
    # recovered parameters match the generators
    assert float(jnp.max(jnp.abs(res.x[0] - amps))) < 1e-2
    assert float(jnp.max(jnp.abs(res.x[1] - rates))) < 1e-2


def test_fleet_matches_vmapped_scalar(expfit):
    """Same algorithm, same lambda schedule => same accept/reject path and
    (to f32 roundoff) the same iterates as solvers.nlls under vmap."""
    residual, ys, _, _ = expfit
    B = ys.shape[0]
    fleet = jax.jit(
        lambda X: nf.fit_fleet(
            residual, X, nf.NLLSFleetConfig(max_iter=30), data=ys
        )
    )(jnp.ones((2, B), jnp.float32))
    ref = jax.jit(
        lambda X: nlls_mod.fit_batched(
            residual, X, nlls_mod.NLLSConfig(max_iter=30), data=ys
        )
    )(jnp.ones((B, 2), jnp.float32))
    assert float(jnp.max(jnp.abs(fleet.x - ref.x.T))) < 1e-4
    import numpy as np

    np.testing.assert_array_equal(
        np.asarray(fleet.iterations), np.asarray(ref.iterations)
    )


def test_fleet_no_data_mode():
    """data=None: one shared residual over every lane's own x."""
    target = jnp.asarray([2.0, -1.0], jnp.float32)
    residual = lambda x: x - target
    res = jax.jit(
        lambda X: nf.fit_fleet(
            residual, X, nf.NLLSFleetConfig(max_iter=20)
        )
    )(jnp.zeros((2, 16), jnp.float32))
    assert float(jnp.max(jnp.abs(res.x - target[:, None]))) < 1e-4


def test_fleet_unknown_solve_raises(expfit):
    residual, ys, _, _ = expfit
    with pytest.raises(ValueError, match="unknown solve"):
        nf.fit_fleet(
            residual,
            jnp.ones((2, ys.shape[0]), jnp.float32),
            nf.NLLSFleetConfig(solve="nope"),
            data=ys,
        )


def test_rejected_step_stall_halts_via_lambda_ceiling():
    """Advisor finding (round 4): a lane whose steps are all rejected
    after its last improvement kept a fixed |prev_cost-cost| and spun to
    max_iter.  The lambda ceiling must halt it early, converged=False."""
    import jax.numpy as jnp

    from nlsolver_tpu.solvers import nlls_fleet as nf

    # residual with a hard floor the LM step cannot improve past from
    # this start: r(x) = [|x|+1] has cost >= 1 everywhere, J = sign(x)
    def residual(p):
        return jnp.asarray([jnp.abs(p[0]) + 1.0])

    cfg = nf.NLLSFleetConfig(max_iter=10_000, lambda_max=1e6, f_delta=0.0)
    res = nf.fit_fleet(residual, jnp.ones((1, 2), jnp.float32), cfg)
    # halts long before max_iter (~log(1e6/10)/log(10) rejections)
    assert int(jnp.max(res.iterations)) < 100, res.iterations
    assert not bool(jnp.any(res.converged))
