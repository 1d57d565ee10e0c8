"""Batch-minor BFGS fleet: update equivalence, parity with the vmapped
solver, lane freezing, and the fleet More-Thuente search."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsolver_tpu.linesearch.more_thuente import more_thuente, more_thuente_fleet
from nlsolver_tpu.ops import rank2
from nlsolver_tpu.solvers import bfgs, bfgs_fleet


def _random_spd_batchminor(key, n, B):
    A = jax.random.normal(key, (B, n, n), jnp.float32)
    H = jnp.einsum("bij,bkj->bik", A, A) + 2.0 * jnp.eye(n)[None]
    return jnp.transpose(H, (1, 2, 0))  # [n, n, B]


class TestBatchMinorKernel:
    def test_jnp_matches_batched_einsum_path(self):
        key = jax.random.key(0)
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        n, B = 8, 64
        H = _random_spd_batchminor(k1, n, B)
        s = jax.random.normal(k2, (n, B), jnp.float32)
        y = jax.random.normal(k3, (n, B), jnp.float32)
        g = jax.random.normal(k4, (n, B), jnp.float32)
        rho = jax.random.uniform(k5, (B,), jnp.float32, 0.1, 2.0)
        reset = jnp.zeros((B,), bool)

        Hn, d = rank2.rank2_direction_batchminor(H, s, y, g, rho, reset)
        # against the [B, n, n] einsum formulation already tested in test_ops
        Hb = jnp.transpose(H, (2, 0, 1))
        Hn_ref = rank2.rank2_update_batched(Hb, s.T, y.T, rho)
        np.testing.assert_allclose(
            np.transpose(Hn, (2, 0, 1)), Hn_ref, rtol=2e-5, atol=2e-5
        )
        d_ref = -jnp.einsum("bij,bj->bi", Hn_ref, g.T)
        np.testing.assert_allclose(d.T, d_ref, rtol=2e-5, atol=2e-5)

    def test_reset_lanes_use_identity(self):
        key = jax.random.key(1)
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        n, B = 4, 16
        H = _random_spd_batchminor(k1, n, B)
        s = jax.random.normal(k2, (n, B), jnp.float32)
        y = jax.random.normal(k3, (n, B), jnp.float32)
        g = jax.random.normal(k4, (n, B), jnp.float32)
        rho = jax.random.uniform(k5, (B,), jnp.float32, 0.1, 2.0)
        reset = jnp.arange(B) % 2 == 0

        Hn, _ = rank2.rank2_direction_batchminor(H, s, y, g, rho, reset)
        eyeB = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32)[:, :, None], H.shape)
        Hn_id, _ = rank2.rank2_direction_batchminor(
            eyeB, s, y, g, rho, jnp.zeros((B,), bool)
        )
        np.testing.assert_allclose(
            np.asarray(Hn)[:, :, ::2], np.asarray(Hn_id)[:, :, ::2], rtol=1e-6
        )


class TestFleetMoreThuente:
    def test_matches_vmapped_scalar_search(self):
        key = jax.random.key(3)
        n, B = 6, 32
        k1, k2 = jax.random.split(key)
        centers = jax.random.normal(k1, (B, n), jnp.float32)
        X = jnp.zeros((n, B), jnp.float32)

        fn = lambda x, c: jnp.sum((x - c) ** 2) + 0.1 * jnp.sum(x**4)
        fn_cols = lambda Xc: jax.vmap(fn, in_axes=(1, 0))(Xc, centers)
        grad_cols = bfgs_fleet.grad_colwise(fn_cols)

        f0 = fn_cols(X)
        G0 = grad_cols(X)
        D = -G0
        res = more_thuente_fleet(fn_cols, grad_cols, X, f0, G0, D, 1.0)

        def single(c, x, f, g, d):
            fi = lambda xx: fn(xx, c)
            return more_thuente(fi, jax.grad(fi), x, f, g, d, 1.0)

        ref = jax.vmap(single, in_axes=(0, 1, 0, 1, 1))(centers, X, f0, G0, D)
        np.testing.assert_allclose(res.alpha, ref.alpha, rtol=1e-6)
        np.testing.assert_array_equal(res.nfev, ref.nfev)
        np.testing.assert_array_equal(res.info, ref.info)

    def test_non_descent_lane_bails(self):
        n, B = 3, 4
        X = jnp.zeros((n, B), jnp.float32)
        fn_cols = lambda Xc: jnp.sum(Xc**2, axis=0)
        grad_cols = bfgs_fleet.grad_colwise(fn_cols)
        G0 = grad_cols(X + 1.0)  # nonzero gradient
        D = G0.at[:, 0].set(G0[:, 0])  # lane 0 ascends (D = +g)
        D = D.at[:, 1:].set(-G0[:, 1:])
        f0 = fn_cols(X + 1.0)
        res = more_thuente_fleet(fn_cols, grad_cols, X + 1.0, f0, G0, D, 1.0)
        assert int(res.info[0]) == -1 and int(res.nfev[0]) == 0
        assert all(int(i) == 1 for i in np.asarray(res.info[1:]))


class TestBFGSFleet:
    def test_quadratic_fleet_matches_vmapped_bfgs(self):
        key = jax.random.key(4)
        k1, k2 = jax.random.split(key)
        n, B = 16, 128
        centers = jax.random.normal(k1, (B, n), jnp.float32)
        scales = jax.random.uniform(k2, (B, n), jnp.float32, 0.5, 3.0)

        fn_cols = lambda X: jnp.sum(scales.T * (X - centers.T) ** 2, axis=0)
        cfg = bfgs_fleet.BFGSFleetConfig(max_iter=30)
        res = jax.jit(lambda X0: bfgs_fleet.minimize_fleet(fn_cols, X0, cfg))(
            jnp.zeros((n, B), jnp.float32)
        )
        assert bool(jnp.all(res.converged))
        # grad_eps=5e-3 with scale >= 0.5 allows |x - c| up to ~5e-3
        np.testing.assert_allclose(res.x, centers.T, atol=5e-3)

        vcfg = bfgs.BFGSConfig(max_iter=30)
        vres = jax.jit(
            lambda: jax.vmap(
                lambda c, s: bfgs.minimize(
                    lambda x: jnp.sum(s * (x - c) ** 2),
                    jnp.zeros(n, jnp.float32),
                    vcfg,
                )
            )(centers, scales)
        )()
        # same algorithm; reduction order differs between layouts, so allow
        # float-level drift and the occasional one-iteration stop-time flip
        np.testing.assert_allclose(res.x.T, vres.x, atol=5e-3)
        same = np.asarray(res.iterations) == np.asarray(vres.iterations)
        assert same.mean() > 0.9, f"iteration counts diverged: {same.mean():.2f}"

    def test_rosenbrock_fleet_converges(self):
        B = 64
        starts = jnp.stack(
            [jnp.full((B,), -0.5), jnp.linspace(-1.0, 1.0, B)]
        ).astype(jnp.float32)  # [2, B]
        fn_cols = lambda X: 100.0 * (X[0] ** 2 - X[1]) ** 2 + (X[0] - 1.0) ** 2
        res = jax.jit(
            lambda X0: bfgs_fleet.minimize_fleet(
                fn_cols, X0, bfgs_fleet.BFGSFleetConfig(max_iter=100, grad_eps=1e-5)
            )
        )(starts)
        assert float(jnp.max(res.f_value)) < 1e-6
        np.testing.assert_allclose(res.x, jnp.ones((2, B)), atol=1e-2)

    def test_lanes_freeze_independently(self):
        # lane difficulty varies -> iteration counts must differ and stick
        n, B = 4, 8
        conds = jnp.logspace(0, 2, B).astype(jnp.float32)  # per-lane conditioning
        ones = jnp.ones(B, jnp.float32)
        fn_cols = lambda X: jnp.sum(
            X**2 * jnp.stack([ones, conds, ones, conds]), axis=0
        ) + 0.05 * jnp.sum(X**4, axis=0)
        res = jax.jit(
            lambda X0: bfgs_fleet.minimize_fleet(
                fn_cols, X0, bfgs_fleet.BFGSFleetConfig(max_iter=60, grad_eps=1e-6)
            )
        )(jnp.ones((n, B), jnp.float32))
        its = np.asarray(res.iterations)
        assert len(set(its.tolist())) > 1  # genuinely different stop times
        assert np.all(its <= 60)
        assert float(jnp.max(jnp.abs(res.x))) < 1e-2


def test_failed_linesearch_never_stores_nonfinite_H():
    """Advisor finding (round 4): an alpha=0 linesearch outcome (s=y=0)
    made rho=1/0=inf and wrote a NaN inv_hessian, relying on downstream
    NaN detection to recover.  The curvature guard must keep H finite and
    flag the reset instead.  Forced here with an ASCENT direction (every
    trial step increases f, so the speculative grid returns alpha=0)."""
    import jax.numpy as jnp

    from nlsolver_tpu.solvers import bfgs_fleet

    n, B = 3, 4
    w = jnp.linspace(1.0, 2.0, n)[:, None]
    fn_cols = lambda X: jnp.sum(w * X, axis=0)        # linear: grad == w
    X0 = jnp.ones((n, B), jnp.float32)
    cfg = bfgs_fleet.BFGSFleetConfig(linesearch="speculative")
    state = bfgs_fleet.init(fn_cols, X0, cfg)
    state = state._replace(direction=state.gradient)  # ascent direction
    new = bfgs_fleet.step(fn_cols, state, cfg)
    assert bool(jnp.all(jnp.isfinite(new.inv_hessian))), new.inv_hessian
    assert bool(jnp.all(new.pending_reset))
