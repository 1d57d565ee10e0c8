"""Top-level API + README quickstart snippets (doc-rot guard)."""
import jax
import jax.numpy as jnp
import pytest

import nlsolver_tpu


def rosen(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


def test_methods_listing():
    ms = nlsolver_tpu.methods()
    for expected in (
        "nelder_mead", "de", "pso", "sann", "nmpso", "gd", "cgd", "bfgs",
        "lm", "brent", "cmaes", "lbfgs", "coordinate",
    ):
        assert expected in ms, expected


def test_readme_quickstart_single():
    res = nlsolver_tpu.minimize(rosen, [-0.5, -0.5], method="nelder_mead")
    assert float(res.f_value) < 1e-3
    res.print()  # must not raise


def test_readme_quickstart_vmap(key):
    keys = jax.random.split(key, 64)
    batch = jax.jit(
        jax.vmap(
            lambda k: nlsolver_tpu.minimize(
                rosen, jnp.asarray([-0.5, -0.5]), method="de", key=k
            )
        )
    )(keys)
    assert batch.x.shape == (64, 2)
    assert float(jnp.median(batch.f_value)) < 1e-2


def test_readme_quickstart_sharded(key):
    from nlsolver_tpu.parallel import make_mesh, minimize_sharded
    from nlsolver_tpu.solvers.de import DEConfig

    mesh = make_mesh(8, dp=2, pop=4)
    res = minimize_sharded(
        rosen, jnp.full((4, 2), -0.5), DEConfig(pop_size=64), mesh,
        jax.random.split(key, 4),
    )
    assert float(jnp.max(res.f_value)) < 1e-2


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="available methods"):
        nlsolver_tpu.minimize(rosen, [0.0, 0.0], method="nope")
    with pytest.raises(ValueError, match="layout"):
        nlsolver_tpu.minimize(rosen, [0.0, 0.0], layout="nope")


def test_maximize_api():
    res = nlsolver_tpu.maximize(lambda x: -rosen(x), [-0.5, -0.5], method="bfgs")
    assert float(res.f_value) > -1e-3


def test_layout_batched_de(key):
    """layout='batched' reaches the lane-axis DE engine through minimize."""
    x0 = jnp.full((32, 2), -0.5)
    res = jax.jit(
        lambda x0, keys: nlsolver_tpu.minimize(
            rosen, x0, method="de", layout="batched",
            keys=keys,
        )
    )(x0, jax.random.split(key, 32))
    assert res.x.shape == (32, 2)
    assert float(jnp.median(res.f_value)) < 1e-2


def test_layout_batched_pso_sann(key):
    """layout='batched' reaches the lane-axis PSO/SANN fleet engines."""
    sphere = lambda x: jnp.sum(x * x)
    x0 = jnp.full((16, 2), -0.5)
    keys = jax.random.split(key, 16)
    res = jax.jit(
        lambda x0, keys: nlsolver_tpu.minimize(
            sphere, x0, method="pso", layout="batched", keys=keys,
        )
    )(x0, keys)
    assert res.x.shape == (16, 2)
    assert float(jnp.median(res.f_value)) < 1e-2
    from nlsolver_tpu.solvers.sann import SANNConfig

    res = jax.jit(
        lambda x0, keys: nlsolver_tpu.minimize(
            sphere, x0, method="sann", layout="batched",
            config=SANNConfig(max_iter=500), keys=keys,
        )
    )(x0, keys)
    assert res.x.shape == (16, 2)
    assert float(jnp.median(res.f_value)) < 1e-2


def test_layout_batched_vmap_fallback():
    """Non-DE methods batch via vmap under the same switch."""
    x0 = jnp.tile(jnp.asarray([-0.5, -0.5]), (8, 1))
    res = jax.jit(
        lambda x0: nlsolver_tpu.minimize(rosen, x0, method="bfgs", layout="batched")
    )(x0)
    assert res.x.shape == (8, 2)
    assert float(jnp.max(res.f_value)) < 1e-4


def test_layout_fleet_bfgs():
    """layout='fleet' reaches the batch-minor BFGS fleet; x0 is [n, B]."""
    X0 = jnp.full((2, 16), -0.5)
    res = nlsolver_tpu.minimize(rosen, X0, method="bfgs", layout="fleet")
    assert res.x.shape == (2, 16)
    assert float(jnp.max(res.f_value)) < 1e-4


def test_layout_sharded_and_islands(key):
    from nlsolver_tpu.parallel import make_mesh

    mesh = make_mesh(8, dp=2, pop=4)
    from nlsolver_tpu.solvers.de import DEConfig

    res = nlsolver_tpu.minimize(
        rosen, jnp.full((4, 2), -0.5), config=DEConfig(pop_size=64),
        method="de", layout="sharded", mesh=mesh, keys=jax.random.split(key, 4),
    )
    assert float(jnp.max(res.f_value)) < 1e-2
    res_i = nlsolver_tpu.minimize(
        rosen, jnp.full((4, 2), -0.5), config=DEConfig(pop_size=64),
        method="de", layout="islands", mesh=mesh, keys=jax.random.split(key, 4),
    )
    assert float(jnp.max(res_i.f_value)) < 1e-2
    with pytest.raises(ValueError, match="mesh"):
        nlsolver_tpu.minimize(
            rosen, jnp.full((4, 2), -0.5), method="de", layout="sharded"
        )


def test_root_api():
    cubic = lambda x: (x - 1.0) * (x + 2.0) * (x - 3.5)
    for method in nlsolver_tpu.root_methods():
        if method == "tiruneh":
            res = nlsolver_tpu.root(cubic, method="tiruneh", x_k=(0.0, 0.5, 2.0))
        else:
            res = nlsolver_tpu.root(cubic, 0.0, 2.0, method=method)
        assert abs(float(res.x) - 1.0) < 1e-3, method
    with pytest.raises(ValueError, match="available"):
        nlsolver_tpu.root(cubic, 0.0, 2.0, method="nope")


def test_nlls_reexports():
    t = jnp.linspace(0.0, 1.0, 32)
    y = 2.0 * t + 0.5
    model = lambda p, t: p[0] * t + p[1]
    res = nlsolver_tpu.curve_fit(model, t, y, jnp.zeros(2))
    assert jnp.allclose(res.x, jnp.asarray([2.0, 0.5]), atol=1e-5)
    res_b = nlsolver_tpu.fit_batched(
        lambda p: model(p, t) - y, jnp.zeros((4, 2))
    )
    assert res_b.x.shape == (4, 2)


def test_cmaes_fleet_via_minimize(key):
    """layout='fleet' + method='cmaes' reaches the lane-parallel CMA-ES."""
    import nlsolver_tpu
    from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig

    rosen = lambda x: 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2
    B = 16
    X0 = jnp.full((2, B), -0.5)
    res = jax.jit(
        lambda X0, k: nlsolver_tpu.minimize(
            rosen, X0, method="cmaes", layout="fleet",
            config=CMAESFleetConfig(max_iter=200), key=k,
        )
    )(X0, key)
    assert res.x.shape == (2, B)
    assert float(jnp.median(res.f_value)) < 1e-4


def test_batched_de_key_controls_stream(key):
    """Regression (r3 review): key= must thread into the lane-axis DE —
    different keys, different results."""
    import nlsolver_tpu
    from nlsolver_tpu.solvers.de import DEConfig

    sphere = lambda x: jnp.sum(x * x)
    x0 = jnp.full((8, 3), -0.5)
    cfg = DEConfig(pop_size=16, max_iter=10, best_value_no_change=1 << 30,
                   eps=0.0, partner_sampling="rotation")
    r1 = nlsolver_tpu.minimize(sphere, x0, method="de", layout="batched",
                               config=cfg, key=jax.random.key(1))
    r2 = nlsolver_tpu.minimize(sphere, x0, method="de", layout="batched",
                               config=cfg, key=jax.random.key(2))
    assert not jnp.array_equal(r1.f_value, r2.f_value)


def test_batched_vmap_lanes_are_independent(key):
    """Regression (r3 review): without any key, vmapped stochastic lanes
    must still get DISTINCT derived streams, not the solver default."""
    import nlsolver_tpu
    from nlsolver_tpu.solvers.cmaes import CMAESConfig

    sphere = lambda x: jnp.sum(x * x)
    x0 = jnp.tile(jnp.asarray([[-0.5, 0.5]]), (4, 1))
    res = nlsolver_tpu.minimize(sphere, x0, method="cmaes", layout="batched",
                                config=CMAESConfig(max_iter=5))
    # identical starts but distinct streams -> distinct iterates
    assert len({tuple(map(float, row)) for row in res.x}) > 1


def test_fleet_cmaes_scalar_bounds(key):
    """Regression (r3 review): scalar (broadcastable) bounds must work on
    the fleet path like everywhere else."""
    import nlsolver_tpu
    from nlsolver_tpu.core import Bounds
    from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig

    sphere = lambda x: jnp.sum(x * x)
    X0 = jnp.full((3, 8), 2.0)
    res = nlsolver_tpu.minimize(
        sphere, X0, method="cmaes", layout="fleet",
        config=CMAESFleetConfig(max_iter=60),
        bounds=Bounds(jnp.asarray(-5.0), jnp.asarray(5.0)), key=key,
    )
    assert float(jnp.median(res.f_value)) < 1e-2


def test_maximize_fleet_and_islands(key):
    """The shared sign wrapper (signed + unflip) must hold on every
    engine layout: maximize of -sphere gives f_value near 0 from above."""
    import numpy as np

    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig
    from nlsolver_tpu.solvers.de import DEConfig

    neg_sphere = lambda x: -jnp.sum(x * x)

    # fleet (cmaes)
    X0 = jnp.full((2, 8), 1.5)
    res = nlsolver_tpu.maximize(
        neg_sphere, X0, method="cmaes", layout="fleet",
        config=CMAESFleetConfig(max_iter=120), key=key,
    )
    assert float(jnp.median(res.f_value)) > -1e-4
    assert float(jnp.max(res.f_value)) <= 1e-12

    # islands (de)
    mesh = make_mesh(4, dp=2, pop=2)
    x0 = jnp.full((4, 3), 1.5)
    res = nlsolver_tpu.maximize(
        neg_sphere, x0, method="de", layout="islands", mesh=mesh,
        config=DEConfig(pop_size=16, max_iter=120), key=key,
    )
    assert float(np.median(np.asarray(res.f_value))) > -1e-3


def test_multistart_restarts(key):
    """minimize(..., restarts=k): solves problems the single trajectory
    cannot (Shekel — every reference family fails it,
    reference_test_matrix.tsv), sums counters, rejects bad arguments."""
    from nlsolver_tpu.problems import PROBLEMS

    p = PROBLEMS["shekel"]
    x0 = jnp.full((p.dim,), -0.5)
    single = nlsolver_tpu.minimize(p.fn, x0, method="nelder_mead", key=key)
    multi = nlsolver_tpu.minimize(
        p.fn, x0, method="nelder_mead", key=key, restarts=8
    )
    assert float(p.distance_to_nearest_minimum(multi.x)) <= 0.05
    assert float(multi.f_value) <= float(single.f_value)
    # counters are the TOTAL budget across starts
    assert int(multi.function_calls) > int(single.function_calls)

    with pytest.raises(ValueError, match="restarts"):
        nlsolver_tpu.minimize(
            p.fn, jnp.zeros((4, 2)), method="de", layout="batched", restarts=4
        )


def test_multistart_respects_bounds(key):
    """With bounds, the extra starts sample inside the box and a
    box-enforcing solver (DE) returns an in-box result.  (Nelder-Mead's
    initial simplex may legally exceed the box — reference semantics,
    nlsolver.h:1910-1947 — so DE is the solver that proves the sampling.)"""
    from nlsolver_tpu.core import Bounds

    shifted = lambda x: jnp.sum((x - 3.0) ** 2)
    b = Bounds(jnp.asarray(-1.0), jnp.asarray(1.0))
    res = nlsolver_tpu.minimize(
        shifted, jnp.zeros((2,)), method="lbfgsb", bounds=b,
        key=key, restarts=6,
    )
    assert bool(jnp.all(res.x <= 1.0 + 1e-6)) and bool(jnp.all(res.x >= -1.0 - 1e-6))
    # best in-box value is at the corner (1, 1)
    assert abs(float(res.f_value) - 8.0) < 1e-2


def test_maximize_multistart(key):
    neg = lambda x: -jnp.sum((x - 2.0) ** 2)
    res = nlsolver_tpu.maximize(
        neg, jnp.zeros((2,)), method="nelder_mead", key=key, restarts=6
    )
    assert float(res.f_value) > -1e-6


def test_sharded_cmaes_via_minimize(key):
    """layout='sharded' + method='cmaes' reaches the lane-sharded fleet."""
    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig

    mesh = make_mesh(8, dp=2, pop=4)
    sphere = lambda x: jnp.sum(x * x)
    res = nlsolver_tpu.minimize(
        sphere, jnp.full((3, 8), 2.0), method="cmaes", layout="sharded",
        mesh=mesh, config=CMAESFleetConfig(max_iter=60), key=key,
    )
    assert res.x.shape == (3, 8)
    assert float(jnp.median(res.f_value)) < 1e-2


def test_sharded_lbfgs_via_minimize():
    """layout='sharded' + method='lbfgs' reaches the dimension-sharded
    engine (shard-local objective contract)."""
    from nlsolver_tpu.parallel import make_mesh

    mesh = make_mesh(8, dp=1, pop=8)
    fn_local = lambda xl: jnp.sum(xl * xl)
    grad_local = lambda xl: 2.0 * xl
    res = nlsolver_tpu.minimize(
        fn_local, jnp.full((16,), 3.0), method="lbfgs", layout="sharded",
        mesh=mesh, grad_local=grad_local, max_iter=50,
    )
    assert res.x.shape == (16,)
    assert float(res.f_value) < 1e-10
    with pytest.raises(ValueError, match="grad_local"):
        nlsolver_tpu.minimize(
            fn_local, jnp.full((16,), 3.0), method="lbfgs", layout="sharded",
            mesh=mesh,
        )


def test_islands_fused_via_minimize(key):
    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.solvers.de import DEConfig

    mesh = make_mesh(8, dp=2, pop=4)
    res = nlsolver_tpu.minimize(
        rosen, jnp.full((4, 2), -0.5), method="de", layout="islands",
        mesh=mesh, config=DEConfig(pop_size=32, max_iter=200),
        keys=jax.random.split(key, 4), fused=True,
    )
    assert float(jnp.max(res.f_value)) < 1e-2


def test_multistart_halton_sampler(key):
    """restart_sampler='halton': deterministic stratified starts (the
    reference's own low-discrepancy generator) — same result across
    keys for a deterministic solver, and it still solves Shekel."""
    from nlsolver_tpu.api import _halton_unit
    from nlsolver_tpu.problems import PROBLEMS

    # the unit points are the radical-inverse sequence (bases 2, 3)
    u = _halton_unit(4, 2)
    assert abs(u[0, 0] - 0.5) < 1e-12 and abs(u[1, 0] - 0.25) < 1e-12
    assert abs(u[0, 1] - 1 / 3) < 1e-12 and abs(u[1, 1] - 2 / 3) < 1e-12

    p = PROBLEMS["shekel"]
    x0 = jnp.full((p.dim,), -0.5)
    r1 = nlsolver_tpu.minimize(
        p.fn, x0, method="nelder_mead", key=jax.random.key(0),
        restarts=8, restart_sampler="halton",
    )
    r2 = nlsolver_tpu.minimize(
        p.fn, x0, method="nelder_mead", key=jax.random.key(99),
        restarts=8, restart_sampler="halton",
    )
    # NM is deterministic given the start; halton starts ignore the key
    assert float(jnp.max(jnp.abs(r1.x - r2.x))) == 0.0
    assert float(p.distance_to_nearest_minimum(r1.x)) <= 0.05
    with pytest.raises(ValueError, match="restart_sampler"):
        nlsolver_tpu.minimize(
            p.fn, x0, method="nelder_mead", restarts=4,
            restart_sampler="sobol",
        )


def test_maximize_fleet_with_explicit_fn_cols():
    """Regression (round-4 review): an explicit fn_cols= bypasses the
    signed() wrapper, so maximize must negate it itself — on BOTH the
    fleet and sharded layouts."""
    from nlsolver_tpu.parallel import make_mesh

    neg_bowl_cols = lambda X: -jnp.sum((X - 1.0) ** 2, axis=0)
    X0 = jnp.zeros((2, 8))
    res = nlsolver_tpu.maximize(
        lambda x: -jnp.sum((x - 1.0) ** 2), X0, method="bfgs",
        layout="fleet", fn_cols=neg_bowl_cols,
    )
    # maximum of the negated bowl is 0 at X=1
    assert float(jnp.min(res.f_value)) > -1e-6
    assert float(jnp.max(jnp.abs(res.x - 1.0))) < 1e-3

    mesh = make_mesh(8, dp=2, pop=4)
    res_s = nlsolver_tpu.maximize(
        lambda x: -jnp.sum((x - 1.0) ** 2), X0, method="bfgs",
        layout="sharded", mesh=mesh, fn_cols=neg_bowl_cols,
    )
    assert float(jnp.min(res_s.f_value)) > -1e-6

    # bounds are rejected loudly on BOTH fleet layouts (round-4 review:
    # the fleet path used to drop them silently)
    from nlsolver_tpu.core import Bounds

    for extra in (dict(layout="fleet"), dict(layout="sharded", mesh=mesh)):
        with pytest.raises(ValueError, match="unconstrained"):
            nlsolver_tpu.minimize(
                lambda x: jnp.sum(x * x), X0, method="bfgs",
                bounds=Bounds(jnp.asarray(-1.0), jnp.asarray(1.0)), **extra,
            )


def test_layout_sharded_pso_sann_fleets(key):
    """layout='sharded' + method='pso_batched'/'sann' reaches the
    lane-sharded instance fleets (parallel/fleet_sharded.py)."""
    from nlsolver_tpu.parallel import make_mesh
    from nlsolver_tpu.solvers.sann import SANNConfig

    sphere = lambda x: jnp.sum(x * x)
    mesh = make_mesh(8, dp=2, pop=4)
    x0 = jnp.tile(jnp.full((2,), -0.5), (8, 1))
    r = nlsolver_tpu.minimize(
        sphere, x0, method="pso_batched", layout="sharded", mesh=mesh, key=key
    )
    assert r.x.shape == (8, 2)
    assert float(jnp.median(r.f_value)) < 1e-2
    r = nlsolver_tpu.minimize(
        sphere, x0, method="sann", layout="sharded", mesh=mesh,
        config=SANNConfig(max_iter=300), key=key,
    )
    assert r.x.shape == (8, 2)
    assert float(jnp.median(r.f_value)) < 1e-2


def _fleet_fit(cfg):
    t = jnp.linspace(0.0, 1.0, 4)
    return nlsolver_tpu.fit_fleet(
        lambda p, y: p[0] * jnp.exp(-p[1] * t) - y,
        jnp.ones((2, 3)), cfg, data=jnp.ones((3, 4)),
    )


def _cmaes_fleet(method):
    from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig

    return nlsolver_tpu.minimize(
        lambda x: jnp.sum(x * x), jnp.ones((2, 4)), "cmaes",
        CMAESFleetConfig(eigh_method=method, max_iter=2), layout="fleet",
        key=jax.random.key(0),
    )


def _removed_options():
    from nlsolver_tpu import linalg
    from nlsolver_tpu.solvers import bfgs_fleet, cmaes_fleet, de

    return {
        "bfgs_fleet_use_pallas": (
            lambda: bfgs_fleet.BFGSFleetConfig(use_pallas=True),
            TypeError, "use_pallas"),
        "de_use_fused_kernel": (
            lambda: de.DEConfig(use_fused_kernel=True),
            TypeError, "use_fused_kernel"),
        "cmaes_fleet_pallas_tile": (
            lambda: cmaes_fleet.CMAESFleetConfig(pallas_tile=128),
            TypeError, "pallas_tile"),
        "cmaes_fleet_eigh_pallas": (
            lambda: _cmaes_fleet("pallas"), ValueError, "unknown eigh_method"),
        "nlls_fleet_qr_pallas": (
            lambda: _fleet_fit(nlsolver_tpu.NLLSFleetConfig(solve="qr_pallas")),
            ValueError, "unknown solve"),
        "nlls_fleet_pallas_interpret": (
            lambda: nlsolver_tpu.NLLSFleetConfig(pallas_interpret=True),
            TypeError, "pallas_interpret"),
        "linalg_qr_pallas": (
            lambda: linalg.qr(jnp.ones((4, 2, 3)), method="pallas"),
            ValueError, "unknown qr method"),
        "linalg_eigh_pallas": (
            lambda: linalg.eigh(jnp.eye(3), method="pallas"),
            ValueError, "unknown eigh method"),
    }


@pytest.mark.parametrize("option", [
    "bfgs_fleet_use_pallas", "cmaes_fleet_eigh_pallas",
    "cmaes_fleet_pallas_tile", "de_use_fused_kernel", "linalg_eigh_pallas",
    "linalg_qr_pallas", "nlls_fleet_pallas_interpret", "nlls_fleet_qr_pallas",
])
def test_removed_kernel_options_raise(option):
    """The options that selected the deleted Pallas kernels fail like any
    unknown option or value, instead of silently picking another path."""
    call, exc, match = _removed_options()[option]
    with pytest.raises(exc, match=match):
        call()
