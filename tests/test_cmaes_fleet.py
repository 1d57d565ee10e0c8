"""Batch-minor CMA-ES fleet (solvers/cmaes_fleet.py): lane-parallel
strategies with the batched Jacobi eigensolver replacing tinyqr's iterated
QR (tinyqr.h:317-434 -> nlsolver.h:4539)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsolver_tpu.core import Bounds
from nlsolver_tpu.problems import PROBLEMS
from nlsolver_tpu.solvers import cmaes_fleet
from nlsolver_tpu.solvers.cmaes_fleet import CMAESFleetConfig


def rosen(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


def test_fleet_converges_rosenbrock(key):
    B = 64
    X0 = jnp.full((2, B), -0.5)
    res = jax.jit(
        lambda X0, k: cmaes_fleet.minimize_fleet(rosen, X0, CMAESFleetConfig(), key=k)
    )(X0, key)
    assert res.x.shape == (2, B)
    fv = np.asarray(res.f_value)
    assert float(np.median(fv)) < 1e-6
    assert int(np.sum(fv < 1e-2)) >= 60


@pytest.mark.parametrize("method", ["jacobi", "xla"])
def test_eigh_backends_agree_statistically(key, method):
    """jacobi and xla eigensolvers drive the same algorithm: both fleets
    crack the same problems to the same quality (draws differ only through
    eigenvector sign/order conventions)."""
    p = PROBLEMS["himmelblau"]
    B = 32
    X0 = jnp.full((2, B), -0.5)
    cfg = CMAESFleetConfig(eigh_method=method, max_iter=200)
    res = jax.jit(
        lambda X0, k: cmaes_fleet.minimize_fleet(p.fn, X0, cfg, key=k)
    )(X0, key)
    d = jax.vmap(p.distance_to_nearest_minimum, in_axes=1)(res.x)
    assert int(jnp.sum(d <= 0.05)) >= 28, (method, d)


def test_fleet_bounds_projection(key):
    fn = lambda x: jnp.sum((x + 1.0) ** 2)
    bounds = Bounds(lower=jnp.zeros(2), upper=jnp.full(2, 4.0))
    res = cmaes_fleet.minimize_fleet(
        fn, jnp.full((2, 16), 2.0), CMAESFleetConfig(max_iter=200),
        bounds=bounds, key=key,
    )
    assert float(jnp.min(res.x)) >= -1e-9
    assert float(jnp.max(jnp.abs(res.x))) <= 1e-2        # corner optimum
    assert abs(float(jnp.median(res.f_value)) - 2.0) < 1e-2


def test_fleet_16d_shekel_class(key):
    """VERDICT r2 target shape: a 16-D multimodal fleet.  Styblinski-Tang
    has 2^16 local minima; a fleet from a central start must reach the
    global basin in most lanes."""
    n, B = 16, 32
    fn = lambda x: 0.5 * jnp.sum(x ** 4 - 16.0 * x ** 2 + 5.0 * x)
    cfg = CMAESFleetConfig(pop_size=32, sigma0=1.5, max_iter=400)
    X0 = jnp.full((n, B), -2.0)
    res = jax.jit(
        lambda X0, k: cmaes_fleet.minimize_fleet(fn, X0, cfg, key=k)
    )(X0, key)
    # global minimum: all coords at -2.9035, f = -39.166 n
    f_global = -39.16599 * n
    fv = np.asarray(res.f_value)
    assert float(np.min(fv)) < f_global * 0.999
    assert float(np.median(fv)) < f_global * 0.95


def test_fleet_lanes_are_independent(key):
    """Different lanes draw independent randomness: from identical starts
    on a multimodal surface they land in different basins."""
    p = PROBLEMS["himmelblau"]
    B = 32
    res = jax.jit(
        lambda X0, k: cmaes_fleet.minimize_fleet(
            p.fn, X0, CMAESFleetConfig(sigma0=2.0, max_iter=200), key=k
        )
    )(jnp.zeros((2, B)), key)
    xs = np.asarray(res.x)          # [2, B]
    # himmelblau has 4 minima; 32 independent lanes must find >= 2 of them
    basins = {tuple(np.round(xs[:, b], 1)) for b in range(B)}
    assert len(basins) >= 2, basins


def test_fleet_checkpoint_resume_bit_exact(key, tmp_path):
    """Pause/resume a CMA-ES fleet mid-run through utils.checkpoint: the
    resumed trajectory must be bit-identical to the uninterrupted one
    (state is a pytree incl. the typed PRNG key)."""
    from nlsolver_tpu.utils import checkpoint

    B = 8
    X0 = jnp.full((2, B), -0.5, jnp.float32)
    cfg = CMAESFleetConfig(max_iter=1 << 30, best_value_no_change=1 << 30)

    step = jax.jit(lambda s: cmaes_fleet.step(rosen, s, cfg))
    s = cmaes_fleet.init(rosen, X0, cfg, key)
    for _ in range(5):
        s = step(s)
    path = str(tmp_path / "fleet.npz")
    checkpoint.save(path, s)
    s_resumed = checkpoint.load(path, like=s)
    for _ in range(5):
        s = step(s)
        s_resumed = step(s_resumed)
    assert jnp.array_equal(s.mean, s_resumed.mean)
    assert jnp.array_equal(s.C, s_resumed.C)
    assert jnp.array_equal(s.best_value, s_resumed.best_value)


def test_defer_covariance_matches_eager_lazy():
    """defer_covariance=True is mathematically the eager lazy recurrence:
    in f64 the trajectory (mean/sigma/best) matches to machine precision,
    and materializing the buffered window reproduces the eager C.  (The
    state.C FIELD lags by design — the window lives in the buffers.)"""
    import jax
    import jax.numpy as jnp

    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import cmaes_fleet as cf
    from nlsolver_tpu.solvers.cmaes import _params

    fn = PROBLEMS["rastrigin"].fn
    n, B = 8, 16
    X0 = jnp.full((n, B), -0.5, jnp.float64)

    def run(defer, iters):
        cfg = cf.CMAESFleetConfig(
            max_iter=1 << 30, best_value_no_change=1 << 30, f_tol=0.0,
            kick_tol=0.0, cond_max=jnp.inf, eigh_method="jacobi",
            eigen_interval=5, defer_covariance=defer,
        )
        state = cf.init(fn, X0, cfg, jax.random.key(0))
        return cf.drive_fleet_scan(lambda s: cf.step(fn, s, cfg), state, iters)

    for iters in (6, 11):
        e, d = run(False, iters), run(True, iters)
        assert float(jnp.max(jnp.abs(e.mean - d.mean))) < 1e-11, iters
        assert float(jnp.max(jnp.abs(e.sigma - d.sigma))) < 1e-11
        assert float(jnp.max(jnp.abs(e.best_value - d.best_value))) < 1e-11
        # materialize the deferred window: must equal the eager C
        lam, mu, w, *_rest = _params(n, 0)
        c1, cmu = _rest[3], _rest[4]
        Cm = cf._materialize(
            d.C, d.a_buf, d.pc_buf, d.y_buf, d.filled,
            c1, cmu, jnp.asarray(w, jnp.float64), mu, 5,
        )
        assert float(jnp.max(jnp.abs(Cm - e.C))) < 1e-11, iters


def test_defer_covariance_validation():
    import jax.numpy as jnp
    import pytest

    from nlsolver_tpu.solvers import cmaes_fleet as cf

    with pytest.raises(ValueError, match="eigen_interval"):
        cf.init(
            lambda x: jnp.sum(x * x),
            jnp.zeros((4, 8)),
            cf.CMAESFleetConfig(defer_covariance=True, eigen_interval=1),
            jax.random.key(0),
        )


def test_defer_covariance_solves():
    """End-to-end: the deferred mode still optimizes (f32, with kick +
    termination active — the partial-window kick path executes)."""
    import jax
    import jax.numpy as jnp

    from nlsolver_tpu.solvers import cmaes_fleet as cf

    sphere = lambda x: jnp.sum(x * x)
    X0 = jnp.full((4, 16), 2.0, jnp.float32)
    cfg = cf.CMAESFleetConfig(
        max_iter=200, eigen_interval=5, defer_covariance=True,
    )
    res = cf.minimize_fleet(sphere, X0, cfg, key=jax.random.key(1))
    assert float(jnp.median(res.f_value)) < 1e-3
