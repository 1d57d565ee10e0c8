"""Line searches: Wolfe conditions on quadratics and hard directions."""
import jax
import jax.numpy as jnp

from nlsolver_tpu.linesearch import armijo, more_thuente
from nlsolver_tpu.linesearch.more_thuente import FTOL, GTOL


def quad(x):
    return 0.5 * jnp.sum(x * x)


def test_more_thuente_exact_on_quadratic():
    # phi(a) = 0.5 ||x - a x||^2, minimizer at a = 1 for d = -x
    x = jnp.asarray([2.0, -3.0])
    g = jax.grad(quad)(x)
    d = -g
    res = more_thuente(quad, jax.grad(quad), x, quad(x), g, d, 1.0)
    assert res.info == 1
    # strong Wolfe holds
    a = res.alpha
    f_new = quad(x + a * d)
    g_new = jax.grad(quad)(x + a * d)
    dginit = jnp.dot(g, d)
    assert float(f_new) <= float(quad(x) + FTOL * a * dginit)
    assert float(jnp.abs(jnp.dot(g_new, d))) <= float(GTOL * (-dginit))


def test_more_thuente_rosenbrock_direction():
    from nlsolver_tpu.problems import PROBLEMS

    fn = PROBLEMS["rosenbrock"].fn
    x = jnp.asarray([-0.5, -0.5])
    g = jax.grad(fn)(x)
    d = -g
    res = more_thuente(fn, jax.grad(fn), x, fn(x), g, d, 1.0)
    assert int(res.info) >= 1  # terminated with some MINPACK code
    assert float(fn(x + res.alpha * d)) < float(fn(x))  # made progress
    assert int(res.nfev) <= 20


def test_more_thuente_nondescent_returns_initial_alpha():
    x = jnp.asarray([1.0, 1.0])
    g = jax.grad(quad)(x)
    res = more_thuente(quad, jax.grad(quad), x, quad(x), g, g, 0.7)  # ascent dir
    assert float(res.alpha) == 0.7
    assert int(res.info) == -1


def test_armijo_backtracks():
    x = jnp.asarray([2.0, -3.0])
    g = jax.grad(quad)(x)
    d = -g
    res = armijo(quad, x, quad(x), g, d, 4.0)  # alpha=4 overshoots badly
    a = float(res.alpha)
    assert a < 4.0
    assert float(quad(x + a * d)) <= float(quad(x) + 0.2 * a * jnp.dot(g, d))


def test_vmapped_linesearch():
    # batch of line searches in one program — the batched BFGS building block
    xs = jnp.stack([jnp.asarray([2.0, -3.0]), jnp.asarray([1.0, 5.0])])
    gs = jax.vmap(jax.grad(quad))(xs)
    res = jax.vmap(
        lambda x, g: more_thuente(quad, jax.grad(quad), x, quad(x), g, -g, 1.0)
    )(xs, gs)
    assert res.alpha.shape == (2,)
    assert bool(jnp.all(res.info == 1))


def test_speculative_fleet_converges_like_mt():
    """linesearch/speculative.py: the depth-1 grid search drives the BFGS
    fleet to the same minima as More-Thuente (more iterations allowed —
    the grid is not adaptively refined)."""
    import jax
    import jax.numpy as jnp

    from nlsolver_tpu.solvers import bfgs_fleet as bf

    def rosen_cols(X):
        x, y = X[0], X[1]
        return 100.0 * (x**2 - y) ** 2 + (x - 1.0) ** 2

    X0 = jnp.tile(jnp.asarray([[-0.5], [-0.5]]), (1, 32)) + 0.01 * jax.random.normal(
        jax.random.key(0), (2, 32)
    )
    cfg = bf.BFGSFleetConfig(max_iter=200, grad_eps=1e-6, linesearch="speculative")
    res = jax.jit(lambda X: bf.minimize_fleet(rosen_cols, X, cfg))(X0)
    assert float(jnp.max(res.f_value)) < 1e-8
    assert bool(jnp.all(res.converged))


def test_speculative_tiers_and_zero_step():
    """Acceptance tiers: Wolfe on a smooth bowl; alpha=0 (info 6) when no
    grid point improves; non-descent bail-out (info -1)."""
    import jax.numpy as jnp

    from nlsolver_tpu.linesearch.speculative import speculative_fleet

    quad_cols = lambda X: jnp.sum(X * X, axis=0)
    grad_cols = lambda X: 2.0 * X
    X = jnp.asarray([[1.0], [1.0]])
    f0 = quad_cols(X)
    G = grad_cols(X)
    res = speculative_fleet(quad_cols, grad_cols, X, f0, G, -G, 1.0)
    # alpha=0.5 is the exact minimizer along -G here: strong Wolfe (1);
    # a coarser grid would land Armijo-only (2) — both are acceptances
    assert int(res.info[0]) in (1, 2)
    assert float(res.alpha[0]) > 0.0

    # at the exact minimum no step strictly improves -> zero step, info 6
    X0 = jnp.zeros((2, 1))
    d = jnp.asarray([[1.0], [0.0]])
    # force a "descent" direction flag via a tiny negative slope
    Gtiny = jnp.asarray([[-1e-30], [0.0]])
    res0 = speculative_fleet(quad_cols, grad_cols, X0, quad_cols(X0), Gtiny, d, 1.0)
    assert int(res0.info[0]) in (1, 2, 3, 6)

    # ascent direction: reference bail-out semantics
    res_bad = speculative_fleet(quad_cols, grad_cols, X, f0, G, G, 1.0)
    assert int(res_bad.info[0]) == -1
