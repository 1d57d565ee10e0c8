"""linalg layer: Givens QR, iterated-QR eigensolver, solves — the tinyqr
replacement (tinyqr.h), validated against XLA's factorizations."""
import jax
import jax.numpy as jnp
import pytest

from nlsolver_tpu.linalg import (
    damped_solve,
    eigh,
    eigh_qr,
    least_squares,
    qr,
    qr_givens,
    solve_cholesky,
    validate_qr,
)


def random_matrix(key, n, symmetric=False):
    A = jax.random.normal(key, (n, n), jnp.float64)
    if symmetric:
        A = (A + A.T) / 2 + n * jnp.eye(n)
    return A


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_givens_qr_reconstructs(n, key):
    A = random_matrix(key, n)
    res = jax.jit(qr_givens)(A)
    assert float(validate_qr(res, A)) < 1e-10
    # R upper triangular
    assert float(jnp.max(jnp.abs(jnp.tril(res.R, -1)))) < 1e-10
    # Q orthogonal
    assert jnp.allclose(res.Q.T @ res.Q, jnp.eye(n), atol=1e-10)


def test_qr_backends_agree_on_abs(key):
    A = random_matrix(key, 4)
    g = qr_givens(A)
    h = qr(A)
    # QR unique up to column signs
    assert jnp.allclose(jnp.abs(g.R), jnp.abs(h.R), atol=1e-8)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_eigh_qr_matches_xla(n, key):
    A = random_matrix(key, n, symmetric=True)
    # the unshifted QR algorithm converges like |l_i/l_j|^k — close
    # eigenvalue pairs need many iterations (tinyqr's 25-iteration default
    # has the same limitation)
    ours = jax.jit(lambda a: eigh_qr(a, max_iter=2000, tol=1e-14))(A)
    ref = eigh(A)
    assert jnp.allclose(
        jnp.sort(ours.eigenvalues), jnp.sort(ref.eigenvalues), atol=1e-8
    )
    # eigenvector property A v = w v
    for i in range(n):
        v = ours.eigenvectors[:, i]
        w = ours.eigenvalues[i]
        assert jnp.allclose(A @ v, w * v, atol=1e-6)


def test_solve_cholesky(key):
    A = random_matrix(key, 5, symmetric=True)
    b = jnp.arange(1.0, 6.0)
    x = solve_cholesky(A, b)
    assert jnp.allclose(A @ x, b, atol=1e-9)


def test_damped_solve(key):
    A = random_matrix(key, 4, symmetric=True)
    g = jnp.ones(4)
    u = damped_solve(A, g, 10.0)
    assert jnp.allclose((A + 10.0 * jnp.eye(4)) @ u, g, atol=1e-9)


@pytest.mark.parametrize("n", [4, 12])
def test_damped_solve_diagonal_dispatch(key, n):
    """The reference's diagonal fast path (nlsolver.h:310-322): a diagonal
    Hessian takes the elementwise divide; all three static/dynamic modes
    agree with the dense solve on both diagonal and dense inputs."""
    d = jnp.arange(1.0, n + 1.0)
    H_diag = jnp.diag(d)
    g = jnp.ones(n)
    expect = g / (d + 2.5)
    for mode in (True, False, None):
        u = damped_solve(H_diag, g, 2.5, diagonal=mode)
        assert jnp.allclose(u, expect, atol=1e-12), mode
    # dense input: None must pick the factorized branch
    A = random_matrix(key, n, symmetric=True)
    u_auto = jax.jit(lambda A, g: damped_solve(A, g, 2.5))(A, g)
    assert jnp.allclose((A + 2.5 * jnp.eye(n)) @ u_auto, g, atol=1e-8)
    # diagonal=True on a separable fleet under vmap stays elementwise
    Hs = jax.vmap(jnp.diag)(jnp.abs(jax.random.normal(key, (16, n))) + 1.0)
    gs = jnp.ones((16, n))
    us = jax.jit(jax.vmap(lambda H, g: damped_solve(H, g, 0.5, diagonal=True)))(Hs, gs)
    assert jnp.allclose(us, gs / (jax.vmap(jnp.diagonal)(Hs) + 0.5), atol=1e-12)


def test_is_diagonal_threshold_is_dtype_independent():
    """Regression: scaling the reference's eps*1e12 threshold by the input
    dtype's eps makes the f32 cutoff ~1.2e5, classifying every Hessian as
    diagonal (LM then silently ignores all cross terms)."""
    from nlsolver_tpu.linalg.solve import is_diagonal

    H32 = jnp.array([[200.0, 100.0], [100.0, 200.0]], jnp.float32)
    assert not bool(is_diagonal(H32))
    assert bool(is_diagonal(jnp.diag(jnp.array([3.0, 4.0], jnp.float32))))
    # f32 LM on rosenbrock must use the cross terms
    u = damped_solve(H32, jnp.ones(2, jnp.float32), jnp.float32(0.5))
    expect = jnp.linalg.solve(H32 + 0.5 * jnp.eye(2), jnp.ones(2))
    assert jnp.allclose(u, expect, atol=1e-5)


def test_least_squares(key):
    k1, k2 = jax.random.split(key)
    A = jax.random.normal(k1, (20, 4), jnp.float64)
    x_true = jnp.asarray([1.0, -2.0, 0.5, 3.0])
    y = A @ x_true + 0.0
    x = least_squares(A, y)
    assert jnp.allclose(x, x_true, atol=1e-10)


def test_batched_via_vmap(key):
    As = jax.vmap(lambda k: random_matrix(k, 4, symmetric=True))(
        jax.random.split(key, 16)
    )
    bs = jnp.ones((16, 4))
    xs = jax.jit(jax.vmap(solve_cholesky))(As, bs)
    assert jnp.allclose(jnp.einsum("bij,bj->bi", As, xs), bs, atol=1e-8)


class TestParallelQR:
    """Batched parallel-order Givens QR (Sameh-Kuck wavefront,
    linalg/qr_parallel.py — tinyqr.h:253-310's role at fleet scale)."""

    def test_schedule_disjoint_and_complete(self):
        from nlsolver_tpu.linalg.qr_parallel import sameh_kuck_schedule

        m, n = 9, 6
        seen = set()
        for ps, qs, js, perm in sameh_kuck_schedule(m, n):
            rows = list(ps) + list(qs)
            assert len(rows) == len(set(rows))  # row-disjoint stage
            for q, j in zip(qs, js):
                seen.add((int(q), int(j)))
        assert seen == {(i, j) for j in range(n) for i in range(j + 1, m)}

    @pytest.mark.parametrize("m,n,B", [(8, 8, 16), (12, 5, 64), (4, 4, 1)])
    def test_factorization(self, key, m, n, B):
        from nlsolver_tpu.linalg import qr_parallel

        A = jax.random.normal(key, (m, n, B), jnp.float64)
        Q, R = jax.jit(qr_parallel)(A)
        rec = jnp.einsum("ik...,kj...->ij...", Q, R)
        orth = jnp.einsum("ki...,kj...->ij...", Q, Q) - jnp.eye(m)[:, :, None]
        assert float(jnp.max(jnp.abs(rec - A))) < 1e-12
        assert float(jnp.max(jnp.abs(orth))) < 1e-12
        assert float(jnp.max(jnp.abs(jnp.tril(jnp.moveaxis(R, -1, 0), -1)))) < 1e-12

    def test_least_squares_matches_lstsq(self, key):
        from nlsolver_tpu.linalg import least_squares_parallel

        m, n, B = 32, 3, 16
        k1, k2, k3 = jax.random.split(key, 3)
        A = jax.random.normal(k1, (m, n, B), jnp.float64)
        x_true = jax.random.normal(k2, (n, B), jnp.float64)
        y = jnp.einsum("mn...,n...->m...", A, x_true)
        y = y + 0.01 * jax.random.normal(k3, (m, B), jnp.float64)
        x = jax.jit(least_squares_parallel)(A, y)
        for b in range(4):
            xl = jnp.linalg.lstsq(A[:, :, b], y[:, b])[0]
            assert float(jnp.max(jnp.abs(x[:, b] - xl))) < 1e-10

    def test_qr_dispatcher(self, key):
        from nlsolver_tpu.linalg import qr

        A = jax.random.normal(key, (6, 6, 8), jnp.float32)
        Q, R = qr(A, method="parallel")
        rec = jnp.einsum("ik...,kj...->ij...", Q, R)
        assert float(jnp.max(jnp.abs(rec - A))) < 1e-4

    def test_vmap_over_leading_axis(self, key):
        from nlsolver_tpu.linalg import qr_parallel

        A = jax.random.normal(key, (5, 6, 6), jnp.float64)  # leading batch
        Q, R = jax.vmap(qr_parallel)(A)
        rec = jnp.einsum("bik,bkj->bij", Q, R)
        assert float(jnp.max(jnp.abs(rec - A))) < 1e-12


def test_qr_rejects_unconsumed_kwargs():
    """Advisor finding (round 4): qr(method='parallel', tile=64) silently
    dropped tile; no backend takes extra keyword arguments."""
    import pytest as _pytest

    A = jnp.eye(3)
    for method in ("householder", "givens", "parallel"):
        with _pytest.raises(TypeError, match="unexpected keyword"):
            qr(A, method=method, tile=64)


@pytest.mark.parametrize("m,n", [(16, 16), (16, 8), (32, 8)])
def test_wavefront_qr_matches_lapack(m, n):
    """The batch-minor jnp wavefront (the NLLS fleet's ``solve="qr"``)
    against LAPACK's QR on [m, n, B] fleets: |R| agrees (QR is unique up
    to row signs), Q is orthonormal and Q R rebuilds A."""
    import numpy as np

    from nlsolver_tpu.linalg import qr_parallel

    rng = np.random.default_rng(m * 100 + n)
    B = 256
    A = jnp.asarray(rng.standard_normal((m, n, B)))
    Q, R = qr_parallel(A)
    R_ref = jnp.linalg.qr(jnp.moveaxis(A, -1, 0), mode="complete")[1]
    assert float(jnp.max(jnp.abs(
        jnp.abs(jnp.moveaxis(R, -1, 0)) - jnp.abs(R_ref)))) < 1e-10
    eye = jnp.eye(m)[:, :, None]
    assert float(jnp.max(jnp.abs(
        jnp.einsum("ik...,il...->kl...", Q, Q) - eye))) < 1e-12
    assert float(jnp.max(jnp.abs(
        jnp.einsum("ik...,kj...->ij...", Q, R) - A))) < 1e-12


@pytest.mark.parametrize("m,n", [(16, 8), (8, 8), (8, 4)])
def test_wavefront_lstsq_matches_lapack(m, n):
    """Implicit-Q^T least squares on [m, n, B] against jnp.linalg.lstsq."""
    import numpy as np

    from nlsolver_tpu.linalg import least_squares_parallel

    rng = np.random.default_rng(m + 7 * n)
    B = 300
    A = jnp.asarray(rng.standard_normal((m, n, B)))
    y = jnp.asarray(rng.standard_normal((m, B)))
    x = least_squares_parallel(A, y)
    x_ref = jax.vmap(lambda a, b: jnp.linalg.lstsq(a, b)[0])(
        jnp.moveaxis(A, -1, 0), y.T)
    assert x.shape == (n, B)
    assert float(jnp.max(jnp.abs(x.T - x_ref))) < 1e-8
