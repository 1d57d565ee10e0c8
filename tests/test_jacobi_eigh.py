"""Batched parallel-order Jacobi eigensolver (linalg/jacobi.py) — the
tinyqr-class batched eigensolver (tinyqr.h:317-434 replacement).
Correctness bar from the round-2 verdict: 1e-5 vs jnp.linalg.eigh; f64
reaches machine precision."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsolver_tpu.linalg import eigh
from nlsolver_tpu.linalg.jacobi import eigh_jacobi, round_robin_schedule


def sym(rng, n, b=None, dtype=np.float64):
    shape = (n, n) if b is None else (b, n, n)
    A = rng.standard_normal(shape).astype(dtype)
    return (A + np.swapaxes(A, -1, -2)) / 2


def test_schedule_covers_all_pairs():
    for n in (2, 3, 4, 8, 15, 16, 17, 32):
        seen = set()
        for ps, qs, perm, _ in round_robin_schedule(n):
            assert len(ps) == len(qs)
            for p, q in zip(ps, qs):
                assert p < q
                assert perm[p] == q and perm[q] == p
                seen.add((int(p), int(q)))
        assert len(seen) == n * (n - 1) // 2, n


@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 17, 32])
def test_eigh_jacobi_matches_xla(n):
    rng = np.random.default_rng(n)
    A = jnp.asarray(sym(rng, n))
    w, v = eigh_jacobi(A)
    w0, _ = jnp.linalg.eigh(A)
    assert float(jnp.max(jnp.abs(w - w0))) < 1e-10
    # eigenpair residuals + orthonormality
    assert float(jnp.max(jnp.abs(A @ v - v * w[None, :]))) < 1e-10
    assert float(jnp.max(jnp.abs(v.T @ v - jnp.eye(n)))) < 1e-12


def test_eigh_jacobi_batchminor_and_vmap_agree():
    rng = np.random.default_rng(0)
    B, n = 48, 12
    As = sym(rng, n, B)
    w0 = np.linalg.eigh(As)[0]                       # [B, n]
    # trailing batch dims (batch-minor)
    wbm, _ = jax.jit(eigh_jacobi)(jnp.asarray(np.moveaxis(As, 0, -1)))
    assert float(np.max(np.abs(np.moveaxis(np.asarray(wbm), -1, 0) - w0))) < 1e-10
    # vmap over a leading axis
    wv, _ = jax.jit(jax.vmap(eigh_jacobi))(jnp.asarray(As))
    assert float(np.max(np.abs(np.asarray(wv) - w0))) < 1e-10


@pytest.mark.parametrize("n,B", [(4, 256), (16, 256), (17, 128), (8, 300)])
def test_batchminor_matches_lapack(n, B):
    """The batch-minor jnp Jacobi (the CMA-ES fleet's default eigensolver)
    matches LAPACK on [n, n, B] fleets, eigenvalues and reconstruction."""
    rng = np.random.default_rng(n)
    As = sym(rng, n, B)
    Abm = jnp.asarray(np.moveaxis(As, 0, -1))
    w, V = jax.jit(eigh_jacobi)(Abm)
    assert w.shape == (n, B) and V.shape == (n, n, B)
    w0 = np.linalg.eigh(As)[0]
    assert float(np.max(np.abs(np.moveaxis(np.asarray(w), -1, 0) - w0))) < 1e-10
    for b in (0, B // 2, B - 1):
        Vb = np.asarray(V)[..., b]
        db = np.asarray(w)[:, b]
        assert np.max(np.abs((Vb * db[None]) @ Vb.T - As[b])) < 1e-10


def test_eigh_dispatcher_methods():
    rng = np.random.default_rng(3)
    A = jnp.asarray(sym(rng, 8))
    w_x = eigh(A, method="xla").eigenvalues
    w_j = eigh(A, method="jacobi").eigenvalues
    assert float(jnp.max(jnp.abs(w_x - w_j))) < 1e-10
    with pytest.raises(ValueError, match="eigh method"):
        eigh(A, method="nope")


def test_f32_meets_verdict_tolerance():
    """Round-2 verdict bar: 1e-5 agreement with jnp.linalg.eigh in the
    fleet dtype (f32)."""
    rng = np.random.default_rng(7)
    B, n = 64, 16
    As = sym(rng, n, B, dtype=np.float32)
    wbm, _ = jax.jit(eigh_jacobi)(jnp.asarray(np.moveaxis(As, 0, -1)))
    w0 = np.linalg.eigh(As.astype(np.float64))[0]
    scale = np.max(np.abs(w0))
    err = np.max(np.abs(np.moveaxis(np.asarray(wbm), -1, 0) - w0)) / scale
    assert err < 1e-5, err
