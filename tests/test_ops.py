"""Batched ops: numerical equivalence of the batched formulations with
per-instance references."""
import jax
import jax.numpy as jnp
import pytest

from nlsolver_tpu.ops import rank2_update_batched, solve_spd_batched
from nlsolver_tpu.ops.rank2 import rank2_update_reference


def _spd_batch(key, B, n, dtype=jnp.float32):
    A = jax.random.normal(key, (B, n, n), dtype)
    return jnp.einsum("bij,bkj->bik", A, A) + 2 * jnp.eye(n, dtype=dtype)


def test_rank2_jnp_matches_per_instance(key):
    B, n = 32, 8
    k1, k2, k3, k4 = jax.random.split(key, 4)
    H = _spd_batch(k1, B, n, jnp.float64)
    s = jax.random.normal(k2, (B, n), jnp.float64)
    y = jax.random.normal(k3, (B, n), jnp.float64)
    rho = 1.0 / jnp.einsum("bi,bi->b", y, s)
    batched = rank2_update_batched(H, s, y, rho)
    per = jax.vmap(rank2_update_reference)(H, s, y, rho)
    assert jnp.allclose(batched, per, atol=1e-10)


def test_solve_spd_batched(key):
    B, n = 128, 6
    k1, k2 = jax.random.split(key)
    A = _spd_batch(k1, B, n, jnp.float64)
    b = jax.random.normal(k2, (B, n), jnp.float64)
    x = solve_spd_batched(A, b)
    assert jnp.allclose(jnp.einsum("bij,bj->bi", A, x), b, atol=1e-8)


def test_solve_spd_batchminor_matches_batched(key):
    """The unrolled batch-minor Cholesky (the NLLS fleet's solve) agrees
    with XLA's batched cho_solve on the standard layout."""
    from nlsolver_tpu.ops import solve_spd_batchminor

    B, n = 128, 4
    k1, k2 = jax.random.split(key)
    A = _spd_batch(k1, B, n, jnp.float32)
    b = jax.random.normal(k2, (B, n), jnp.float32)
    ref = solve_spd_batched(A, b)
    out = solve_spd_batchminor(jnp.moveaxis(A, 0, -1), b.T).T
    assert jnp.allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,B", [(128, 96), (64, 100), (16, 64)])
def test_rank2_batchminor_matches_batched(key, n, B):
    """The BFGS fleet's fused update + direction ([n, n, B], reset lanes
    substitute the identity) against the [B, n, n] update, at large n."""
    from nlsolver_tpu.ops import rank2_direction_batchminor

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    H = jax.random.normal(k1, (n, n, B), jnp.float32)
    H = (H + jnp.swapaxes(H, 0, 1)) / 2
    s = jax.random.normal(k2, (n, B), jnp.float32)
    y = jax.random.normal(k3, (n, B), jnp.float32)
    g = jax.random.normal(k4, (n, B), jnp.float32)
    rho = jax.random.uniform(k5, (B,), jnp.float32, 0.1, 1.0)
    reset = jnp.arange(B) % 3 == 0
    Hn, d = rank2_direction_batchminor(H, s, y, g, rho, reset)

    Hb = jnp.where(reset[:, None, None], jnp.eye(n, dtype=H.dtype),
                   jnp.moveaxis(H, -1, 0))
    Hn_ref = rank2_update_batched(Hb, s.T, y.T, rho)
    d_ref = -jnp.sum(Hn_ref * g.T[:, None, :], axis=2)
    scale_h = float(jnp.max(jnp.abs(Hn_ref)))
    scale_d = float(jnp.max(jnp.abs(d_ref)))
    assert jnp.allclose(jnp.moveaxis(Hn, -1, 0), Hn_ref, atol=1e-5 * scale_h)
    assert jnp.allclose(d.T, d_ref, atol=1e-5 * scale_d)
