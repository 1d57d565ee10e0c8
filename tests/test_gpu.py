"""Numerics that only a GPU can show.

A float32 product at default precision may run in TF32 on a GPU (a 10-bit
mantissa), and the CPU never does.  These tests run the solver pieces that
take products on the default device and compare them with float64 numpy
at float32 tolerances that TF32 misses by about two orders of magnitude.
They are marked ``gpu`` and skip elsewhere (conftest's ``_gpu_only``);
``chip_smoke.py`` runs them on the card as its last phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

F32 = jnp.float32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_nlls_fleet_normal_equations_f32_accurate():
    """The NLLS fleet's damped normal-equation solve (J^T J, J^T r)."""
    from nlsolver_tpu.solvers import nlls_fleet as nf

    rng = np.random.default_rng(0)
    m, n, B = 32, 4, 1024
    J = rng.standard_normal((m, n, B)).astype(np.float32)
    r = rng.standard_normal((m, B)).astype(np.float32)
    lam = np.full((B,), 0.1, np.float32)
    delta = jax.jit(lambda J, r, lam: nf._delta(
        J=J, r=r, lam=lam, config=nf.NLLSFleetConfig()))(J, r, lam)
    J64, r64 = J.astype(np.float64), r.astype(np.float64)
    A = np.einsum("mib,mjb->bij", J64, J64) + 0.1 * np.eye(n)
    g = np.einsum("mib,mb->bi", J64, r64)
    ref = np.linalg.solve(A, g[..., None])[..., 0].T
    assert _rel(delta, ref) < 1e-5


def test_bfgs_update_and_direction_f32_accurate():
    """The row BFGS rank-2 update and its H @ g direction."""
    from nlsolver_tpu.solvers import bfgs

    rng = np.random.default_rng(1)
    n = 64
    A = rng.standard_normal((n, n))
    H = (A @ A.T / n + np.eye(n)).astype(np.float32)
    s, y, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    rho = np.float32(1.0 / abs(float(s @ y)))

    def step(H, s, y, g, rho):
        Hn = bfgs.rank2_update(H, s, y, rho)
        return Hn, -jnp.matmul(Hn, g, precision=jax.lax.Precision.HIGHEST)

    Hn, d = jax.jit(step)(H, s, y, g, rho)
    H64, s64, y64, g64 = (v.astype(np.float64) for v in (H, s, y, g))
    Hy = H64 @ y64
    coef = float(rho) * (1.0 + float(rho) * (y64 @ Hy))
    Hn64 = (H64 - float(rho) * (np.outer(s64, Hy) + np.outer(Hy, s64))
            + coef * np.outer(s64, s64))
    assert _rel(Hn, Hn64) < 1e-5
    assert _rel(d, -Hn64 @ g64) < 1e-5


def test_cmaes_sampling_f32_accurate():
    """CMA-ES sampling y = (z D) B^T and the rank-mu sum, through one
    generation of the row engine against the same generation on the CPU
    backend (same key, so the same draws)."""
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import cmaes

    fn = PROBLEMS["rastrigin"].fn
    x0 = jnp.full((16,), 2.0, F32)
    cfg = cmaes.CMAESConfig()
    key = jax.random.key(3)

    def one_gen(x0, key):
        s = cmaes.init(fn, x0, cfg, key)
        return cmaes.step(fn, s, cfg).C

    C_dev = jax.jit(one_gen)(x0, key)
    cpu = jax.devices("cpu")[0]
    C_cpu = jax.jit(one_gen)(*jax.device_put((x0, key), cpu))
    assert _rel(C_dev, C_cpu) < 1e-5


def test_lbfgsb_bounded_quadratic_on_device():
    """L-BFGS-B's compact-form products: a bounded quadratic whose answer
    is the centre clipped into the box.  In float32 the objective's own
    resolution near its minimum bounds x to ~1e-4 (9.1e-5 measured on the
    CPU), hence 1e-3."""
    import nlsolver_tpu
    from nlsolver_tpu.core import Bounds
    from nlsolver_tpu.solvers import lbfgsb

    rng = np.random.default_rng(4)
    n = 32
    c = rng.uniform(-3, 3, n).astype(np.float32)
    w = rng.uniform(0.5, 4.0, n).astype(np.float32)
    box = Bounds(jnp.full((n,), -1.0, F32), jnp.full((n,), 1.0, F32))
    res = jax.jit(lambda x0: nlsolver_tpu.minimize(
        lambda x: jnp.sum(w * (x - c) ** 2), x0, "lbfgsb",
        lbfgsb.LBFGSBConfig(max_iter=200), bounds=box))(jnp.zeros((n,), F32))
    assert float(np.max(np.abs(np.asarray(res.x) - np.clip(c, -1, 1)))) < 1e-3
