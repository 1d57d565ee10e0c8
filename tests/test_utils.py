"""Timing harness, checkpoint round-trips, observability hooks."""
import os

import jax
import pytest
import jax.numpy as jnp

from nlsolver_tpu.utils import (
    Benchmarker,
    Stopwatch,
    StreamingMedian,
    benchmark,
    debug_nans,
    load,
    save,
)


def test_stopwatch(capsys):
    with Stopwatch("t") as sw:
        sum(range(1000))
    assert sw.elapsed_us > 0
    assert "[t] elapsed" in capsys.readouterr().out


def test_streaming_median():
    m = StreamingMedian()
    for v in [5.0, 1.0, 3.0, 2.0, 4.0]:
        m.push(v)
    assert m.median == 3.0
    m.push(100.0)
    assert m.median == 3.5


def test_benchmark_and_benchmarker():
    f = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((128,))
    stats = benchmark(f, x, runs=3, warmup=1)
    assert stats["median_us"] > 0
    b = Benchmarker(runs=3, warmup=1)
    b.run("a", f, x)
    b.run("b", f, x)
    assert b.speedup("a", "b") > 0
    assert "median" in b.report()


def test_checkpoint_roundtrip(tmp_path, key):
    from nlsolver_tpu.problems import PROBLEMS
    from nlsolver_tpu.solvers import de
    from nlsolver_tpu.solvers.de import DEConfig

    p = PROBLEMS["rosenbrock"]
    cfg = DEConfig(max_iter=50)
    state = de.init(p.fn, jnp.full((2,), -0.5), cfg, key)
    step = jax.jit(lambda s: de.step(p.fn, s, cfg))
    for _ in range(5):
        state = step(state)

    path = os.path.join(tmp_path, "ckpt.npz")
    save(path, state)
    restored = load(path, state)

    # resuming from the restored state reproduces the original trajectory
    a = step(state)
    b = step(restored)
    assert jnp.allclose(a.agents, b.agents)
    assert jnp.allclose(a.scores, b.scores)


def test_debug_nans_context():
    with debug_nans(True):
        assert jax.config.jax_debug_nans
    assert not jax.config.jax_debug_nans


class TestProgressHook:
    """io_callback progress streaming on core.drive (driver.attach_progress)."""

    def _run(self, **kw):
        import jax
        import jax.numpy as jnp
        from nlsolver_tpu.problems import PROBLEMS
        from nlsolver_tpu.solvers import de_batched
        from nlsolver_tpu.solvers.de import DEConfig

        calls = []

        def progress(iteration, best, active):
            calls.append((iteration, best, active))

        cfg = DEConfig(pop_size=16, max_iter=40, best_value_no_change=1 << 30,
                       eps=0.0, partner_sampling="rotation")
        x0 = jnp.full((8, 3), -0.5, jnp.float32)
        keys = jax.random.split(jax.random.key(0, impl="rbg"), 8)
        res = jax.jit(
            lambda x0, keys: de_batched.minimize_batched(
                PROBLEMS["sphere"].fn, x0, cfg, keys=keys,
                progress=progress, **kw)
        )(x0, keys)
        jax.block_until_ready(res.x)
        return calls, res

    def test_reports_every_k_and_at_termination(self):
        calls, res = self._run(progress_every=10)
        its = [c[0] for c in calls]
        assert set(its) >= {10, 20, 30, 40}
        # values are real floats and non-increasing at the reported points
        bests = [c[1] for c in calls if c[0] in (10, 20, 30, 40)]
        assert all(b2 <= b1 + 1e-6 for b1, b2 in zip(bests, bests[1:]))
        # last report fires when all lanes finish
        assert calls[-1][2] == 0 or calls[-1][0] >= 40

    def test_silent_solve_identical(self):
        import jax
        import jax.numpy as jnp
        from nlsolver_tpu.problems import PROBLEMS
        from nlsolver_tpu.solvers import de_batched
        from nlsolver_tpu.solvers.de import DEConfig

        cfg = DEConfig(pop_size=16, max_iter=40, best_value_no_change=1 << 30,
                       eps=0.0, partner_sampling="rotation")
        x0 = jnp.full((8, 3), -0.5, jnp.float32)
        keys = jax.random.split(jax.random.key(0, impl="rbg"), 8)
        calls, res_mon = self._run(progress_every=10)
        res_silent = jax.jit(
            lambda x0, keys: de_batched.minimize_batched(
                PROBLEMS["sphere"].fn, x0, cfg, keys=keys)
        )(x0, keys)
        assert jnp.array_equal(res_mon.f_value, res_silent.f_value)

    def test_progress_fires_on_repeat_invocations(self):
        """Regression (r3 review): the host-side dedup must be
        per-execution — a second call of the same compiled solve reports
        again (a per-trace set swallowed everything after run one)."""
        counts = []
        for _ in range(2):
            calls, _ = self._run(progress_every=10)
            counts.append(len(calls))
        assert counts[0] > 0 and counts[1] > 0
        assert counts[1] >= counts[0] - 1  # same cadence both runs


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left alone; without it the
    cache is the checkout's .jax_cache (a fixed path, never a temp name)."""
    from nlsolver_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "sentinel")
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "sentinel"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
