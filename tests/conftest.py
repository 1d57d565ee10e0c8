"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic
(`shard_map` over a Mesh) is exercised without GPUs.  Must run before jax
is imported.

Tests marked ``gpu`` need a real GPU: the ``_gpu_only`` fixture skips
them elsewhere.  Run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` (``chip_smoke.py``
does so as its last phase).
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")  # silence XLA AOT-cache noise
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Solver literature (and the reference, which is double-only) assumes f64;
# tests validate numerics in both widths where it matters.
jax.config.update("jax_enable_x64", True)

# XLA compiles dominate test time; keep them across runs.  Round-4
# finding: one process that has loaded ~500 XLA:CPU executables can
# segfault inside jaxlib on the next load, so run the suite with
# pytest-xdist workers (`-n`), which keeps each process under that size.
from nlsolver_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.key(42)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU.

    Decided here, at run time, and never while a module is imported, so
    every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {platform!r}")
