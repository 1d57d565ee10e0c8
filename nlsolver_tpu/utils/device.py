"""The device a measurement runs on.

``bench.py`` and ``chip_smoke.py`` measure the GPU and nothing else: they
call :func:`require_gpu` before their first computation, so a machine
without a GPU fails loudly instead of quietly measuring the CPU.
"""
from __future__ import annotations

import subprocess

import jax


def require_gpu() -> jax.Device:
    """Return JAX's default device; exit non-zero unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU, but JAX's default device is "
            f"{dev.platform}:{dev.device_kind} ({len(jax.devices())} devices)"
        )
    return dev


def describe() -> dict:
    """Platform, kind and count as JAX reports them."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each card, one line each, as nvidia-smi
    prints them (the limit bounds the clocks a card holds under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
