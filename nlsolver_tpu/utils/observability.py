"""Tracing / debugging hooks.

The reference's observability surface is ``solver_status`` counters plus
raw stdout (SURVEY.md §5).  The equivalents here:

  * counters ride inside every solver state / SolverResult (jit-pure);
  * ``trace()`` wraps ``jax.profiler.trace`` to capture a TensorBoard-
    compatible device profile of a solve;
  * ``debug_nans()`` flips jax's NaN checker for a scope (the moral
    equivalent of running the reference under a sanitizer — SURVEY.md §5
    "race detection / sanitizers": jit purity + nan-checking replace TSan);
  * ``log_compiles()`` surfaces recompilation, the #1 silent performance
    bug in jit-heavy code.
"""
from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block onto ``logdir`` (view with TensorBoard/XProf)."""
    with jax.profiler.trace(logdir):
        yield


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def log_compiles(enable: bool = True):
    prev = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", enable)
    try:
        yield
    finally:
        jax.config.update("jax_log_compiles", prev)
