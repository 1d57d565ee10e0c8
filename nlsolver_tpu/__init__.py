"""nlsolver_tpu — nonlinear optimization framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of
JSzitas/nlsolver: the full solver zoo
(Nelder-Mead, DE, PSO, SANN, NM-PSO, GD variants, CGD, BFGS,
Levenberg-Marquardt, Brent, seven 1-D root finders, CMA-ES), built as pure
init/step state machines over pytrees so a single implementation runs under
``jit`` (one problem), ``vmap`` (thousands of problems per chip) and
``shard_map`` (populations and fleets sharded over a device mesh).
"""
from .api import (
    curve_fit,
    fit,
    fit_batched,
    fit_fleet,
    fit_fleet_sharded,
    fit_sharded,
    NLLSConfig,
    NLLSFleetConfig,
    maximize,
    methods,
    minimize,
    root,
    root_methods,
)
from .core import Bounds, SolverResult

__version__ = "0.3.0"

__all__ = [
    "Bounds",
    "SolverResult",
    "curve_fit",
    "fit",
    "fit_batched",
    "fit_fleet",
    "fit_fleet_sharded",
    "fit_sharded",
    "NLLSConfig",
    "NLLSFleetConfig",
    "maximize",
    "methods",
    "minimize",
    "root",
    "root_methods",
]
