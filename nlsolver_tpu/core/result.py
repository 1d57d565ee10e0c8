"""Solver result / status reporting.

The counterpart of the reference's ``solver_status`` struct
(reference: nlsolver.h:2054-2097).  Instead of a mutable C++ struct with a
``print()`` method, the result is an immutable pytree that flows out of
``jit``/``vmap``/``shard_map`` unchanged, carrying the same counters
(f_value, iteration, function_calls_used, gradient_evals_used,
hessian_evals_used) plus a convergence flag the reference lacks.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SolverResult(NamedTuple):
    """Outcome of a solver run.

    All fields are arrays so the structure is ``vmap``-able: batching a solve
    over 10k problem instances yields a single ``SolverResult`` whose leaves
    have a leading batch dimension.
    """

    x: jax.Array                  # final parameters, shape [..., n]
    f_value: jax.Array            # objective at x (sign-corrected for maximize)
    iterations: jax.Array         # algorithm iterations used
    function_calls: jax.Array     # objective evaluations used
    gradient_calls: jax.Array     # gradient evaluations used
    hessian_calls: jax.Array      # hessian evaluations used
    converged: jax.Array          # True if a tolerance criterion fired (not max_iter)

    def get_summary(self):
        """Mirror of solver_status::get_summary (nlsolver.h:2079-2083)."""
        return (
            self.function_calls,
            self.iterations,
            self.f_value,
            self.gradient_calls,
            self.hessian_calls,
        )

    def add(self, other: "SolverResult") -> "SolverResult":
        """Accumulate counters across restarts (nlsolver.h:2084-2091).

        Keeps ``other``'s solution/f_value (the later run's), sums counters.
        """
        return SolverResult(
            x=other.x,
            f_value=other.f_value,
            iterations=self.iterations + other.iterations,
            function_calls=self.function_calls + other.function_calls,
            gradient_calls=self.gradient_calls + other.gradient_calls,
            hessian_calls=self.hessian_calls + other.hessian_calls,
            converged=other.converged,
        )

    def print(self) -> None:
        """Host-side pretty printer (mirrors nlsolver.h:2065-2078)."""
        print(f"Function calls used: {int(jnp.sum(self.function_calls))}")
        print(f"Algorithm iterations used: {int(jnp.sum(self.iterations))}")
        g = int(jnp.sum(self.gradient_calls))
        if g > 0:
            print(f"Gradient evaluations used: {g}")
        h = int(jnp.sum(self.hessian_calls))
        if h > 0:
            print(f"Hessian evaluations used: {h}")
        fv = jnp.asarray(self.f_value)
        if fv.ndim == 0:
            print(f"With final function value of {float(fv)}")
        else:
            print(
                f"With best final function value of {float(jnp.min(fv))} "
                f"(batch of {fv.shape})"
            )


def make_result(
    x: jax.Array,
    f_value: jax.Array,
    iterations,
    function_calls,
    gradient_calls=0,
    hessian_calls=0,
    converged=False,
) -> SolverResult:
    i32 = jnp.int32
    return SolverResult(
        x=x,
        f_value=f_value,
        iterations=jnp.asarray(iterations, i32),
        function_calls=jnp.asarray(function_calls, i32),
        gradient_calls=jnp.asarray(gradient_calls, i32),
        hessian_calls=jnp.asarray(hessian_calls, i32),
        converged=jnp.asarray(converged, bool),
    )
