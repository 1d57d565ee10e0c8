"""Derivative-provider abstraction.

The reference's gradient solvers accept any ``Grad`` functor with signature
``g(f, x, grad_out)`` and default to finite differences
(``fin_diff``/``fin_diff_h`` adapters, nlsolver.h:2848-2863).  Here the
provider is a small frozen config choosing autodiff (the default — replaces
the 4n-objective-eval FD gradient with one backward pass) or the parity FD
stencils; solvers also accept a user-supplied gradient callable.

``make_grad``/``make_hessian`` return ``(callable, f_eval_cost)`` where
``f_eval_cost`` is the number of objective evaluations one call costs —
used to keep ``function_calls`` counters faithful to the reference's
accounting (its FD evals route through the counting ``f_lam``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax

from .fd import fd_gradient, fd_gradient_cost, fd_hessian, fd_hessian_cost


@dataclass(frozen=True)
class Deriv:
    """Derivative provider config.

    mode: "autodiff" (jax.grad/jax.hessian) or "fd" (reference stencils).
    accuracy: FD accuracy level (ignored for autodiff).
    """

    mode: str = "autodiff"
    accuracy: int = 1


def make_grad(
    fn, n: int, deriv: Deriv = Deriv(), custom: Optional[Callable] = None
):
    """Return (grad_fn, f_evals_per_call)."""
    if custom is not None:
        return custom, 0
    if deriv.mode == "fd":
        return (
            lambda x: fd_gradient(fn, x, deriv.accuracy),
            fd_gradient_cost(n, deriv.accuracy),
        )
    return jax.grad(fn), 0


def make_hessian(
    fn, n: int, deriv: Deriv = Deriv(), custom: Optional[Callable] = None
):
    """Return (hess_fn, f_evals_per_call)."""
    if custom is not None:
        return custom, 0
    if deriv.mode == "fd":
        return (
            lambda x: fd_hessian(fn, x, deriv.accuracy),
            fd_hessian_cost(n, deriv.accuracy),
        )
    return jax.hessian(fn), 0
