"""Finite-difference derivatives with the reference's stencils.

Re-creation of ``nlsolver::finite_difference`` (nlsolver.h:1383-1518).  The
default derivative path is autodiff (``jax.grad``/``jax.hessian``);
these stencils exist for parity testing and for objectives that are
jax-traceable but whose analytic gradients the user wants to avoid trusting.

Unlike the reference's per-dimension scalar loops, all stencil points are
built as one ``[n_evals, n]`` perturbation batch and scored with a single
vmapped call.

Gradient accuracy a in {0,1,2,3} uses the 2/4/6/8-point central stencils
with coefficient tables from nlsolver.h:1390-1398 and
eps = machine_eps * 1e8 (nlsolver.h:1389).
Hessian accuracy 0 is the 4-eval cross stencil (nlsolver.h:1422-1446);
accuracy >= 1 is the 16-eval high-order stencil with /(600 eps^2)
denominator (nlsolver.h:1447-1516); eps = machine_eps^0.25
(nlsolver.h:1417-1419).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

# central-difference stencils per accuracy level (nlsolver.h:1390-1395):
# (offsets in units of eps, weights, denominator multiple of eps)
_GRAD_STENCILS = {
    0: ((1.0, -1.0), (1.0, -1.0), 2.0),
    1: ((1.0, -8.0, 8.0, -1.0), (-2.0, -1.0, 1.0, 2.0), 12.0),
    2: ((-1.0, 9.0, -45.0, 45.0, -9.0, 1.0), (-3.0, -2.0, -1.0, 1.0, 2.0, 3.0), 60.0),
    3: (
        (3.0, -32.0, 168.0, -672.0, 672.0, -168.0, 32.0, -3.0),
        (-4.0, -3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 4.0),
        840.0,
    ),
}

# The reference's Hessian perturbs x IN PLACE with chained +=/-= increments
# (nlsolver.h:1455-1511), so each evaluation point is a specific sequence of
# IEEE adds, not a clean x + k*eps.  To stay bit-exact we replay the same
# (i-increment, j-increment) op sequence; entry k is applied before eval k.
# 16-eval high-order stencil (accuracy >= 1); groups of 4 share a weight.
_HESS_OPS_HI = (
    (1, -2), (1, 1), (-4, 2), (1, 1),      # group 1 (net offsets (+1,-2),(+2,-1),(-2,+1),(-1,+2)), weight -63
    (0, -4), (-1, 1), (3, 3), (1, -1),     # group 2 ((-1,-2),(-2,-1),(+1,+2),(+2,+1)), weight +63
    (0, -3), (-4, 4), (0, -4), (4, 4),     # group 3 ((+2,-2),(-2,+2),-(-2,-2),-(+2,+2)), weight +44
    (-3, -3), (2, 2), (0, -2), (-2, 2),    # group 4 ((-1,-1),(+1,+1),-(+1,-1),-(-1,+1)), weight +74
)
# 4-eval cross stencil (accuracy 0, nlsolver.h:1427-1445):
# f(x) + f(+e,+e) - f(+e,0) - f(0,+e), same chained-increment convention.
_HESS_OPS_LO = ((0, 0), (1, 1), (0, -1), (-1, 1))


@dataclass(frozen=True)
class FDConfig:
    accuracy: int = 1  # the solvers' fin_diff adapters use accuracy=1 (:2848-2863)


def _grad_eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps) * 1e8


def _hess_eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps) ** 0.25


def fd_gradient_cost(n: int, accuracy: int = 1) -> int:
    """Objective evaluations one gradient costs (for counter parity)."""
    return n * 2 * (accuracy + 1)


def fd_hessian_cost(n: int, accuracy: int = 1) -> int:
    return n * n * (4 if accuracy == 0 else 16)


def fd_gradient(fn, x: jax.Array, accuracy: int = 1) -> jax.Array:
    """Central-difference gradient, one batched evaluation.

    Bit-exact with the reference's scalar loop (nlsolver.h:1402-1410): the
    perturbed points are built from the same ``x[d] + coeff2[s]*eps``
    products and the weighted values are accumulated in the same
    left-to-right order (``grad[d] += coeff[s]*f`` then ``/= dd*eps``), so
    trajectory-parity tests can compare FD-driven solvers at f64 resolution.
    """
    coeffs, offsets, dd = _GRAD_STENCILS[accuracy]
    n = x.shape[-1]
    eps = jnp.asarray(_grad_eps(x.dtype), x.dtype)
    offs = jnp.asarray(offsets, x.dtype) * eps          # [s]
    eye = jnp.eye(n, dtype=x.dtype)
    # [n, s, n] perturbed points: x + off_s * e_d
    pts = x[None, None, :] + offs[None, :, None] * eye[:, None, :]
    vals = jax.vmap(jax.vmap(fn))(pts)                  # [n, s]
    acc = vals[:, 0] * coeffs[0]
    for s in range(1, len(coeffs)):
        acc = acc + vals[:, s] * coeffs[s]
    # the reference divides by the constexpr product dd*eps (nlsolver.h:1401).
    # The barrier stops XLA's algebraic simplifier from strength-reducing the
    # divide-by-constant into a multiply-by-reciprocal (1-ulp difference).
    denom = jax.lax.optimization_barrier(
        jnp.asarray(dd * _grad_eps(x.dtype), acc.dtype)
    )
    return acc / denom


def fd_hessian(fn, x: jax.Array, accuracy: int = 1) -> jax.Array:
    """Finite-difference Hessian, one batched evaluation of all entries.

    Bit-exact with the reference's in-place perturbation loops
    (nlsolver.h:1427-1511): evaluation points replay the same chained
    +=/-= increment sequences (including the aliased i == j case, where
    both increments land on the same coordinate), and the grouped
    accumulation order matches (``temp`` sums of 4, then
    ``result -=/+= w*temp``, then one divide).
    """
    n = x.shape[-1]
    eps = _hess_eps(x.dtype)                   # python float, exact constant
    epsa = jnp.asarray(eps, x.dtype)
    ops = _HESS_OPS_LO if accuracy == 0 else _HESS_OPS_HI
    # chained coordinate values: vi/vj for the off-diagonal roles, vd for the
    # aliased diagonal (i == j) where both increments hit one coordinate
    vi = vj = vd = x
    ci, cj, cd = [], [], []
    for oi, oj in ops:
        if oi:
            vi = vi + oi * epsa
            vd = vd + oi * epsa
        if oj:
            vj = vj + oj * epsa
            vd = vd + oj * epsa
        ci.append(vi)
        cj.append(vj)
        cd.append(vd)
    K = len(ops)
    ci = jnp.stack(ci)[None, None]             # [1, 1, K, n]
    cj = jnp.stack(cj)[None, None]
    cd = jnp.stack(cd)[None, None]
    eye = jnp.eye(n, dtype=bool)
    mi = eye[:, None, None, :]                 # [n, 1, 1, n]
    mj = eye[None, :, None, :]                 # [1, n, 1, n]
    # [n, n, K, n]: coordinate i takes the i-role chain, j the j-role chain,
    # the diagonal (i == j) the aliased chain, everything else stays at x
    pts = jnp.where(mi & mj, cd, jnp.where(mi, ci, jnp.where(mj, cj, x)))
    vals = jax.vmap(jax.vmap(jax.vmap(fn)))(pts)            # [n, n, K]
    v = [vals[..., k] for k in range(K)]
    if accuracy == 0:
        result = ((v[0] + v[1]) - v[2]) - v[3]
        denom = eps * eps
    else:
        g1 = ((v[0] + v[1]) + v[2]) + v[3]
        g2 = ((v[4] + v[5]) + v[6]) + v[7]
        g3 = ((v[8] + v[9]) - v[10]) - v[11]
        g4 = ((v[12] + v[13]) - v[14]) - v[15]
        result = (((0.0 - 63.0 * g1) + 63.0 * g2) + 44.0 * g3) + 74.0 * g4
        denom = (600.0 * eps) * eps            # nlsolver.h:1448 constant order
    # barrier: keep the true divide (see fd_gradient)
    return result / jax.lax.optimization_barrier(jnp.asarray(denom, x.dtype))
