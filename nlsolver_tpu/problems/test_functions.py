"""Analytic benchmark objectives with known-minima oracles.

Re-creation of the reference test-function suite
(reference: test_functions.h:50-319).  Each problem is a pure function of a
vector ``x`` (shape ``[n]``), written in jnp so it traces under
``jit``/``vmap``/``grad`` and fuses into elementwise code.  Where the reference hardcodes
2-D forms, the classical n-D generalization is used when one exists (sphere,
rosenbrock, rastrigin, ackley, styblinski_tang), defaulting to the
reference's dimension so optima oracles stay valid.

Each problem record carries:
  * ``fn``       — the objective
  * ``dim``      — default dimensionality (reference ``input_size()``)
  * ``minima``   — array [k, n] of known global minimizers (``minimum(idx)``)
  * ``fmin``     — objective value at the minima
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import jax
import jax.numpy as jnp

PI = math.pi


@dataclass(frozen=True)
class Problem:
    name: str
    fn: Callable[[jax.Array], jax.Array]
    dim: int
    minima: tuple  # tuple of tuples, converted lazily to keep dataclass hashable
    fmin: float
    # classical search domain (used by bounded solvers / PSO implied bounds)
    lower: tuple = ()
    upper: tuple = ()

    @property
    def minima_array(self) -> jax.Array:
        return jnp.asarray(self.minima)

    def distance_to_nearest_minimum(self, x: jax.Array) -> jax.Array:
        """max-abs distance to the nearest known minimum — the reference's
        pass criterion |x_i - x*_i| <= tol for some minimum
        (test_functions.h:392-428)."""
        d = jnp.abs(x[None, :] - self.minima_array)
        return jnp.min(jnp.max(d, axis=-1))


def sphere(x):  # test_functions.h:52-57
    return jnp.sum(x * x)


def rosenbrock(x):  # test_functions.h:60-68 (note: 100(x0^2 - x1)^2 variant)
    return jnp.sum(100.0 * (x[:-1] ** 2 - x[1:]) ** 2 + (x[:-1] - 1.0) ** 2)


def rastrigin(x):  # test_functions.h:71-79
    n = x.shape[-1]
    return 10.0 * n + jnp.sum(x * x - 10.0 * jnp.cos(2.0 * PI * x))


def ackley(x):  # test_functions.h:82-92
    n = x.shape[-1]
    a = -20.0 * jnp.exp(-0.2 * jnp.sqrt(jnp.sum(x * x) / n))
    b = -jnp.exp(jnp.sum(jnp.cos(2.0 * PI * x)) / n)
    return a + b + jnp.e + 20.0


def beale(x):  # test_functions.h:95-104
    x0, x1 = x[0], x[1]
    return (
        (1.5 - x0 + x0 * x1) ** 2
        + (2.25 - x0 + x0 * x1**2) ** 2
        + (2.625 - x0 + x0 * x1**3) ** 2
    )


def goldstein_price(x):  # test_functions.h:107-120
    x0, x1 = x[0], x[1]
    a = 1.0 + (x0 + x1 + 1.0) ** 2 * (
        19.0 - 14.0 * x0 + 3.0 * x0**2 - 14.0 * x1 + 6.0 * x0 * x1 + 3.0 * x1**2
    )
    b = 30.0 + (2.0 * x0 - 3.0 * x1) ** 2 * (
        18.0 - 32.0 * x0 + 12.0 * x0**2 + 48.0 * x1 - 36.0 * x0 * x1 + 27.0 * x1**2
    )
    return a * b


def himmelblau(x):  # test_functions.h:122-138
    x0, x1 = x[0], x[1]
    return (x0**2 + x1 - 11.0) ** 2 + (x0 + x1**2 - 7.0) ** 2


def three_hump_camel(x):  # test_functions.h:140-148
    x0, x1 = x[0], x[1]
    return 2.0 * x0**2 - 1.05 * x0**4 + x0**6 / 6.0 + x0 * x1 + x1**2


def cross_in_tray(x):  # test_functions.h:150-171
    x0, x1 = x[0], x[1]
    inner = jnp.abs(
        jnp.sin(x0) * jnp.sin(x1) * jnp.exp(jnp.abs(100.0 - jnp.sqrt(x0**2 + x1**2) / PI))
    )
    return -0.0001 * (inner + 1.0) ** 0.1


def eggholder(x):  # test_functions.h:173-182
    x0, x1 = x[0], x[1]
    return -(x1 + 47.0) * jnp.sin(jnp.sqrt(jnp.abs(x0 / 2.0 + (x1 + 47.0)))) - x0 * jnp.sin(
        jnp.sqrt(jnp.abs(x0 - (x1 + 47.0)))
    )


def holder_table(x):  # test_functions.h:184-201
    x0, x1 = x[0], x[1]
    return -jnp.abs(
        jnp.sin(x0) * jnp.cos(x1) * jnp.exp(jnp.abs(1.0 - jnp.sqrt(x0**2 + x1**2) / PI))
    )


def mccormick(x):  # test_functions.h:203-211
    x0, x1 = x[0], x[1]
    return jnp.sin(x0 + x1) + (x0 - x1) ** 2 - 1.5 * x0 + 2.5 * x1 + 1.0


def schaffer_n2(x):  # test_functions.h:213-221
    x0, x1 = x[0], x[1]
    return 0.5 + (jnp.sin(x0**2 - x1**2) ** 2 - 0.5) / (1.0 + 0.001 * (x0**2 + x1**2)) ** 2


def schaffer_n4(x):  # test_functions.h:223-242
    x0, x1 = x[0], x[1]
    return (
        0.5
        + (jnp.cos(jnp.sin(jnp.abs(x0**2 - x1**2))) ** 2 - 0.5)
        / (1.0 + 0.001 * (x0**2 + x1**2)) ** 2
    )


def styblinski_tang(x):  # test_functions.h:244-255
    return jnp.sum(x**4 - 16.0 * x**2 + 5.0 * x) / 2.0


_SHEKEL_A = (
    (4.0, 4.0, 4.0, 4.0),
    (1.0, 1.0, 1.0, 1.0),
    (8.0, 8.0, 8.0, 8.0),
    (6.0, 6.0, 6.0, 6.0),
    (3.0, 7.0, 3.0, 7.0),
    (2.0, 9.0, 2.0, 9.0),
    (5.0, 5.0, 3.0, 3.0),
    (8.0, 1.0, 8.0, 1.0),
    (6.0, 2.0, 6.0, 2.0),
    (7.0, 3.6, 7.0, 3.2),
)
_SHEKEL_C = (0.1, 0.2, 0.2, 0.4, 0.4, 0.6, 0.3, 0.7, 0.5, 0.5)


def shekel(x):  # test_functions.h:257-277 (4-D, 10 foci)
    a = jnp.asarray(_SHEKEL_A, dtype=x.dtype)
    c = jnp.asarray(_SHEKEL_C, dtype=x.dtype)
    inner = jnp.sum((x[None, :] - a) ** 2, axis=-1)
    return -jnp.sum(1.0 / (inner + c))


def booth(x):  # test_functions.h:279-286
    x0, x1 = x[0], x[1]
    return (x0 + 2.0 * x1 - 7.0) ** 2 + (2.0 * x0 + x1 - 5.0) ** 2


def bukin_n6(x):  # test_functions.h:288-296
    x0, x1 = x[0], x[1]
    return 100.0 * jnp.sqrt(jnp.abs(x1 - 0.01 * x0**2)) + 0.01 * jnp.abs(x0 + 10.0)


def matyas(x):  # test_functions.h:298-305
    x0, x1 = x[0], x[1]
    return 0.26 * (x0**2 + x1**2) - 0.48 * x0 * x1


def levi_n13(x):  # test_functions.h:307-318
    x0, x1 = x[0], x[1]
    return (
        jnp.sin(3.0 * PI * x0) ** 2
        + (x0 - 1.0) ** 2 * (1.0 + jnp.sin(3.0 * PI * x1) ** 2)
        + (x1 - 1.0) ** 2 * (1.0 + jnp.sin(2.0 * PI * x1) ** 2)
    )


PROBLEMS: Dict[str, Problem] = {
    p.name: p
    for p in [
        Problem("sphere", sphere, 2, ((0.0, 0.0),), 0.0, (-5.12, -5.12), (5.12, 5.12)),
        Problem("rosenbrock", rosenbrock, 2, ((1.0, 1.0),), 0.0, (-5.0, -5.0), (10.0, 10.0)),
        Problem("rastrigin", rastrigin, 2, ((0.0, 0.0),), 0.0, (-5.12, -5.12), (5.12, 5.12)),
        Problem("ackley", ackley, 2, ((0.0, 0.0),), 0.0, (-5.0, -5.0), (5.0, 5.0)),
        Problem("beale", beale, 2, ((3.0, 0.5),), 0.0, (-4.5, -4.5), (4.5, 4.5)),
        Problem("goldstein_price", goldstein_price, 2, ((0.0, -1.0),), 3.0, (-2.0, -2.0), (2.0, 2.0)),
        Problem(
            "himmelblau",
            himmelblau,
            2,
            (
                (3.0, 2.0),
                (-2.805118, 3.131312),
                (-3.779310, -3.283186),
                (3.584428, -1.848126),
            ),
            0.0,
            (-5.0, -5.0),
            (5.0, 5.0),
        ),
        Problem("three_hump_camel", three_hump_camel, 2, ((0.0, 0.0),), 0.0, (-5.0, -5.0), (5.0, 5.0)),
        Problem(
            "cross_in_tray",
            cross_in_tray,
            2,
            (
                (1.34941, -1.34941),
                (1.34941, 1.34941),
                (-1.34941, 1.34941),
                (-1.34941, -1.34941),
            ),
            -2.06261,
            (-10.0, -10.0),
            (10.0, 10.0),
        ),
        Problem("eggholder", eggholder, 2, ((512.0, 404.2319),), -959.6407, (-512.0, -512.0), (512.0, 512.0)),
        Problem(
            "holder_table",
            holder_table,
            2,
            (
                (8.05502, 9.66459),
                (-8.05502, 9.66459),
                (8.05502, -9.66459),
                (-8.05502, -9.66459),
            ),
            -19.2085,
            (-10.0, -10.0),
            (10.0, 10.0),
        ),
        Problem("mccormick", mccormick, 2, ((-0.54719, -1.54719),), -1.9133, (-1.5, -3.0), (4.0, 4.0)),
        Problem("schaffer_n2", schaffer_n2, 2, ((0.0, 0.0),), 0.0, (-100.0, -100.0), (100.0, 100.0)),
        Problem(
            "schaffer_n4",
            schaffer_n4,
            2,
            ((0.0, 1.25313), (0.0, -1.25313), (1.25313, 0.0), (-1.25313, 0.0)),
            0.292579,
            (-100.0, -100.0),
            (100.0, 100.0),
        ),
        Problem(
            "styblinski_tang",
            styblinski_tang,
            2,
            ((-2.903534, -2.903534),),
            -78.33233,
            (-5.0, -5.0),
            (5.0, 5.0),
        ),
        Problem(
            "shekel",
            shekel,
            4,
            ((4.0, 4.0, 4.0, 4.0),),
            -10.5364,
            (0.0, 0.0, 0.0, 0.0),
            (10.0, 10.0, 10.0, 10.0),
        ),
        Problem("booth", booth, 2, ((1.0, 3.0),), 0.0, (-10.0, -10.0), (10.0, 10.0)),
        Problem("bukin_n6", bukin_n6, 2, ((-10.0, 1.0),), 0.0, (-15.0, -5.0), (-5.0, 3.0)),
        Problem("matyas", matyas, 2, ((0.0, 0.0),), 0.0, (-10.0, -10.0), (10.0, 10.0)),
        Problem("levi_n13", levi_n13, 2, ((1.0, 1.0),), 0.0, (-10.0, -10.0), (10.0, 10.0)),
    ]
}

# the 15 problems the reference's test runner enables (test_functions.h:486-524;
# Himmelblau/CrossInTray/Eggholder/HolderTable/SchafferN4 are commented out there)
REFERENCE_SUITE = [
    "sphere",
    "rosenbrock",
    "rastrigin",
    "ackley",
    "beale",
    "goldstein_price",
    "three_hump_camel",
    "mccormick",
    "schaffer_n2",
    "styblinski_tang",
    "shekel",
    "booth",
    "bukin_n6",
    "matyas",
    "levi_n13",
]


def get(name: str) -> Problem:
    return PROBLEMS[name]
