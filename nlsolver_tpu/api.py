"""Top-level user API.

``minimize(fn, x0, method=..., ...)`` / ``maximize(...)`` dispatch to the
solver modules; each solver also exposes a functional ``init``/``step`` pair
for advanced composition (custom drivers, sharded populations).

A reference user writes (README.md:77-110):

    auto de = DE<...>(problem, gen); de.minimize(x);

here:

    result = nlsolver_tpu.minimize(problem, x0, method="de", key=key)

The fleet engines are reachable through the same entry point via the
``layout`` switch:

    * ``layout="single"`` (default) — one problem instance;
    * ``layout="batched"`` — ``x0`` is ``[B, n]``; DE/PSO/SANN use the
      lane-axis engines (``de_batched`` / ``pso_batched`` /
      ``sann_batched``), every other method is ``vmap``-ped;
    * ``layout="fleet"`` — batch-minor ``[n, B]`` lane fleets
      (``method="bfgs"`` -> ``solvers.bfgs_fleet``);
    * ``layout="sharded"`` — engines over a device ``mesh``:
      ``de``/``pso`` shard the POPULATION (``parallel.*_sharded``),
      ``cmaes``/``bfgs`` shard the fleet LANE axis
      (``parallel.cmaes_sharded`` / ``fleet_sharded``),
      ``pso_batched``/``sann`` shard the INSTANCE batch of the lane-axis
      fleet engines (``fleet_sharded``, x0=[B, n]), ``lbfgs`` shards
      the DIMENSION axis (``parallel.lbfgs_sharded``, shard-local
      objective contract);
    * ``layout="islands"`` — island-model DE with ring migration over
      ``mesh`` (``method="de"`` -> ``parallel.de_island``).

``minimize(..., restarts=k)`` (layout="single") is the multistart
meta-driver: the user's x0 plus k-1 keyed random starts (uniform inside
``bounds`` when given, else ``x0 + U(-restart_spread, restart_spread)``,
default spread 10) run as one vmapped program and reduce to the best final
value, with counters summed over every start (the honest total budget).
``restart_sampler="halton"`` places the extra starts on the reference's
own low-discrepancy Halton sequence (nlsolver::rng::halton's radical
inverse) instead of iid uniform — stratified coverage at small k.
Multimodal problems the reference's single trajectory cannot solve
(Shekel, Bukin N6 — reference_test_matrix.tsv) fall to this at ~one
solve's wall-clock, because the extra starts ride otherwise-idle lanes.

Root finding (the reference's ``nlsolver::rootfinder`` free functions,
nlsolver.h:3923-4319) is ``root(fn, lower, upper, method=...)``; nonlinear
least squares is ``fit`` / ``fit_batched`` / ``curve_fit``
(re-exported from ``solvers.nlls``) plus ``fit_fleet`` — the batch-minor
lane fleet with selectable ``solve`` backend (batch-minor Cholesky or
wavefront QR; solvers/nlls_fleet.py).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .core import Bounds, SolverResult, signed
from .solvers.nlls import NLLSConfig, curve_fit, fit, fit_batched  # noqa: F401
from .solvers.nlls_fleet import NLLSFleetConfig, fit_fleet  # noqa: F401


def fit_fleet_sharded(residual_fn, X0, config=None, mesh=None, data=None):
    """``fit_fleet`` with the lane axis sharded over every device of
    ``mesh`` (parallel/fleet_sharded.py) — the mesh route for the
    batch-minor NLLS fleet (lane-parallel, zero collectives)."""
    from .parallel import fleet_sharded

    return fleet_sharded.fit_fleet_sharded(
        residual_fn, X0, config, mesh, data=data
    )


def fit_sharded(residual_fn, x0s, config=None, mesh=None, data=None):
    """``fit_batched`` with the fit batch sharded over the mesh dp axis
    (parallel/nlls_sharded.py) — the API-level route to the dp-sharded
    NLLS engine (same friendly surface as the other mesh engines)."""
    if mesh is None:
        raise ValueError("fit_sharded requires a mesh= argument")
    from .parallel import nlls_sharded

    cfg = config if config is not None else NLLSConfig()
    return nlls_sharded.fit_sharded(residual_fn, x0s, cfg, mesh, data=data)

_METHODS = {}
_LAYOUTS = ("single", "batched", "fleet", "sharded", "islands")


def _register():
    import importlib

    for name in (
        "nelder_mead",
        "de",
        "de_batched",
        "pso",
        "pso_batched",
        "sann",
        "sann_batched",
        "nmpso",
        "gd",
        "cgd",
        "bfgs",
        "bfgs_fleet",
        "lm",
        "nlls",
        "brent",
        "cmaes",
        "cmaes_fleet",
        "lbfgs",
        "lbfgsb",
        "coordinate",
    ):
        try:
            _METHODS[name] = importlib.import_module(f".solvers.{name}", __package__)
        except ImportError:
            pass


def methods():
    if not _METHODS:
        _register()
    return sorted(_METHODS)


def _resolve(method: str):
    if not _METHODS:
        _register()
    try:
        return _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; available methods: "
            f"{', '.join(sorted(_METHODS))}"
        ) from None


def _halton_unit(k: int, n: int):
    """Static [k, n] Halton points in (0, 1)^n — the reference's own
    low-discrepancy generator (nlsolver::rng::halton, prime-base radical
    inverse) used for START placement: stratified coverage beats iid
    uniform at small k (no clustered/void regions), and the points are
    deterministic — multistart results become key-independent in the
    start positions (only solver-internal randomness keeps the key)."""
    import numpy as np

    primes = []
    c = 2
    while len(primes) < n:
        if all(c % p for p in primes):
            primes.append(c)
        c += 1

    def radical_inverse(i, base):
        f, r = 1.0, 0.0
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        return r

    return np.asarray(
        [[radical_inverse(i + 1, p) for p in primes] for i in range(k)],
        dtype=np.float64,
    )


def _multistart(
    f, fn, x0, config, bounds, key, restarts, spread, sampler,
    _minimize, kwargs
) -> SolverResult:
    """Best-of-``restarts`` meta-driver: the user's x0 plus ``restarts - 1``
    keyed random starts run as ONE vmapped program, reduced by best final
    value.  The fleet answer to multimodal problems the reference's
    single trajectory cannot solve (reference_test_matrix.tsv: all of
    Shekel/BukinN6 fail there, /root/reference/test_functions.h:496-524) —
    extra starts ride otherwise idle lanes of one program.

    Starts are uniform inside ``bounds`` when given, else
    ``x0 + U(-spread, spread)^n``.  Counters in the returned result:
    ``function_calls``/``gradient_calls``/``hessian_calls``/``iterations``
    are SUMMED over all starts (the honest total budget — the semantics of
    ``solver_status.add``, nlsolver.h:2084-2091); ``x``/``f_value``/
    ``converged`` come from the winning start."""
    if restarts < 2:
        raise ValueError(f"restarts must be >= 2, got {restarts}")
    if sampler not in ("uniform", "halton"):
        raise ValueError(
            f"restart_sampler must be 'uniform' or 'halton', got {sampler!r}"
        )
    base = key if key is not None else jax.random.key(0)
    k_init, k_runs = jax.random.split(base)
    n = x0.shape[-1] if x0.ndim else 1
    shape = (restarts,) + x0.shape
    if sampler == "halton":
        # static stratified points (trace-time numpy; key-independent)
        unit = jnp.asarray(
            _halton_unit(restarts, n).reshape(shape), x0.dtype
        )
    else:
        unit = jax.random.uniform(k_init, shape, x0.dtype)
    if bounds is not None:
        lo = jnp.broadcast_to(jnp.asarray(bounds.lower, x0.dtype), x0.shape)
        hi = jnp.broadcast_to(jnp.asarray(bounds.upper, x0.dtype), x0.shape)
        starts = lo + (hi - lo) * unit
    else:
        starts = x0 + spread * (2.0 * unit - 1.0)
    starts = starts.at[0].set(x0)
    run_keys = jax.random.split(k_runs, restarts)

    def one(x0_i, key_i):
        if config is None:
            return f(fn, x0_i, bounds=bounds, key=key_i, **kwargs)
        return f(fn, x0_i, config, bounds=bounds, key=key_i, **kwargs)

    res = jax.vmap(one)(starts, run_keys)
    # a NaN-diverged start must never hijack the selection (jnp.argmin
    # returns the NaN index): mask NaNs to the worst possible value
    fv = res.f_value
    if _minimize:
        pick = jnp.argmin(jnp.where(jnp.isnan(fv), jnp.inf, fv))
    else:
        pick = jnp.argmax(jnp.where(jnp.isnan(fv), -jnp.inf, fv))
    best = jax.tree_util.tree_map(lambda a: a[pick], res)
    return best._replace(
        iterations=jnp.sum(res.iterations),
        function_calls=jnp.sum(res.function_calls),
        gradient_calls=jnp.sum(res.gradient_calls),
        hessian_calls=jnp.sum(res.hessian_calls),
    )


def _dispatch(
    fn,
    x0,
    method: str,
    config,
    bounds: Optional[Bounds],
    key: Optional[jax.Array],
    layout: str,
    mesh,
    keys: Optional[jax.Array],
    _minimize: bool,
    kwargs,
) -> SolverResult:
    mod = _resolve(method)
    x0 = jnp.asarray(x0)
    verb = "minimize" if _minimize else "maximize"
    restarts = kwargs.pop("restarts", 1)
    spread = kwargs.pop("restart_spread", 10.0)
    sampler = kwargs.pop("restart_sampler", "uniform")

    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {_LAYOUTS}")
    if restarts > 1 and layout != "single":
        raise ValueError(
            "restarts= is the single-instance multistart meta-driver; "
            f"layout={layout!r} is already multi-instance — run it with "
            "more lanes instead"
        )

    if layout == "single":
        f = getattr(mod, verb, None)
        if f is None:
            hint = {
                "de_batched": "use method='de' with layout='batched'",
                "pso_batched": "use method='pso' with layout='batched'",
                "sann_batched": "use method='sann' with layout='batched'",
                "bfgs_fleet": "use method='bfgs' with layout='fleet'",
                "nlls": "use nlsolver_tpu.fit / fit_batched / curve_fit",
            }.get(method, "see nlsolver_tpu.methods()")
            raise ValueError(
                f"method {method!r} has no single-instance {verb}; {hint}"
            )
        if restarts > 1:
            return _multistart(
                f, fn, x0, config, bounds, key, restarts, spread, sampler,
                _minimize, kwargs,
            )
        if config is None:
            return f(fn, x0, bounds=bounds, key=key, **kwargs)
        return f(fn, x0, config, bounds=bounds, key=key, **kwargs)

    if layout == "sharded" and method in ("lbfgs", "lbfgs_sharded"):
        # dimension-sharded L-BFGS: x0 is the single global [n] point; the
        # objective contract is SHARD-LOCAL (fn(x_local) -> partial value
        # whose psum over the mesh dim axis is the true objective), so it
        # bypasses the batched-layout plumbing below
        if mesh is None:
            raise ValueError("layout='sharded' requires a mesh= argument")
        if x0.ndim != 1:
            raise ValueError(
                f"dimension-sharded L-BFGS takes a single [n] start point, "
                f"got {x0.shape}"
            )
        grad_local = kwargs.pop("grad_local", None)
        if grad_local is None:
            raise ValueError(
                "method='lbfgs' with layout='sharded' shards the DIMENSION "
                "axis: pass fn as the shard-local objective contribution "
                "and grad_local= as d(global objective)/d(x_local) — see "
                "parallel/lbfgs_sharded.py"
            )
        if not _minimize:
            raise ValueError(
                "dimension-sharded L-BFGS only minimizes; negate the "
                "shard-local objective and gradient to maximize"
            )
        from .parallel import lbfgs_sharded

        return lbfgs_sharded.minimize_dim_sharded(
            fn, grad_local, x0, mesh, **kwargs
        )

    if x0.ndim != 2:
        raise ValueError(f"layout={layout!r} expects a 2-D x0, got {x0.shape}")

    # one key policy for every multi-instance layout: an explicit keys=
    # wins; otherwise key= (or the default key(0)) is split per instance.
    # Never let lanes fall through to a solver-internal default key — that
    # silently runs every "independent" lane on an identical stream.
    # (Exception: the CMA-ES fleet layouts draw ONE fleet-global stream.)
    fleet_like = layout == "fleet" or (
        layout == "sharded"
        and method in ("cmaes", "cmaes_fleet", "bfgs", "bfgs_fleet")
    )
    if fleet_like and keys is not None:
        raise ValueError(
            "fleet layouts draw ONE fleet-global stream (or none, for the "
            "deterministic BFGS fleet); pass key=, not per-instance keys="
        )
    n_lanes = x0.shape[1] if layout == "fleet" else x0.shape[0]
    if keys is None and not fleet_like:
        keys = jax.random.split(
            key if key is not None else jax.random.key(0), n_lanes
        )

    if layout == "batched":
        if method in ("de", "de_batched"):
            if bounds is not None:
                raise ValueError(
                    "the lane-axis DE engine is unbounded; use method='de' "
                    "with layout='single' under jax.vmap for bounded batches"
                )
            de_batched = _METHODS["de_batched"]
            cfg = config if config is not None else _METHODS["de"].DEConfig()
            return de_batched.minimize_batched(
                fn, x0, cfg, keys=keys, _minimize=_minimize, **kwargs
            )
        if method in ("pso", "pso_batched"):
            from .solvers import pso_batched

            cfg = config if config is not None else _METHODS["pso"].PSOConfig()
            return pso_batched.minimize_batched(
                fn, x0, cfg, bounds, keys=keys, _minimize=_minimize, **kwargs
            )
        if method in ("sann", "sann_batched"):
            from .solvers import sann_batched

            cfg = config if config is not None else _METHODS["sann"].SANNConfig()
            return sann_batched.minimize_batched(
                fn, x0, cfg, bounds, keys=keys, _minimize=_minimize, **kwargs
            )
        if bounds is not None:
            kwargs = dict(kwargs, bounds=bounds)

        def one(x0_i, key_i):
            f = getattr(mod, verb)
            if config is None:
                return f(fn, x0_i, key=key_i, **kwargs)
            return f(fn, x0_i, config, key=key_i, **kwargs)

        return jax.vmap(one)(x0, keys)

    # every engine below minimizes; one shared sign wrapper handles
    # maximize (negated objective in, f_value flipped back out)
    fn = signed(fn, _minimize)
    unflip = (lambda r: r) if _minimize else (
        lambda r: r._replace(f_value=-r.f_value)
    )

    if layout == "fleet":
        if method in ("cmaes", "cmaes_fleet"):
            from .solvers import cmaes_fleet

            cfg = config if config is not None else cmaes_fleet.CMAESFleetConfig()
            return unflip(
                cmaes_fleet.minimize_fleet(fn, x0, cfg, bounds, key=key, **kwargs)
            )
        if method not in ("bfgs", "bfgs_fleet"):
            raise ValueError(
                f"layout='fleet' supports method='bfgs' (batch-minor lane "
                f"fleet) and method='cmaes' (lane-parallel CMA-ES "
                f"strategies), got {method!r}; other methods batch via "
                f"layout='batched'"
            )
        if bounds is not None:
            raise ValueError(
                "the BFGS fleet is unconstrained; use method='lbfgsb' "
                "for box constraints"
            )
        fleet = _METHODS["bfgs_fleet"]
        fn_cols = kwargs.pop("fn_cols", None)
        if fn_cols is None:
            # adapt a single-point objective to the [n, B] -> [B] column form
            # (fn is already sign-wrapped above)
            fn_cols = lambda X: jax.vmap(fn)(X.T)  # noqa: E731
        elif not _minimize:
            # an explicit fn_cols bypasses the signed() wrapper: negate it
            # here so maximize maximizes (review finding, round 4)
            user_cols = fn_cols
            fn_cols = lambda X: -user_cols(X)  # noqa: E731
        cfg = config if config is not None else fleet.BFGSFleetConfig()
        return unflip(fleet.minimize_fleet(fn_cols, x0, cfg, **kwargs))

    # sharded / islands: population-parallel engines over a device mesh
    if mesh is None:
        raise ValueError(f"layout={layout!r} requires a mesh= argument")

    if layout == "islands":
        if method != "de":
            raise ValueError(f"layout='islands' supports method='de', got {method!r}")
        from .parallel import de_island

        cfg = config if config is not None else _METHODS["de"].DEConfig()
        res = de_island.minimize_islands(fn, x0, cfg, mesh, keys=keys, **kwargs)
    else:  # sharded
        if method in ("bfgs", "bfgs_fleet"):
            # lane-sharded BFGS fleet (pure data parallelism over every
            # mesh device — parallel/fleet_sharded.py).  ``fn`` is already
            # sign-wrapped above, so maximize works for both the lifted
            # objective and an explicit fn_cols=.
            if bounds is not None:
                raise ValueError(
                    "the BFGS fleet is unconstrained; use method='lbfgsb' "
                    "for box constraints"
                )
            from .parallel import fleet_sharded
            from .solvers import bfgs_fleet as bff

            fn_cols = kwargs.pop("fn_cols", None)
            if fn_cols is None:
                fn_cols = bff.colwise(fn)
            elif not _minimize:
                user_cols = fn_cols
                fn_cols = lambda X: -user_cols(X)  # noqa: E731
            if kwargs:
                raise TypeError(
                    f"unexpected arguments for the sharded BFGS fleet: "
                    f"{sorted(kwargs)}"
                )
            cfg = config if config is not None else bff.BFGSFleetConfig()
            res = fleet_sharded.minimize_fleet_sharded(fn_cols, x0, cfg, mesh)
            return unflip(res)
        if method in ("cmaes", "cmaes_fleet"):
            from .parallel import cmaes_sharded
            from .solvers import cmaes_fleet

            cfg = config if config is not None else cmaes_fleet.CMAESFleetConfig()
            res = cmaes_sharded.minimize_fleet_sharded(
                fn, x0, cfg, mesh, bounds, key=key, **kwargs
            )
            return unflip(res)
        if method in ("pso_batched", "pso_fleet"):
            # lane-sharded PSO fleet (instance batch on the lane axis over
            # every device, solvers/pso_batched.py) — the alternative to
            # method='pso', which shards ONE swarm's POPULATION
            from .parallel import fleet_sharded

            cfg = config if config is not None else _METHODS["pso"].PSOConfig()
            res = fleet_sharded.minimize_pso_fleet_sharded(
                fn, x0, cfg, mesh, keys=keys, bounds=bounds, **kwargs
            )
            return unflip(res)
        if method in ("sann", "sann_batched", "sann_fleet"):
            from .parallel import fleet_sharded

            cfg = config if config is not None else _METHODS["sann"].SANNConfig()
            res = fleet_sharded.minimize_sann_fleet_sharded(
                fn, x0, cfg, mesh, keys=keys, **kwargs
            )
            return unflip(res)
        if method == "de":
            from .parallel import de_sharded as eng

            cfg = config if config is not None else _METHODS["de"].DEConfig()
        elif method == "pso":
            from .parallel import pso_sharded as eng

            cfg = config if config is not None else _METHODS["pso"].PSOConfig()
        else:
            raise ValueError(
                f"layout='sharded' supports method='de', 'pso' (population "
                f"sharding), 'pso_batched'/'sann' (lane-sharded instance "
                f"fleets, x0=[B, n]), 'cmaes'/'bfgs' (lane-sharded fleets, "
                f"x0=[n, B]) or 'lbfgs' (dimension-sharded, x0=[n] + "
                f"grad_local=), got {method!r}"
            )
        res = eng.minimize_sharded(fn, x0, cfg, mesh, keys=keys, **kwargs)
    return unflip(res)


def minimize(
    fn,
    x0,
    method: str = "nelder_mead",
    config=None,
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    layout: str = "single",
    mesh=None,
    keys: Optional[jax.Array] = None,
    **kwargs,
) -> SolverResult:
    return _dispatch(
        fn, x0, method, config, bounds, key, layout, mesh, keys, True, kwargs
    )


def maximize(
    fn,
    x0,
    method: str = "nelder_mead",
    config=None,
    bounds: Optional[Bounds] = None,
    *,
    key: Optional[jax.Array] = None,
    layout: str = "single",
    mesh=None,
    keys: Optional[jax.Array] = None,
    **kwargs,
) -> SolverResult:
    return _dispatch(
        fn, x0, method, config, bounds, key, layout, mesh, keys, False, kwargs
    )


_ROOT_METHODS = (
    "bisection",
    "false_position",
    "brent",
    "ridders",
    "tiruneh",
    "itp",
    "chandrupatla",
)


def root(fn, lower=None, upper=None, method: str = "brent", **kwargs):
    """Find a root of scalar ``fn`` (nlsolver::rootfinder, nlsolver.h:3923-4319).

    Bracketing methods take ``lower``/``upper``; ``tiruneh`` takes its
    3-point history via ``x_k=`` instead.  Returns a ``RootResult``.
    All finders vmap over batched brackets.
    """
    from .solvers import rootfind

    if method not in _ROOT_METHODS:
        raise ValueError(
            f"unknown root method {method!r}; available: {', '.join(_ROOT_METHODS)}"
        )
    finder = getattr(rootfind, method)
    if method == "tiruneh":
        if lower is not None or upper is not None:
            raise ValueError("tiruneh takes x_k=(a, b, c), not lower/upper")
        return finder(fn, **kwargs)
    return finder(fn, lower, upper, **kwargs)


def root_methods():
    return list(_ROOT_METHODS)
