"""String-keyed solver registry (port of ``repro.core.registry``).

Same spec grammar as the reference: ``name`` or ``name:key=val,key=val``,
where a bare word in the tail is a boolean flag (``"ees25:adaptive"``), and
the same normal form (:func:`canonical_spec`), error messages and
:func:`select_solver` decision table.  The registered solvers are the
reference's: the Euclidean ones — ``ees25`` (``x``, ``use_kernels`` and its
legacy spelling ``use_kernel``), ``ees27``, ``reversible-heun``, the six
Butcher tableaux (``euler`` ... ``rk4``) and their ``mcf-*`` couplings
(``lam``, ``use_kernels``), ``ees25-butcher``, ``ees27-butcher``,
``milstein``, ``strat-milstein`` and ``srk`` — and, with
``kind="manifold"``, the geometric schemes of
:mod:`repro_torch.core.cfees`: ``cfees25`` (``x``), ``cfees27``,
``geo-em``, ``cg2`` and ``rkmk2``.  Any other name fails with the
reference's unknown-solver message listing them all.
"""
from __future__ import annotations

import ast
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

from . import tableaux
from .cfees import RKMK2, CrouchGrossman2, GeoEulerMaruyama, cfees25_solver, cfees27_solver
from .solvers import (ButcherSolver, MCFSolver, Milstein, ReversibleHeun, SRKAdditive,
                      ees25_solver, ees27_solver)

__all__ = ["register_solver", "get_solver", "list_solvers", "parse_solver_spec",
           "canonical_spec", "solver_kind", "select_solver"]


_REGISTRY: Dict[str, Tuple[Callable[..., Any], str]] = {}


def register_solver(name: str, factory: Optional[Callable[..., Any]] = None,
                    *, kind: str = "euclidean"):
    """Register ``factory`` under ``name`` (usable as a decorator); latest
    registration of a name wins."""
    key = _canon(name)

    def deco(f):
        _REGISTRY[key] = (f, kind)
        return f

    if factory is not None:
        return deco(factory)
    return deco


def list_solvers(kind: Optional[str] = None) -> Tuple[str, ...]:
    """Registered solver names, sorted (``kind`` filters by term kind)."""
    return tuple(sorted(
        n for n, (_, k) in _REGISTRY.items() if kind is None or k == kind
    ))


def _canon(name: str) -> str:
    return name.strip().lower().replace("_", "-")


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_solver_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """Split ``"name:k=v,k2=v2"`` into ``(name, kwargs)``; a bare identifier
    in the tail is a boolean flag."""
    name, _, tail = spec.partition(":")
    kwargs: Dict[str, Any] = {}
    if tail:
        for item in tail.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                if item.isidentifier():
                    kwargs[item] = True
                    continue
                raise ValueError(
                    f"malformed solver spec {spec!r}: expected key=value or a "
                    f"bare flag, got {item!r}"
                )
            k, _, v = item.partition("=")
            kwargs[k.strip()] = _parse_value(v.strip())
    return _canon(name), kwargs


def _lookup(name: str) -> Tuple[Callable[..., Any], str]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; registered: {', '.join(list_solvers())}"
        ) from None


def canonical_spec(spec: str) -> str:
    """Normal form of a spec string: canonical name, sorted repr'd kwargs.
    Raises ``KeyError`` for unregistered names."""
    name, kwargs = parse_solver_spec(spec)
    _lookup(name)
    if not kwargs:
        return name
    return name + ":" + ",".join(f"{k}={kwargs[k]!r}" for k in sorted(kwargs))


def solver_kind(spec: str) -> str:
    """The registered kind ("euclidean" | "manifold") of a spec's solver."""
    name, _ = parse_solver_spec(spec)
    return _lookup(name)[1]


def _check_spec_keys(name: str, factory: Callable[..., Any],
                     kwargs: Dict[str, Any]) -> None:
    """Reject unknown spec kwargs up front, naming the offending key."""
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):  # pragma: no cover — builtins/C factories
        return
    params = sig.parameters.values()
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return
    valid = {p.name for p in params
             if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           inspect.Parameter.KEYWORD_ONLY)}
    for key in kwargs:
        if key not in valid:
            raise ValueError(
                f"unknown option {key!r} for solver {name!r}; valid keys: "
                + (", ".join(sorted(valid) + ["adaptive"]))
            )


def get_solver(spec, **overrides):
    """Resolve a solver spec string (or pass a solver object through).

    ``overrides`` take precedence over kwargs parsed from the spec.  The
    ``adaptive`` flag is not passed to the factory; it marks the returned
    object (``solver.adaptive = True``).
    """
    if not isinstance(spec, str):
        if overrides:
            raise ValueError(
                "overrides only apply to spec strings; got an already-"
                f"constructed solver {spec!r} with overrides {overrides}"
            )
        return spec
    name, kwargs = parse_solver_spec(spec)
    factory, _ = _lookup(name)
    kwargs.update(overrides)
    adaptive = bool(kwargs.pop("adaptive", False))
    _check_spec_keys(name, factory, kwargs)
    solver = factory(**kwargs)
    if adaptive:
        try:
            solver.adaptive = True
        except AttributeError:
            raise ValueError(
                f"solver {name!r} does not support the adaptive flag"
            ) from None
    return solver


register_solver("ees25", ees25_solver)
register_solver("ees27", ees27_solver)
register_solver("reversible-heun",
                lambda use_kernels=False: ReversibleHeun(use_kernels=use_kernels))


def _butcher_factory(tab):
    return lambda use_kernels=False: ButcherSolver(tab, use_kernels=use_kernels)


def _mcf_factory(tab):
    return lambda lam=0.999, use_kernels=False: MCFSolver(
        tab, lam=lam, use_kernels=use_kernels)


for _tab in (tableaux.euler, tableaux.midpoint, tableaux.heun,
             tableaux.ralston3, tableaux.rk3, tableaux.rk4):
    register_solver(_tab.name, _butcher_factory(_tab))
    register_solver(f"mcf-{_tab.name}", _mcf_factory(_tab))


def _ees25_butcher(x: float = 0.1):
    return ButcherSolver(tableaux.ees25_tableau(x))


register_solver("ees25-butcher", _ees25_butcher)
register_solver("ees27-butcher", lambda: ButcherSolver(tableaux.ees27_tableau()))


def _milstein_factory(form):
    return lambda use_kernels=False: Milstein(form=form, use_kernels=use_kernels)


register_solver("milstein", _milstein_factory("ito"))
register_solver("strat-milstein", _milstein_factory("stratonovich"))
register_solver("srk", lambda noise="additive": SRKAdditive(noise=noise))


def select_solver(noise: str = "diagonal", stiffness: float = 0.0,
                  dt: Optional[float] = None) -> str:
    """Auto-select a registry spec from a request's noise and stiffness.

    By the stability margin ``z = |stiffness| * dt`` first: ``z > 2.8`` gives
    ``"ees27"`` (past EES(2,5)'s real-axis reach), ``z > 1.0`` gives
    ``"ees25"``; otherwise by noise: ``"srk:noise=additive"`` for additive
    noise, ``"milstein"`` for diagonal or scalar noise, ``"ees25"`` for the
    rest (none, general).  Returns a spec string (the engine resolves
    ``"auto"`` requests through it).
    """
    if noise not in ("none", "diagonal", "additive", "scalar", "general"):
        raise ValueError(
            f"unknown noise mode {noise!r} for select_solver; valid modes: "
            "'none', 'diagonal', 'additive', 'scalar', 'general'"
        )
    z = abs(float(stiffness)) * float(dt) if dt is not None else 0.0
    if z > 2.8:
        return "ees27"
    if z > 1.0:
        return "ees25"
    if noise == "additive":
        return "srk:noise=additive"
    if noise in ("diagonal", "scalar"):
        return "milstein"
    return "ees25"

register_solver("cfees25", cfees25_solver, kind="manifold")
register_solver("cfees27", cfees27_solver, kind="manifold")
register_solver("geo-em", lambda: GeoEulerMaruyama(), kind="manifold")
register_solver("cg2", lambda: CrouchGrossman2(), kind="manifold")
register_solver("rkmk2", lambda: RKMK2(), kind="manifold")
