"""String-keyed solver registry (port of ``repro.core.registry``).

Same spec grammar as the reference: ``name`` or ``name:key=val,key=val``,
where a bare word in the tail is a boolean flag (``"ees25:adaptive"``), and
the same normal form (:func:`canonical_spec`) and error messages.  Only the
ported solvers are registered — ``ees25`` (``x``, ``use_kernels`` and its
legacy spelling ``use_kernel``), ``ees27``, ``reversible-heun``, the six
Butcher tableaux (``euler`` ... ``rk4``) and their ``mcf-*`` couplings
(``lam``, ``use_kernels``), ``ees25-butcher`` and ``ees27-butcher`` — so any
other name fails with the reference's unknown-solver message listing them.
"""
from __future__ import annotations

import ast
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

from . import tableaux
from .solvers import ButcherSolver, MCFSolver, ReversibleHeun, ees25_solver, ees27_solver

__all__ = ["register_solver", "get_solver", "list_solvers", "parse_solver_spec",
           "canonical_spec", "solver_kind"]


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
