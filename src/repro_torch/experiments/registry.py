"""Scenario registry: name -> :class:`Scenario` (port of
``repro.experiments.registry``).  ``select`` implements the ``--filter``
semantics: comma-separated fnmatch globs, where a bare family name matches
the whole family."""
from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Dict, Iterable, List, Optional

from .scenario import Scenario

_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in _REGISTRY:
        raise ValueError(f"duplicate scenario name {scenario.name!r}")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    _ensure_catalog()
    if name not in _REGISTRY and name in _not_ported():
        raise KeyError(f"scenario {name!r} needs what repro_torch has not "
                       f"ported yet (ROADMAP item 13b)")
    return _REGISTRY[name]


def names() -> List[str]:
    _ensure_catalog()
    return list(_REGISTRY)


def families() -> List[str]:
    _ensure_catalog()
    seen: List[str] = []
    for s in _REGISTRY.values():
        if s.family not in seen:
            seen.append(s.family)
    return seen


def select(filter_expr: Optional[str] = None,
           families_subset: Optional[Iterable[str]] = None) -> List[Scenario]:
    """Scenarios matching a ``--filter`` expression, optionally restricted
    to a subset of families; no filter -> all of them, in registration
    order.  A pattern that matches nothing raises ``ValueError``."""
    _ensure_catalog()
    out = list(_REGISTRY.values())
    if families_subset is not None:
        fams = set(families_subset)
        out = [s for s in out if s.family in fams]
    if filter_expr:
        pats = [p.strip() for p in filter_expr.split(",") if p.strip()]
        matched = {p: [s for s in out
                       if fnmatchcase(s.name, p) or s.family == p]
                   for p in pats}
        dead = [p for p, ss in matched.items() if not ss]
        if dead:
            pending = [p for p in dead if any(
                fnmatchcase(n, p) or n.split("/", 1)[0] == p
                for n in _not_ported())]
            why = (f" ({', '.join(pending)} only names scenarios that need "
                   f"ROADMAP item 13b, not ported yet)" if pending else "")
            raise ValueError(f"--filter pattern(s) matched no scenario: "
                             f"{', '.join(dead)}{why}")
        keep = {x.name for ss in matched.values() for x in ss}
        out = [s for s in out if s.name in keep]
    return out


def _not_ported() -> tuple:
    from .catalog import NOT_PORTED
    return NOT_PORTED


def _ensure_catalog() -> None:
    """Late-import the catalog so any read of the registry sees it."""
    from . import catalog  # noqa: F401  (import side effect: registration)
