"""Declarative fault plans, lowered to the batch backend's masks (copied
from ``repro.faults.plan``).

A :class:`FaultPlan` is pure data: concrete timed events ``(kind, ...args,
t)``, periodic ``crash_recover`` cycles and seeded storms.
``materialize(horizon)`` expands it into one sorted event list, and
``to_masks(n, horizon)`` lowers the *mask-expressible* plans (crash /
recover windows plus whole-run ``slow`` extra latency) to the per-node
down-windows and slow vectors that ``core.vectorsim.build_config`` takes;
anything else raises ``ValueError`` with the reference's wording, so a
scenario validates batch eligibility when it is registered.

Only the batch path is copied.  The discrete-event engines are not
ported, so neither are their pieces: ``apply_plan`` (the DES compiler),
the partition, drop, membership and storm constructors, and storm
expansion (a plan with storms raises ``NotImplementedError`` when it is
materialized).  The ``storms`` field stays, so that a plan's
``dataclasses.asdict`` (recorded in a scenario's spec) keeps the
reference's keys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_INF = float("inf")

# concrete event forms (all times are virtual seconds):
#   ("crash", node, t)
#   ("recover", node, t)
#   ("partition", a, b, t) / ("heal", a, b, t)             symmetric
#   ("partition_oneway", a, b, t) / ("heal_oneway", a, b, t)  a -> b only
#   ("slow", node, t0, t1, extra_latency_s, latency_factor)
#   ("drop", node, t0, t1, drop_prob)
#   ("add_node", node, t) / ("remove_node", node, t)   membership change
#   ("replace_leader", node, t)                        planned handoff
EVENT_ARITY = {
    "crash": 3, "recover": 3,
    "partition": 4, "heal": 4,
    "partition_oneway": 4, "heal_oneway": 4,
    "slow": 6, "drop": 5,
    "add_node": 3, "remove_node": 3, "replace_leader": 3,
}

# membership-change kinds: DES only (the batch model's replica set is fixed)
_MEMBERSHIP_KINDS = ("add_node", "remove_node", "replace_leader")


def _event_time(ev: tuple) -> float:
    """The *start* time of a concrete event (window kinds carry t0 at [2])."""
    return float(ev[2] if ev[0] in ("slow", "drop") else ev[-1])


def validate_event(ev: tuple) -> None:
    if not ev or ev[0] not in EVENT_ARITY:
        raise ValueError(f"unknown fault event kind in {ev!r} "
                         f"(known: {sorted(EVENT_ARITY)})")
    if len(ev) != EVENT_ARITY[ev[0]]:
        raise ValueError(f"fault event {ev!r}: expected "
                         f"{EVENT_ARITY[ev[0]]} fields")


@dataclass(frozen=True)
class FaultPlan:
    """One declarative fault schedule (see the module docstring)."""

    events: Tuple[tuple, ...] = ()
    # ("crash_recover", node, period, downtime, t0, t1)
    periodic: Tuple[tuple, ...] = ()
    # seeded randomized storms (DES side; not expanded here)
    storms: Tuple[dict, ...] = ()

    def __post_init__(self):
        for ev in self.events:
            validate_event(tuple(ev))
        for p in self.periodic:
            if p[0] != "crash_recover" or len(p) != 6:
                raise ValueError(f"unknown periodic fault {p!r}")
        for s in self.storms:
            if s.get("kind", "crash") not in ("crash", "partition"):
                raise ValueError(f"unknown storm kind {s.get('kind')!r}")

    def __bool__(self) -> bool:
        return bool(self.events or self.periodic or self.storms)

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(events=self.events + other.events,
                         periodic=self.periodic + other.periodic,
                         storms=self.storms + other.storms)

    # ------------------------------------------------------------ expansion
    def materialize(self, horizon: float) -> List[tuple]:
        """Expand periodic entries into the sorted concrete event list for
        a run of ``horizon`` virtual seconds."""
        if self.storms:
            raise NotImplementedError(
                "fault storms are expanded by the discrete-event side of "
                "repro.faults, which repro_torch does not port")
        evs = [tuple(ev) for ev in self.events if _event_time(ev) < horizon]
        for (_, node, period, downtime, t0, t1) in self.periodic:
            t = float(t0)
            while t < min(t1, horizon):
                evs.append(("crash", node, t))
                evs.append(("recover", node, min(t + downtime, horizon)))
                t += period
        evs.sort(key=_event_time)
        self._check_degradation_overlap(evs)
        return evs

    @staticmethod
    def _check_degradation_overlap(evs: Sequence[tuple]) -> None:
        """One degradation state per node: overlapping slow/drop windows on
        the same node are refused."""
        wins: Dict[int, List[Tuple[float, float]]] = {}
        for ev in evs:
            if ev[0] in ("slow", "drop"):
                node, t0, t1 = ev[1], float(ev[2]), float(ev[3])
                for (a, b) in wins.get(node, ()):
                    if t0 < b and a < t1:
                        raise ValueError(
                            f"overlapping degradation windows on node {node}: "
                            f"[{a},{b}) and [{t0},{t1})")
                wins.setdefault(node, []).append((t0, t1))

    def validate_targets(self, n: int, horizon: float) -> None:
        """Every materialized event must target node ids < ``n``."""
        for ev in self.materialize(horizon):
            nodes = (ev[1], ev[2]) if ev[0] in (
                "partition", "heal", "partition_oneway", "heal_oneway") \
                else (ev[1],)
            for x in nodes:
                if not 0 <= int(x) < n:
                    raise ValueError(f"fault event {ev!r} targets node {x} "
                                     f"outside 0..{n - 1}")

    # ------------------------------------------------------------- batching
    def mask_expressible(self, horizon: float) -> bool:
        """True iff the batch backend can run this plan (see to_masks)."""
        try:
            self.to_masks(1 + self._max_node(horizon), horizon)
            return True
        except ValueError:
            return False

    def _max_node(self, horizon: float) -> int:
        nodes = [0]
        for ev in self.materialize(horizon):
            if ev[0] in ("partition", "heal", "partition_oneway",
                         "heal_oneway"):
                nodes.extend((int(ev[1]), int(ev[2])))
            else:           # single-node kinds (ev[2] may be a time, not a node)
                nodes.append(int(ev[1]))
        return max(nodes)

    def to_masks(self, n: int, horizon: float,
                 max_windows: int = 8) -> Dict[str, np.ndarray]:
        """Lower the plan to batch-backend masks.

        Returns ``{"down": (n, W, 2) float64 [lo, hi) down-windows padded
        with +inf, "slow": (n,) float64 extra one-way seconds}``.  Raises
        ``ValueError`` for anything the round-level model cannot express:
        partitions, drops, latency factors, membership change, or ``slow``
        windows that do not span the whole run.
        """
        windows: Dict[int, List[List[float]]] = {}
        open_at: Dict[int, float] = {}
        slow = np.zeros(n, dtype=np.float64)
        for ev in self.materialize(horizon):
            kind = ev[0]
            if kind == "crash":
                node = int(ev[1])
                if node in open_at:
                    raise ValueError(f"node {node} crashed twice without "
                                     "recovering — not mask-expressible")
                open_at[node] = float(ev[2])
            elif kind == "recover":
                node = int(ev[1])
                t0 = open_at.pop(node, None)
                if t0 is None:
                    raise ValueError(f"recover of node {node} without a "
                                     "preceding crash")
                windows.setdefault(node, []).append([t0, float(ev[2])])
            elif kind == "slow":
                node, t0, t1, extra, factor = (int(ev[1]), float(ev[2]),
                                               float(ev[3]), float(ev[4]),
                                               float(ev[5]))
                if factor != 1.0 or t0 > 0.0 or t1 < horizon:
                    raise ValueError(
                        "batch masks support only whole-run additive slow "
                        f"nodes (factor=1, window [0, horizon)); got {ev!r}")
                slow[node] += extra
            elif kind in _MEMBERSHIP_KINDS:
                raise ValueError(
                    f"fault kind {kind!r} is not mask-expressible: the batch "
                    "backend models a FIXED replica set with per-node "
                    "availability windows, and membership change needs a "
                    "time-varying replica set — use the DES "
                    "(engine='exact'/'fast')")
            elif kind in ("partition", "heal", "partition_oneway",
                          "heal_oneway"):
                raise ValueError(
                    f"fault kind {kind!r} is not mask-expressible: the batch "
                    "backend has per-node availability masks but no per-link "
                    "connectivity state, so partitions cannot be lowered — "
                    "use the DES (engine='exact'/'fast')")
            elif kind == "drop":
                raise ValueError(
                    "fault kind 'drop' is not mask-expressible: probabilistic "
                    "per-message loss needs per-message randomness the "
                    "round-level batch model does not simulate — use the DES "
                    "(engine='exact'/'fast')")
            else:
                raise ValueError(f"fault kind {kind!r} is not "
                                 "mask-expressible — use the DES")
        for node, t0 in open_at.items():          # crash with no recover
            windows.setdefault(node, []).append([t0, _INF])
        w = max([len(v) for v in windows.values()] + [1])
        if w > max_windows:
            raise ValueError(f"{w} down-windows on one node exceeds the "
                             f"mask budget ({max_windows})")
        down = np.full((n, w, 2), _INF, dtype=np.float64)
        for node, ws in windows.items():
            if node >= n:
                raise ValueError(f"fault targets node {node} >= n={n}")
            for i, (lo, hi) in enumerate(ws):
                down[node, i] = (lo, hi)
        return {"down": down, "slow": slow}


# ---------------------------------------------------------------- builders
def crash_window(node: int, t0: float, t1: Optional[float] = None) -> FaultPlan:
    """Crash ``node`` at ``t0``; recover at ``t1`` (None = never)."""
    evs = [("crash", node, float(t0))]
    if t1 is not None:
        evs.append(("recover", node, float(t1)))
    return FaultPlan(events=tuple(evs))


def slow_window(node: int, t0: float = 0.0, t1: float = _INF,
                extra_latency: float = 0.0, factor: float = 1.0) -> FaultPlan:
    """Gray/slow node: every hop touching ``node`` in [t0, t1) pays
    ``latency * factor + extra_latency``."""
    return FaultPlan(events=(("slow", node, float(t0), float(t1),
                              float(extra_latency), float(factor)),))


def jsonify_events(evs: Sequence[tuple]) -> List[list]:
    """Materialized events as JSON-clean lists (inf -> None)."""
    return [[None if isinstance(x, float) and math.isinf(x) else x
             for x in ev] for ev in evs]
