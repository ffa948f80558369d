"""Declarative fault plans.

A :class:`FaultPlan` is pure data describing *when* and *how* the cluster
misbehaves, independent of the engine that executes it:

* **timed events** — concrete ``(kind, ...args, t)`` tuples: ``crash`` /
  ``recover`` a node, ``partition`` / ``heal`` a link (symmetric), the
  ``_oneway`` variants (asymmetric), and windowed degradations ``slow``
  (extra one-way latency and/or a latency factor — the "gray node" model)
  and ``drop`` (probabilistic message loss at a node);
* **periodic events** — ``crash_recover`` cycles expanded over a horizon;
* **storms** — seeded randomized fault generators parameterized by rate,
  target set, mean downtime, and a concurrency cap (the liveness guard:
  a storm never downs more than ``max_concurrent`` targets at once).

``materialize(horizon)`` expands everything into one sorted concrete event
list — the single source of truth consumed by both compilers:

* ``apply_plan(cluster, plan)`` schedules the events as virtual-time
  callbacks on the DES scheduler (exact and fast engines);
* ``plan.to_masks(n, horizon)`` lowers *mask-expressible* plans (crash /
  recover windows plus whole-run ``slow`` extra latency) to per-node
  availability windows + slow vectors for the batch backend
  (``repro_torch.core.vectorsim``); anything else raises, so a scenario can
  validate batch eligibility at registration time.

Plans are frozen dataclasses of tuples: picklable, JSON-clean via
``dataclasses.asdict``, and composable with ``+``.

Copied from ``repro.faults.plan``; the port's tests hold it to the
reference's run, event for event.
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

# membership-change kinds: DES-only (the batch model's replica set is fixed)
_MEMBERSHIP_KINDS = ("add_node", "remove_node", "replace_leader")

# kinds the batch backend can express as masks (see to_masks)
_MASK_KINDS = ("crash", "recover", "slow")


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
    """One declarative fault schedule (see module docstring for the forms)."""

    events: Tuple[tuple, ...] = ()
    # ("crash_recover", node, period, downtime, t0, t1)
    periodic: Tuple[tuple, ...] = ()
    # {"kind": "crash"|"partition", "rate_hz", "t0", "t1", "mean_downtime",
    #  "targets": (ids...), "seed", "max_concurrent"}
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
        """Expand periodic entries and storms into the sorted concrete event
        list for a run of ``horizon`` virtual seconds.  Deterministic: storms
        draw from their own seeded generator, never the simulation RNG."""
        evs = [tuple(ev) for ev in self.events if _event_time(ev) < horizon]
        for (_, node, period, downtime, t0, t1) in self.periodic:
            t = float(t0)
            while t < min(t1, horizon):
                evs.append(("crash", node, t))
                evs.append(("recover", node, min(t + downtime, horizon)))
                t += period
        for s in self.storms:
            evs.extend(_expand_storm(s, horizon))
        evs.sort(key=_event_time)
        self._check_degradation_overlap(evs)
        return evs

    @staticmethod
    def _check_degradation_overlap(evs: Sequence[tuple]) -> None:
        """The Network holds ONE degradation state per node, so overlapping
        slow/drop windows on the same node would silently clobber each other
        — reject them loudly instead."""
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
        """Every materialized event must target node ids < ``n`` — the
        registry-time guard: a typo'd id fails at registration, not as an
        IndexError halfway through a suite run.  For plans with membership
        events, pass the TOTAL node count (members + spares): ``add_node``
        legitimately names a node outside the initial membership."""
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
        partitions, drops, latency factors, or ``slow`` windows that do not
        span the whole run (the "gray relay throughout" form is supported;
        transient gray windows need the DES).
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


def partition_window(a: int, b: int, t0: float, t1: Optional[float] = None,
                     oneway: bool = False) -> FaultPlan:
    """Cut the a<->b link (or only a->b with ``oneway``) at ``t0``, heal at
    ``t1`` (None = never)."""
    cut = "partition_oneway" if oneway else "partition"
    heal = "heal_oneway" if oneway else "heal"
    evs = [(cut, a, b, float(t0))]
    if t1 is not None:
        evs.append((heal, a, b, float(t1)))
    return FaultPlan(events=tuple(evs))


def slow_window(node: int, t0: float = 0.0, t1: float = _INF,
                extra_latency: float = 0.0, factor: float = 1.0) -> FaultPlan:
    """Gray/slow node: every hop touching ``node`` in [t0, t1) pays
    ``latency * factor + extra_latency``."""
    return FaultPlan(events=(("slow", node, float(t0), float(t1),
                              float(extra_latency), float(factor)),))


def drop_window(node: int, t0: float, t1: float, prob: float) -> FaultPlan:
    """Gray/lossy node: hops touching ``node`` in [t0, t1) drop w.p. ``prob``."""
    return FaultPlan(events=(("drop", node, float(t0), float(t1),
                              float(prob)),))


def add_node(node: int, t: float) -> FaultPlan:
    """Join spare ``node`` to the cluster at ``t``: the node catches up from
    a leader snapshot + log suffix, then the leader commits a single-server
    ``add_node`` reconfiguration through the normal log."""
    return FaultPlan(events=(("add_node", int(node), float(t)),))


def remove_node(node: int, t: float) -> FaultPlan:
    """Remove ``node`` from the membership at ``t`` via a single-server
    reconfiguration command (the node may be the leader — leadership moves)."""
    return FaultPlan(events=(("remove_node", int(node), float(t)),))


def replace_leader(node: int, t: float) -> FaultPlan:
    """Planned leadership handoff: ``node`` runs phase-1 with a higher ballot
    at ``t``; the sitting leader steps down on seeing the higher promise."""
    return FaultPlan(events=(("replace_leader", int(node), float(t)),))


def rolling_restart(nodes: Sequence[int], t0: float, downtime: float = 0.06,
                    gap: float = 0.15) -> FaultPlan:
    """Restart every node in ``nodes`` in sequence: node i crashes at
    ``t0 + i*gap`` and recovers ``downtime`` later.  ``gap`` must exceed
    ``downtime`` so at most one node is ever down (the rolling-upgrade
    availability model)."""
    if gap <= downtime:
        raise ValueError(f"rolling_restart gap ({gap}) must exceed downtime "
                         f"({downtime}) — otherwise restarts overlap")
    evs: List[tuple] = []
    for i, node in enumerate(nodes):
        t = float(t0) + i * float(gap)
        evs.append(("crash", int(node), t))
        evs.append(("recover", int(node), t + float(downtime)))
    return FaultPlan(events=tuple(evs))


def periodic_crash(node: int, period: float, downtime: float,
                   t0: float = 0.0, t1: float = _INF) -> FaultPlan:
    """Crash ``node`` every ``period`` seconds for ``downtime`` each time."""
    return FaultPlan(periodic=(("crash_recover", node, float(period),
                                float(downtime), float(t0), float(t1)),))


def storm(targets: Sequence[int], rate_hz: float, t0: float, t1: float,
          mean_downtime: float = 0.15, seed: int = 0,
          kind: str = "crash", max_concurrent: int = 1) -> FaultPlan:
    """Randomized fault storm: Poisson fault arrivals at ``rate_hz`` over
    [t0, t1), each crashing (or partitioning a pair of) a random target for
    Exp(``mean_downtime``) seconds.  ``max_concurrent`` is the liveness
    guard — arrivals that would exceed it are skipped, so a storm can never
    down a quorum by accident.  Fully determined by ``seed``."""
    return FaultPlan(storms=({
        "kind": kind, "rate_hz": float(rate_hz), "t0": float(t0),
        "t1": float(t1), "mean_downtime": float(mean_downtime),
        "targets": tuple(int(x) for x in targets), "seed": int(seed),
        "max_concurrent": int(max_concurrent)},))


def _expand_storm(s: dict, horizon: float) -> List[tuple]:
    rng = np.random.default_rng(int(s.get("seed", 0)))
    kind = s.get("kind", "crash")
    rate = float(s["rate_hz"])
    targets = list(s["targets"])
    mean_dt = float(s.get("mean_downtime", 0.15))
    cap = int(s.get("max_concurrent", 1))
    end = min(float(s["t1"]), horizon)
    t = float(s["t0"])
    down_until: Dict[int, float] = {}
    evs: List[tuple] = []
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= end:
            break
        down_until = {x: r for x, r in down_until.items() if r > t}
        if len(down_until) >= cap:
            continue                       # liveness guard: skip this arrival
        up = [x for x in targets if x not in down_until]
        if kind == "partition":
            if len(up) < 2:
                continue
            a, b = rng.choice(up, size=2, replace=False)
            dur = max(0.02, float(rng.exponential(mean_dt)))
            evs.append(("partition", int(a), int(b), t))
            evs.append(("heal", int(a), int(b), min(t + dur, horizon)))
            down_until[int(a)] = t + dur   # count partitioned pair vs the cap
            down_until[int(b)] = t + dur
        else:
            if not up:
                continue
            node = int(rng.choice(up))
            dur = max(0.02, float(rng.exponential(mean_dt)))
            evs.append(("crash", node, t))
            evs.append(("recover", node, min(t + dur, horizon)))
            down_until[node] = t + dur
    return evs


# ------------------------------------------------------------- DES compiler
def apply_plan(cluster, plan: FaultPlan, horizon: float = _INF) -> List[tuple]:
    """Schedule every materialized event of ``plan`` on ``cluster``'s
    scheduler.  Works on both DES engines (exact and fast): crash/recover go
    through the node API (recovery re-election included, see
    ``PaxosNode.recover``), partitions and degradations through the
    ``Network`` failure API.  Returns the materialized events (the run's
    fault timeline, recorded in artifacts)."""
    sched, net = cluster.sched, cluster.net
    evs = plan.materialize(horizon)
    if evs:
        # fault mode: protocols with an opt-in recovery path switch it on
        # (EPaxos explicit-prepare instance recovery — off by default so
        # fault-free runs keep their golden traces and hot path)
        for nd in getattr(cluster, "nodes", ()):
            enable = getattr(nd, "enable_recovery", None)
            if enable is not None:
                enable()
    for ev in evs:
        kind = ev[0]
        if kind == "crash":
            cluster.crash_at(ev[1], ev[2])
        elif kind == "recover":
            cluster.recover_at(ev[1], ev[2])
        elif kind == "partition":
            cluster.partition_at(ev[1], ev[2], ev[3])
        elif kind == "heal":
            sched.at(ev[3], lambda a=ev[1], b=ev[2]: net.heal(a, b))
        elif kind == "partition_oneway":
            sched.at(ev[3], lambda a=ev[1], b=ev[2]: net.partition_oneway(a, b))
        elif kind == "heal_oneway":
            sched.at(ev[3], lambda a=ev[1], b=ev[2]: net.heal_oneway(a, b))
        elif kind == "slow":
            _, node, t0, t1, extra, factor = ev
            sched.at(t0, lambda n=node, e=extra, f=factor:
                     net.degrade(n, extra_latency=e, factor=f))
            if t1 < _INF:
                sched.at(t1, lambda n=node: net.restore(n))
        elif kind == "drop":
            _, node, t0, t1, prob = ev
            sched.at(t0, lambda n=node, p=prob: net.degrade(n, drop_prob=p))
            if t1 < _INF:
                sched.at(t1, lambda n=node: net.restore(n))
        elif kind == "add_node":
            sched.at(ev[2], lambda n=ev[1]: cluster.add_node(n))
        elif kind == "remove_node":
            sched.at(ev[2], lambda n=ev[1]: cluster.remove_node(n))
        elif kind == "replace_leader":
            sched.at(ev[2], lambda n=ev[1]: cluster.replace_leader(n))
    return evs


def jsonify_events(evs: Sequence[tuple]) -> List[list]:
    """Materialized events as JSON-clean lists (inf -> None)."""
    out = []
    for ev in evs:
        out.append([None if isinstance(x, float) and math.isinf(x) else x
                    for x in ev])
    return out
