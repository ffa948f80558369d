"""Declarative experiment specs, the batch-path subset of
``repro.experiments.scenario.Scenario``: the fields the batch runner
reads, plus ``resolve`` and ``spec_dict``.  The discrete-event engines
are not ported, so every scenario here runs on the batch backend."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

from ..core.network import Topology
from ..core.pig import PigConfig


@dataclass(frozen=True)
class Scenario:
    """One declarative batch-backend experiment, as data."""

    name: str                                # "<family>/<config...>" path
    protocol: str                            # "paxos" | "pigpaxos"
    n: int
    pig: Optional[PigConfig] = None
    workload: Optional[object] = None        # a WorkloadConfig-like object
    topo: Optional[dict] = None              # {"kind": "lan", "n": ..., ...}
    clients: Tuple[int, ...] = (60,)         # offered-load grid (client counts)
    # "max"   — per seed, keep the best throughput over the client grid
    # "curve" — report every grid point
    grid_mode: str = "max"
    seeds: Tuple[int, ...] = (2,)
    duration: float = 0.6
    warmup: float = 0.3
    backend: str = "batch"
    batch_ok: bool = False
    leader_timeout: float = 50e-3
    # leader-side batching kwargs ({"max_batch": m}); m > 1 is not ported
    batch: Optional[dict] = None
    # batch obs leader-backlog series; not ported
    obs: Optional[dict] = None
    collect: Tuple[str, ...] = ()            # extras: "per_node_msgs"
    # quick-mode overrides (None -> use the full-mode value / skip nothing)
    quick_clients: Optional[Tuple[int, ...]] = None
    quick_duration: Optional[float] = None
    quick_warmup: Optional[float] = None
    quick_seeds: Optional[Tuple[int, ...]] = None
    quick_skip: bool = False                 # drop entirely in quick mode

    def __post_init__(self):
        if self.backend != "batch":
            raise NotImplementedError(
                "repro_torch ports the batch backend only; the discrete-"
                "event engines (backend='des') stay in repro")
        bad = [c for c in self.collect if c != "per_node_msgs"]
        if bad:
            raise ValueError(f"batch backend does not support "
                             f"{bad} collection — use the DES")

    @property
    def family(self) -> str:
        return self.name.split("/", 1)[0]

    def resolve(self, quick: bool) -> "ResolvedScenario":
        if quick:
            return ResolvedScenario(
                scenario=self,
                clients=self.quick_clients or self.clients,
                seeds=self.quick_seeds or self.seeds,
                duration=self.quick_duration or self.duration,
                warmup=self.quick_warmup if self.quick_warmup is not None
                else self.warmup)
        return ResolvedScenario(scenario=self, clients=self.clients,
                                seeds=self.seeds, duration=self.duration,
                                warmup=self.warmup)

    def spec_dict(self) -> dict:
        """JSON-ready copy of the full spec (recorded in the artifact)."""
        return _jsonify(dataclasses.asdict(self))


@dataclass(frozen=True)
class ResolvedScenario:
    """A scenario with quick/full knobs applied — what the runner runs."""
    scenario: Scenario
    clients: Tuple[int, ...]
    seeds: Tuple[int, ...]
    duration: float
    warmup: float


def build_topology(spec: Optional[dict]) -> Optional[Topology]:
    """Materialize a declarative LAN topology spec."""
    if spec is None:
        return None
    kind = spec.get("kind", "lan")
    if kind == "lan":
        kw = {k: spec[k] for k in ("base_latency", "jitter") if k in spec}
        return Topology(n=spec["n"], **kw)
    if kind == "wan":
        raise NotImplementedError(
            "WAN topologies are not ported to repro_torch yet (ROADMAP "
            "queue 1, item 6, WAN region gathers)")
    raise ValueError(f"unknown topology kind {kind!r}")


def _jsonify(x):
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, float) and math.isinf(x):
        return None
    return x
