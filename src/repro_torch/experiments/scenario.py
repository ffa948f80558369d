"""Declarative experiment specs (port of
``repro.experiments.scenario.Scenario``): every field of the reference's
spec, in its order, so ``spec_dict`` records the same keys, and its
registration-time checks, word for word.

A scenario runs on one of two backends.  ``backend="des"`` runs one
discrete-event ``Cluster`` per (clients, seed) unit, where every field
takes effect (``audit``, ``engine``, ``spare_nodes``, ``pipeline_depth``,
``batch``, ``lease``, the fault plan, ``collect``), as on the reference.
``backend="batch"`` (the port's default; the reference's is ``"des"``)
runs the whole grid as one batch on the card.  The discrete-event engines
take every knob: ``obs`` (tracing and timelines, ``repro_torch.obs``),
``failover`` and ``admission`` (``repro_torch.runtime.policy``) and
``engine="ref"`` (the seed stack)."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

from ..core.network import Topology, wan_topology
from ..core.pig import PigConfig
from ..core.workload import WorkloadConfig
from ..faults.plan import FaultPlan, validate_event

# Legacy failure schedule entries (all times are virtual seconds), folded
# into the scenario's FaultPlan: ("crash", node_id, t), ("recover",
# node_id, t), ("partition", a, b, t), ("heal", a, b, t)
FailureEvent = Tuple


@dataclass(frozen=True)
class Scenario:
    """One declarative experiment, as data."""

    name: str                                # "<family>/<config...>" path
    protocol: str                            # "paxos" | "pigpaxos" | "epaxos"
    n: int
    pig: Optional[PigConfig] = None
    workload: Optional[WorkloadConfig] = None
    # {"kind": "lan", "n": ..., ...} or
    # {"kind": "wan", "nodes_per_region": [...], "oneway_ms": [[...]]}
    topo: Optional[dict] = None
    failures: Tuple[FailureEvent, ...] = ()
    # declarative fault plan (crash/recover windows, gray nodes,
    # partitions, drops, membership change, storms on the DES; only
    # mask-expressible plans on the batch backend), merged with
    # ``failures`` by fault_plan()
    faults: Optional[FaultPlan] = None
    # run the linearizability auditor on every DES unit (batch units
    # carry consistency="model" instead)
    audit: bool = False
    clients: Tuple[int, ...] = (60,)         # offered-load grid (clients)
    # "max"   — per seed, keep the best throughput over the client grid
    # "curve" — report every grid point
    grid_mode: str = "max"
    seeds: Tuple[int, ...] = (2,)
    duration: float = 0.6
    warmup: float = 0.3
    engine: str = "exact"                    # "exact" | "fast" | "ref"
    # "batch" — the whole clients x seeds grid is one batch-backend run
    # (the port's default; the reference's is "des");
    # "des"   — one Cluster run per (clients, seed) unit (pool-parallel)
    backend: str = "batch"
    # marks scenarios whose model assumptions the batch backend satisfies:
    # the runner switches these to "batch" via backend_override
    batch_ok: bool = False
    leader_timeout: float = 50e-3
    # spare nodes for membership events (DES only)
    spare_nodes: int = 0
    # failover policy kwargs (runtime.FailoverPolicy; DES only)
    failover: Optional[dict] = None
    # leader-side batching kwargs ({"max_batch": m, "max_delay_ms": ms}):
    # max_batch maps to vectorsim's batch_m (the saturated-batch model, so
    # max_delay_ms is ignored and clients must divide by max_batch)
    batch: Optional[dict] = None
    # bound on uncommitted proposals in flight (DES only; 0 = unbounded)
    pipeline_depth: int = 0
    # leader-lease kwargs ({"duration_ms": d, "renew_ms": r, "drift_bound":
    # b, "lease_safety": True}), required for read_path="lease"; the batch
    # backend models an uncontested lease held for the whole run
    lease: Optional[dict] = None
    # admission-control kwargs (runtime.AdmissionPolicy, or
    # LatencyAdmissionPolicy when "slo_ms" is set; DES only)
    admission: Optional[dict] = None
    # observability kwargs (obs.ObsConfig): DES units get span tracing,
    # timeline sampling and an "obs" extras section; batch units get the
    # leader-backlog series only
    obs: Optional[dict] = None
    # extras: "per_node_msgs" | "timeline" | "flight" | "overload"
    collect: Tuple[str, ...] = ()
    # quick-mode overrides (None -> use the full-mode value / skip nothing)
    quick_clients: Optional[Tuple[int, ...]] = None
    quick_duration: Optional[float] = None
    quick_warmup: Optional[float] = None
    quick_seeds: Optional[Tuple[int, ...]] = None
    quick_skip: bool = False                 # drop entirely in quick mode

    def __post_init__(self):
        if self.backend not in ("des", "batch"):
            raise ValueError(f"unknown backend {self.backend!r}")
        for ev in self.failures:
            validate_event(tuple(ev))
        plan = self.fault_plan()
        if plan is not None:
            # membership events may target spares (ids n..n+spare_nodes-1)
            plan.validate_targets(self.n + self.spare_nodes, self.horizon)
        if self.spare_nodes and self.backend == "batch":
            raise ValueError(
                "batch backend does not support spare_nodes: membership "
                "change needs a time-varying replica set — use the DES")
        if self.failover is not None and self.backend == "batch":
            raise ValueError(
                "batch backend does not support failover policies — "
                "use the DES")
        if self.admission is not None and self.backend == "batch":
            raise ValueError(
                "batch backend does not support admission control — "
                "use the DES")
        if self.pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if self.pipeline_depth and self.backend == "batch":
            raise ValueError(
                "batch backend pipelines implicitly (Lindley-chain leader "
                "FIFO == unbounded depth); finite pipeline_depth needs the "
                "DES")
        if self.batch is not None:
            m = self.batch.get("max_batch", 1)
            if m < 1:
                raise ValueError("batch.max_batch must be >= 1")
            if self.backend == "batch":
                if self.protocol == "epaxos":
                    raise ValueError("batch-backend batching is group-kernel "
                                     "only — batched EPaxos runs are DES-"
                                     "authoritative")
                bad = [k for k in self.clients if k % m]
                if bad:
                    raise ValueError(
                        f"batch backend requires client counts divisible by "
                        f"max_batch={m}; offending grid points: {bad}")
        if (self.batch is not None or self.pipeline_depth) \
                and self.engine == "ref":
            raise ValueError("batching/pipelining is not supported by the "
                             "verbatim seed stack (engine='ref')")
        if self.obs is not None:
            if self.engine == "ref":
                raise ValueError("observability is not supported by the "
                                 "verbatim seed stack (engine='ref')")
            if self.backend == "batch" and self.protocol == "epaxos":
                raise ValueError("batch-backend observability is group-"
                                 "kernel only (single-leader backlog "
                                 "series) — traced EPaxos runs need the "
                                 "DES")
            # registration-time validation of the knob values themselves
            from ..obs import ObsConfig
            ObsConfig(**self.obs)
        rr = (self.workload.read_ratio
              if self.workload is not None else None)
        rpath = (self.workload.read_path
                 if self.workload is not None else "log")
        if rr is not None and rr > 0.0 and self.engine == "ref":
            raise ValueError(
                "read_ratio workloads are not supported by the verbatim "
                "seed stack (engine='ref'): the seed client has no read "
                "op kind — use engine='exact' or 'fast'")
        if self.lease is not None:
            # registration-time knob validation
            from ..core.paxos import LeaseConfig
            LeaseConfig(**self.lease)
            if self.protocol == "epaxos":
                raise ValueError(
                    "leases are leader-granted; epaxos is leaderless — "
                    "epaxos read scenarios use read_path='quorum'")
            if self.engine == "ref":
                raise ValueError("leases are not supported by the verbatim "
                                 "seed stack (engine='ref')")
        if rpath == "lease" and rr is not None and rr > 0.0 \
                and self.lease is None:
            raise ValueError(
                "read_path='lease' requires lease= (no granted lease, no "
                "local leader reads — set e.g. lease={'duration_ms': 200})")
        if self.backend == "batch" and rr is not None and rr > 0.0:
            if rpath == "quorum":
                raise ValueError(
                    "batch backend models log and leased leader reads "
                    "only; quorum reads (probe / rinse rounds) need the "
                    "DES")
            if rpath == "lease":
                if plan is not None:
                    raise ValueError(
                        "batch leased reads assume the lease is held for "
                        "the whole run — fault plans need the DES")
                if self.batch is not None \
                        and self.batch.get("max_batch", 1) > 1:
                    raise ValueError(
                        "batch leased reads with leader batching are "
                        "DES-authoritative (reads bypass the batch "
                        "buffer)")
        if self.backend == "batch":
            ok_collect = {"per_node_msgs"}
            if plan is not None:
                ok_collect.add("timeline")   # fault runs emit timelines
            bad = [c for c in self.collect if c not in ok_collect]
            if bad:
                raise ValueError(f"batch backend does not support "
                                 f"{bad} collection — use the DES")
            if plan is not None and not plan.mask_expressible(self.horizon):
                raise ValueError(
                    "batch backend supports only mask-expressible fault "
                    "plans (crash/recover windows + whole-run slow nodes) "
                    "— use the DES for this plan")
            if plan is not None and self.protocol == "epaxos":
                raise ValueError("batch EPaxos does not support faults")

    @property
    def family(self) -> str:
        return self.name.split("/", 1)[0]

    @property
    def horizon(self) -> float:
        """Virtual-time span fault plans are materialized over (the
        full-mode measure window plus the drain)."""
        return self.warmup + self.duration + 0.5

    def fault_plan(self) -> Optional[FaultPlan]:
        """The unified fault plan: ``faults`` merged with the legacy
        ``failures`` tuples.  None when the scenario is fault-free."""
        plan = self.faults
        if self.failures:
            plan = (plan or FaultPlan()) + FaultPlan(
                events=tuple(tuple(ev) for ev in self.failures))
        return plan if plan else None

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

    def units(self):
        """The independent work units: one DES run per (clients, seed)."""
        for k in self.clients:
            for s in self.seeds:
                yield (k, s)


def build_topology(spec: Optional[dict]) -> Optional[Topology]:
    """Materialize a declarative topology spec."""
    if spec is None:
        return None
    kind = spec.get("kind", "lan")
    if kind == "wan":
        return wan_topology(list(spec["nodes_per_region"]),
                            [list(r) for r in spec["oneway_ms"]])
    if kind == "lan":
        kw = {k: spec[k] for k in ("base_latency", "jitter") if k in spec}
        return Topology(n=spec["n"], **kw)
    raise ValueError(f"unknown topology kind {kind!r}")


def _jsonify(x):
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, bytes):
        return len(x)            # payload bytes: record the size only
    if isinstance(x, float) and math.isinf(x):
        return None              # open-ended fault windows: strict JSON
    return x
