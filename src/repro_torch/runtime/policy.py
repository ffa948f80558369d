"""Failover and elasticity policies over the DES cluster.

This promotes the pod-level ideas in :mod:`repro_torch.runtime.elastic`
(HeartbeatMonitor liveness detection, ElasticController membership-driven
resharding) into policies that drive the *replication* cluster itself:

* :class:`FailoverPolicy` + :func:`attach_failover` — a virtual-time failure
  detector that watches cluster-wide commit progress and, when the committed
  count stalls past ``detect_timeout`` while the known leader is dead (or has
  lost leadership), nominates a successor to run phase-1.  This models an
  external orchestrator with a configurable detection budget, so failover
  sweeps can measure the unavailability window as a function of
  ``detect_timeout`` — independent of the protocol's own ``leader_timeout``
  retry machinery.
* :class:`AdmissionPolicy` + :func:`attach_admission` — replica-side
  admission control for the overload regime: queue-length backpressure
  (shed a request when the receiving replica's queued + uncommitted work
  exceeds a threshold) plus token-bucket shedding (cap the cluster-wide
  sustained admit rate).  Shed requests get an immediate ``ok=False``
  reply — the cheap bounce path — instead of a consensus slot, so admitted
  work keeps committing within latency bounds while offered load runs past
  saturation.
* :class:`LatencyAdmissionPolicy` + :func:`attach_latency_admission` —
  admission control driven by the *observed* commit-latency p99 EWMA (the
  quantity the SLO is written in) instead of queue length; a scheduler tick
  recomputes the gauge and a bang-bang breaker with hysteresis sheds while
  it exceeds the SLO.
* :class:`ElasticityPolicy` — sizing rules for PigPaxos under membership
  change: the relay-group count tracks sqrt(followers) as nodes come and go
  (§3.2's balance point between leader fan-out and relay depth).

Policies are plain data + one attach function; they touch the cluster only
through its public surface (``members``, ``leader_id``, ``nodes``,
``sched``), so they work on both DES engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..core.messages import ClientReply, ClientRequest
from ..core.pig import auto_group_count

_INF = float("inf")


@dataclass(frozen=True)
class FailoverPolicy:
    """External-detector failover: declare the leader failed after commit
    progress stalls for ``detect_timeout`` virtual seconds, then promote a
    successor.  ``successor`` picks who: ``"next"`` = the first live member
    after the failed leader's id (wrapping), ``"lowest"`` = the lowest live
    member id."""

    detect_timeout: float = 0.1
    check_interval: float = 0.02
    successor: str = "next"

    def __post_init__(self):
        if self.successor not in ("next", "lowest"):
            raise ValueError(f"unknown successor rule {self.successor!r}")
        if self.check_interval <= 0 or self.detect_timeout <= 0:
            raise ValueError("failover intervals must be positive")


def attach_failover(cluster, policy: FailoverPolicy,
                    stop_at: float = _INF) -> List[dict]:
    """Arm ``policy`` on ``cluster``; returns the (live) failover event list
    — one ``{"t", "from", "to"}`` dict per promotion, filled in as the run
    executes, so callers can record it in artifacts afterwards."""
    events: List[dict] = []
    state = {"count": -1, "progress_at": cluster.sched.now}

    def _total_committed() -> int:
        return sum(getattr(cluster.nodes[i], "committed_count", 0)
                   for i in cluster.members)

    def _live() -> List[int]:
        return [i for i in cluster.members
                if not cluster.nodes[i].crashed
                and not getattr(cluster.nodes[i], "joining", False)]

    def _pick(cur: Optional[int]) -> Optional[int]:
        live = [i for i in _live() if i != cur]
        if not live:
            return None
        if policy.successor == "lowest":
            return live[0]
        pivot = -1 if cur is None else cur
        return next((i for i in live if i > pivot), live[0])

    def _leader_ok() -> bool:
        lid = cluster.leader_id
        if lid is None or lid not in cluster.members:
            return False
        nd = cluster.nodes[lid]
        return not nd.crashed and nd.is_leader

    def _tick() -> None:
        now = cluster.sched.now
        if now >= stop_at:
            return
        total = _total_committed()
        if total != state["count"]:
            state["count"] = total
            state["progress_at"] = now
        elif (not _leader_ok()
              and now - state["progress_at"] >= policy.detect_timeout):
            succ = _pick(cluster.leader_id)
            if succ is not None:
                events.append({"t": now, "from": cluster.leader_id,
                               "to": succ})
                state["progress_at"] = now     # election gets one full budget
                cluster.nodes[succ].start_phase1()
        cluster.sched.after(policy.check_interval, _tick)

    cluster.sched.after(policy.check_interval, _tick)
    return events


@dataclass(frozen=True)
class AdmissionPolicy:
    """Replica-side admission control (the overload-study knob set).

    * ``max_queue`` — queue-length backpressure: a request is shed when the
      receiving replica's backlog (buffered batch commands + allocated but
      uncommitted slots, or unexecuted instances for EPaxos) is at or above
      this many commands.  ``0`` disables the queue check.
    * ``rate_hz`` / ``burst`` — token-bucket shedding: the cluster admits at
      most ``rate_hz`` sustained requests per virtual second with bursts of
      up to ``burst`` tokens.  ``rate_hz == 0`` disables the bucket.

    Shed requests are answered immediately with ``ok=False`` (the same
    bounce clients already handle for not-the-leader), so shedding costs
    one cheap reply instead of a consensus round."""

    max_queue: int = 256
    rate_hz: float = 0.0
    burst: float = 64.0

    def __post_init__(self):
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        if self.rate_hz < 0:
            raise ValueError("rate_hz must be >= 0")
        if self.rate_hz > 0 and self.burst < 1:
            raise ValueError("token bucket needs burst >= 1")
        if self.max_queue == 0 and self.rate_hz == 0:
            raise ValueError("AdmissionPolicy with every mechanism disabled")


def _backlog(nd) -> int:
    """Commands accepted but not yet committed/executed at one replica:
    leader batch buffers + (paxos family) allocated uncommitted slots, or
    (epaxos) committed-but-unexecuted instances."""
    q = len(getattr(nd, "_buf", ()))
    for b in getattr(nd, "_held", ()):
        q += len(b)
    ns = getattr(nd, "next_slot", None)
    if ns is not None:
        q += max(0, ns - 1 - nd.commit_index)
    else:
        q += len(getattr(nd, "_pending_exec", ()))
    return q


def attach_admission(cluster, policy: AdmissionPolicy,
                     stop_at: float = _INF) -> dict:
    """Arm ``policy`` on every node of ``cluster`` by wrapping the
    ``ClientRequest`` handler; returns live counters ``{"admitted",
    "shed_queue", "shed_rate"}`` that fill in as the run executes.

    The token bucket is shared cluster-wide (it caps the *admitted* rate,
    wherever requests land); the queue check is per receiving replica.
    After ``stop_at`` the wrapper passes requests straight through."""
    stats = {"admitted": 0, "shed_queue": 0, "shed_rate": 0}
    bucket = {"tokens": float(policy.burst), "last": cluster.sched.now}
    sched = cluster.sched

    def _admit_rate() -> bool:
        if policy.rate_hz <= 0:
            return True
        now = sched.now
        tok = min(policy.burst,
                  bucket["tokens"] + (now - bucket["last"]) * policy.rate_hz)
        bucket["last"] = now
        if tok < 1.0:
            bucket["tokens"] = tok
            return False
        bucket["tokens"] = tok - 1.0
        return True

    def _wrap(nd):
        orig = nd.on_ClientRequest

        def on_ClientRequest(msg):
            if sched.now >= stop_at:
                orig(msg)
                return
            if policy.max_queue and _backlog(nd) >= policy.max_queue:
                stats["shed_queue"] += 1
            elif not _admit_rate():
                stats["shed_rate"] += 1
            else:
                stats["admitted"] += 1
                orig(msg)
                return
            cmd = msg.cmd
            nd.send(msg.src, ClientReply(client_id=cmd.client_id,
                                         seq=cmd.seq, ok=False, value=None))

        nd.on_ClientRequest = on_ClientRequest
        # the fused engines dispatch through the cached table, not getattr
        nd._dispatch[ClientRequest] = on_ClientRequest

    for nd in cluster.nodes:
        _wrap(nd)
    return stats


@dataclass(frozen=True)
class LatencyAdmissionPolicy:
    """Admission control driven by *observed commit latency* instead of
    queue length (enabled by the obs layer).

    A self-rescheduling tick (``Scheduler.every``) recomputes a p99 EWMA
    over the client latencies completed since the previous tick; while the
    EWMA exceeds ``slo_ms`` every incoming request is shed with the cheap
    ok=False bounce (a bang-bang circuit breaker — the EWMA supplies the
    smoothing, ``resume_frac`` the hysteresis: admission resumes once the
    EWMA falls back below ``resume_frac * slo_ms``).

    Compared to :class:`AdmissionPolicy`'s queue threshold, this sheds on
    the quantity the SLO is actually written in — it reacts later (latency
    is a trailing indicator of queue growth) but needs no model of how
    much queue a given latency budget buys, so it is robust to cost-model
    and batching changes that re-scale the queue/latency relationship."""

    slo_ms: float = 50.0
    ewma_alpha: float = 0.3
    check_interval: float = 0.01
    resume_frac: float = 0.8

    def __post_init__(self):
        if self.slo_ms <= 0:
            raise ValueError("slo_ms must be > 0")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.check_interval <= 0:
            raise ValueError("check_interval must be > 0")
        if not (0.0 < self.resume_frac <= 1.0):
            raise ValueError("resume_frac must be in (0, 1]")


def attach_latency_admission(cluster, policy: LatencyAdmissionPolicy,
                             stop_at: float = _INF) -> dict:
    """Arm ``policy`` on every node of ``cluster``; returns live counters
    ``{"admitted", "shed_latency", "p99_ewma_ms", "shedding"}``.

    Latencies are read from ``cluster.clients`` lazily each tick (clients
    are created inside ``measure()``, after attach).  When the cluster runs
    with observability enabled, the tick also records ``adm_p99_ewma_ms``
    and ``adm_shedding`` timelines."""
    stats = {"admitted": 0, "shed_latency": 0,
             "p99_ewma_ms": 0.0, "shedding": False}
    seen: dict = {}        # client id -> latencies already consumed
    sched = cluster.sched

    def _tick() -> None:
        fresh = []
        for cl in cluster.clients:
            k = seen.get(cl.id, 0)
            lats = cl.latencies
            if len(lats) > k:
                fresh.extend(l for _, l in lats[k:])
                seen[cl.id] = len(lats)
        if fresh:
            fresh.sort()
            p99 = fresh[min(len(fresh) - 1, int(0.99 * len(fresh)))] * 1e3
            a = policy.ewma_alpha
            prev = stats["p99_ewma_ms"]
            stats["p99_ewma_ms"] = (p99 if prev == 0.0
                                    else a * p99 + (1.0 - a) * prev)
        e = stats["p99_ewma_ms"]
        if stats["shedding"]:
            if e < policy.resume_frac * policy.slo_ms:
                stats["shedding"] = False
        elif e > policy.slo_ms:
            stats["shedding"] = True
        obs = getattr(cluster.net, "obs", None)
        if obs is not None:
            obs.add("adm_p99_ewma_ms", sched.now, e)
            obs.add("adm_shedding", sched.now,
                    1.0 if stats["shedding"] else 0.0)

    sched.every(policy.check_interval, _tick, stop_at=stop_at)

    def _wrap(nd):
        orig = nd.on_ClientRequest

        def on_ClientRequest(msg):
            if sched.now >= stop_at or not stats["shedding"]:
                stats["admitted"] += 1
                orig(msg)
                return
            stats["shed_latency"] += 1
            cmd = msg.cmd
            nd.send(msg.src, ClientReply(client_id=cmd.client_id,
                                         seq=cmd.seq, ok=False, value=None))

        nd.on_ClientRequest = on_ClientRequest
        # the fused engines dispatch through the cached table, not getattr
        nd._dispatch[ClientRequest] = on_ClientRequest

    for nd in cluster.nodes:
        _wrap(nd)
    return stats


@dataclass(frozen=True)
class ElasticityPolicy:
    """Relay-group sizing under a changing membership: keep the PigPaxos
    group count at sqrt(followers) as nodes join and leave, re-deriving the
    partition from the membership in force (``PigConfig.auto_groups`` makes
    the comm layer apply this automatically on every reconfiguration)."""

    track_sqrt_groups: bool = True

    def groups_for(self, n_members: int) -> int:
        return auto_group_count(n_members)
