"""Cluster harness: protocol deployments, closed-loop clients, failure
injection, and measurement (throughput / latency percentiles / message loads).

Copied from ``repro.core.cluster``; the workload shape it drives
(``WorkloadConfig``, ``zipf_cdf``) lives in ``core/workload.py``, where the
batch backend reads it too.  Engines ``"exact"``, ``"fast"`` and ``"ref"``
(the seed stack of ``core/refengine.py``), and ``obs=`` (``repro_torch.obs``),
as on the reference.

Mirrors the paper's testbed (§5.1): closed-loop (synchronous) clients, a
YCSB-like uniform workload over a 1000-key in-memory KV store, latency
measured at the client, throughput driven by the number of clients.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from .epaxos import EPaxosNode
from .events import Scheduler
from .messages import (ClientReply, ClientRequest, Command, CostModel,
                       ReadProbe, ReadReply)
from .network import Network, Topology
from .node import Node
from .paxos import PaxosNode
from .pig import PigConfig
from .workload import WorkloadConfig, zipf_cdf


class TaggedBytes(bytes):
    """A put payload carrying the writer's identity (client_id, seq) — the
    write tag the consistency auditor (repro_torch.faults.audit) matches against
    read returns.  Behaves exactly like ``bytes`` on the wire (same length,
    same costs); only history-recording runs allocate these."""

    def __new__(cls, data: bytes, tag: tuple):
        obj = super().__new__(cls, data)
        obj.tag = tag
        return obj


class Client:
    """Closed-loop client: one outstanding op; next op starts on reply."""

    def __init__(self, cluster: "Cluster", cid: int, pick_target: Callable[[], int],
                 workload: WorkloadConfig, stop_at: float):
        self.cluster = cluster
        self.id = cid
        self.net_id = cluster.topo.n + cid      # ids >= n bypass CPU queues
        self.pick_target = pick_target
        self.wl = workload
        self.stop_at = stop_at
        self.seq = 0
        self.sent_at = 0.0
        self.crashed = False
        self.latencies: List[tuple] = []   # (completion_time, latency)
        # op history for the consistency auditor: dicts of
        # {cid, seq, op, key, invoke, resp, ok, rtag, wtag} (audit.py)
        self.history: Optional[List[dict]] = \
            [] if cluster.record_history else None
        self._hist_cur: Optional[dict] = None
        self._last_cmd: Optional[Command] = None
        self.retries = 0                   # timeout re-sends (fault metric)
        # observability handles (None unless Cluster(obs=...)); the tracer
        # samples ops at issue time, the timelines gauge eats every latency
        # (getattr: the seed RefNetwork predates the obs surface)
        self._tracer = getattr(cluster.net, "tracer", None)
        self._obs = getattr(cluster.net, "obs", None)
        self._tctx = None                  # (seq, trace ctx) of a sampled op
        self.payload = bytes(workload.payload_bytes)
        self._key_cdf = (zipf_cdf(workload.n_keys, workload.zipf_theta)
                         if workload.key_dist == "zipfian" else None)
        if workload.payload_choices:
            self._payloads = [bytes(s) for s in workload.payload_choices]
            w = np.asarray(workload.payload_weights
                           or [1.0] * len(self._payloads), dtype=np.float64)
            self._payload_cdf = np.cumsum(w / w.sum())
            self._payload_cdf[-1] = 1.0   # cumsum can round below 1.0
        else:
            self._payloads = None
            self._payload_cdf = None
        # read-path state: per-op read/write latency split (read_ratio runs)
        # and the quorum-read probe state machine (read_path="quorum")
        self.rw_lat: tuple = ([], [])      # (read latencies, write latencies)
        self._probe: Optional[dict] = None
        self._rid = 0
        self._pig_pset: Optional[tuple] = None   # cached (leader, probe set)
        # fused-loop dispatch table (see network.Network._run)
        self._dispatch = {ClientReply: self.deliver,
                          ReadReply: self.on_ReadReply}
        cluster.net.register(self.net_id, self)

    def _bind_handler(self, cls):
        raise RuntimeError(f"Client has no handler for {cls.__name__}")

    def start(self) -> None:
        self._issue()

    # ------------------------------------------------------------ workload
    def _pick_key(self, rng) -> int:
        wl = self.wl
        if self._key_cdf is not None:
            return int(np.searchsorted(self._key_cdf, rng.random(), side="right"))
        if wl.key_dist == "conflict":
            if rng.random() < wl.conflict_rate:
                return 0
            return 1 + int(rng.integers(wl.n_keys - 1))
        return int(rng.integers(wl.n_keys))

    def _pick_payload(self, rng) -> bytes:
        if self._payloads is None:
            return self.payload
        return self._payloads[int(np.searchsorted(self._payload_cdf,
                                                  rng.random(), side="right"))]

    def _make_command(self, seq: int) -> Command:
        rng = self.cluster.sched.rng
        # read_ratio=None keeps the seed's exact draw semantics (golden
        # traces); when set, write_fraction is simply 1 - read_ratio
        wf = (self.wl.write_fraction if self.wl.read_ratio is None
              else 1.0 - self.wl.read_ratio)
        op = "put" if rng.random() < wf else "get"
        value = self._pick_payload(rng) if op == "put" else None
        if value is not None and self.history is not None:
            value = TaggedBytes(value, (self.id, seq))
        return Command(client_id=self.id, seq=seq, op=op,
                       key=self._pick_key(rng), value=value)

    # ------------------------------------------------------------ protocol
    def _issue(self) -> None:
        sched = self.cluster.sched
        if sched.now >= self.stop_at:
            return
        self.seq += 1
        cmd = self._make_command(self.seq)
        self._last_cmd = cmd
        self.sent_at = sched.now
        if self.history is not None:
            self._hist_cur = cur = {
                "cid": self.id, "seq": self.seq, "op": cmd.op,
                "key": cmd.key, "invoke": sched.now, "resp": None,
                "ok": False, "rtag": None,
                "wtag": getattr(cmd.value, "tag", None)}
            self.history.append(cur)
        if cmd.op == "get" and self.wl.read_path == "quorum":
            self._start_quorum_read(cmd)
            return
        req = ClientRequest(cmd=cmd)
        tr = self._tracer
        if tr is not None:
            ctx = tr.begin_op(self.net_id, sched.now)
            if ctx is not None:
                self._tctx = (self.seq, ctx)
                tr.attach(req, ctx)
            # a new op NEVER inherits ambient ctx: the closed-loop client
            # issues from inside the previous reply's handler, and without
            # this the next (unsampled) op's chain would keep growing the
            # finished trace through Network.send's ambient fallback
            tr.cur = None
        self.cluster.net.send(self.net_id, self.pick_target(), req)
        if self.wl.request_timeout:
            seq = self.seq
            sched.after(self.wl.request_timeout, lambda: self._resend(seq))

    def deliver(self, msg: ClientReply) -> None:
        if msg.seq != self.seq:
            return   # stale reply (e.g. from a retried request)
        sched = self.cluster.sched
        if not msg.ok:
            # not leader / not elected yet: back off and retry the op
            sched.after(5e-3, self._retry)
            return
        if self.history is not None:
            cur = self._hist_cur
            if cur is not None and cur["seq"] == msg.seq \
                    and cur["resp"] is None:
                cur["resp"] = sched.now
                cur["ok"] = True
                cur["rtag"] = getattr(msg.value, "tag", None)
                cur["path"] = msg.path
        lat = sched.now - self.sent_at
        self.latencies.append((sched.now, lat))
        if self.wl.read_ratio is not None:
            self.rw_lat[0 if self._last_cmd.op == "get" else 1].append(lat)
        tc = self._tctx
        if tc is not None and tc[0] == msg.seq:
            self._tracer.finish_op(tc[1], sched.now)
            self._tctx = None
        if self._obs is not None:
            self._obs.latency.note(lat)
        self._issue()

    # -------------------------------------------------------- quorum reads
    # PQR-style client-driven reads: probe a read quorum for per-key commit
    # frontiers, rinse (re-probe) while some member has ACCEPTED a write to
    # the key that nobody probed has APPLIED yet, then serve the max-applied
    # value.  Every acked write is accepted at a write quorum, and the probe
    # set intersects every write quorum (majority; PigPaxos: subgroup + the
    # leader), so the frontier check can never miss an acked write.
    RINSE_DELAY = 2e-3       # wait for the in-flight write to land
    MAX_RINSE = 8            # then fall back to a log read (wedged instance)
    PROBE_TIMEOUT = 10e-3    # re-probe a fresh set (crashed replica)

    def _quorum_probe_set(self) -> list:
        c = self.cluster
        if c.protocol == "pigpaxos":
            # geo-local relay subgroup + the leader.  The subgroup alone
            # need not intersect write quorums; the leader is in every one.
            leader = c.leader_id
            cached = self._pig_pset
            if cached is not None and cached[0] == leader:
                return cached[1]
            groups = c.nodes[leader].comm.groups_for(leader)
            topo = c.topo
            me = self.net_id
            best = min(groups, key=lambda g: sum(
                topo.base_between(me, m) for m in g) / max(len(g), 1))
            pset = sorted(set(best) | {leader})
            self._pig_pset = (leader, pset)
            return pset
        members = c.members
        rng = c.sched.rng
        m = len(members) // 2 + 1
        idx = rng.permutation(len(members))[:m]
        return [members[int(i)] for i in idx]

    def _start_quorum_read(self, cmd: Command) -> None:
        self._rid += 1
        rid = self._rid
        self._probe = {"rid": rid, "seq": cmd.seq, "key": cmd.key,
                       "replies": {}, "pset": self._quorum_probe_set(),
                       "rinse": 0}
        self._send_probes(rid)

    def _send_probes(self, rid: int) -> None:
        pr = self._probe
        probe = ReadProbe(key=pr["key"], rid=rid)
        net, me = self.cluster.net, self.net_id
        for nid in pr["pset"]:
            net.send(me, nid, probe)
        self.cluster.sched.after(self.PROBE_TIMEOUT,
                                 lambda: self._probe_timeout(rid))

    def _reprobe(self, rid: int, fresh_set: bool) -> None:
        pr = self._probe
        if pr is None or pr["rid"] != rid:
            return
        self._rid += 1
        pr["rid"] = self._rid
        pr["replies"] = {}
        if fresh_set:
            self._pig_pset = None
            pr["pset"] = self._quorum_probe_set()
        self._send_probes(pr["rid"])

    def _probe_timeout(self, rid: int) -> None:
        pr = self._probe
        if pr is None or pr["rid"] != rid:
            return
        if self.cluster.sched.now >= self.stop_at:
            self._probe = None
            return
        # a crashed/partitioned replica never replies: fresh set, fresh rid
        self._reprobe(rid, fresh_set=True)

    def on_ReadReply(self, msg: ReadReply) -> None:
        pr = self._probe
        if pr is None or msg.rid != pr["rid"]:
            return
        pr["replies"][msg.src] = msg
        if len(pr["replies"]) < len(pr["pset"]):
            return
        reps = list(pr["replies"].values())
        max_app = max(r.applied for r in reps)
        max_acc = max(r.accepted for r in reps)
        if max_acc > max_app:
            # read repair ("rinse"): a quorum member accepted a write to
            # this key that nobody probed has applied — wait it out
            if pr["rinse"] < self.MAX_RINSE:
                pr["rinse"] += 1
                rid = pr["rid"]
                self.cluster.sched.after(
                    self.RINSE_DELAY,
                    lambda: self._reprobe(rid, fresh_set=False))
                return
            # rinse budget exhausted (wedged write): log read settles it
            self._probe = None
            self._fallback_log_read()
            return
        best = max(reps, key=lambda r: r.applied)
        self._probe = None
        self._complete_quorum_read(best)

    def _fallback_log_read(self) -> None:
        self.cluster.net.send(self.net_id, self.pick_target(),
                              ClientRequest(cmd=self._last_cmd))
        if self.wl.request_timeout:
            seq = self.seq
            self.cluster.sched.after(self.wl.request_timeout,
                                     lambda: self._resend(seq))

    def _complete_quorum_read(self, best: ReadReply) -> None:
        sched = self.cluster.sched
        if self.history is not None:
            cur = self._hist_cur
            if cur is not None and cur["seq"] == self.seq \
                    and cur["resp"] is None:
                cur["resp"] = sched.now
                cur["ok"] = True
                cur["rtag"] = getattr(best.value, "tag", None)
                cur["path"] = "quorum"
        lat = sched.now - self.sent_at
        self.latencies.append((sched.now, lat))
        if self.wl.read_ratio is not None:
            self.rw_lat[0].append(lat)
        if self._obs is not None:
            self._obs.latency.note(lat)
        self._issue()

    def _retry(self) -> None:
        """Not-leader backoff path: re-send the SAME command.  Never
        regenerate under an in-flight seq — with crash-recover plans the
        original may already be proposed (and later committed via post-
        recovery re-arm), and the replicas' (client_id, seq) session dedup
        would conflate a regenerated command with it, acking the wrong
        operation's result."""
        if self.cluster.sched.now >= self.stop_at:
            return
        req = ClientRequest(cmd=self._last_cmd)
        tc = self._tctx
        if tc is not None and tc[0] == self.seq:
            self._tracer.attach(req, tc[1])   # the retry hops join the trace
        self.cluster.net.send(self.net_id, self.pick_target(), req)

    def _resend(self, seq: int) -> None:
        """Request-timeout path: re-send the SAME command (the replicas'
        at-most-once session dedup absorbs duplicates) until replied."""
        sched = self.cluster.sched
        if (seq != self.seq or self._last_cmd is None
                or self._last_cmd.seq != seq
                or (self._hist_cur is not None
                    and self._hist_cur["seq"] == seq
                    and self._hist_cur["resp"] is not None)
                or sched.now >= self.stop_at):
            return
        self.retries += 1
        self.cluster.net.send(self.net_id, self.pick_target(),
                              ClientRequest(cmd=self._last_cmd))
        sched.after(self.wl.request_timeout, lambda: self._resend(seq))


class OpenLoopClient(Client):
    """Open-loop client: ops arrive as a Poisson process at ``rate_hz``
    independent of replies, so offered load does not collapse when the
    system slows down — the saturation-probe regime the closed-loop paper
    setup cannot express.  At most ``max_outstanding`` ops are in flight;
    arrivals beyond that are shed (standard open-loop overload guard)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.outstanding: Dict[int, tuple] = {}   # seq -> (sent_at, cmd, rec)
        self.shed = 0        # arrivals dropped at the client (cap reached)
        self.rejected = 0    # ops abandoned on ok=False (reject_action="drop")
        self._tctxs: Dict[int, tuple] = {}        # seq -> trace ctx (sampled)

    def start(self) -> None:
        self._arrival()

    def _rate_at(self, t: float) -> float:
        """Instantaneous arrival rate (Hz) — constant for "poisson",
        modulated for "bursty"/"diurnal" (see WorkloadConfig)."""
        wl = self.wl
        a = wl.arrival
        if a == "bursty":
            if (t % wl.burst_period) / wl.burst_period < wl.burst_on:
                return wl.rate_hz * wl.burst_factor
            off = (wl.rate_hz * max(0.0, 1.0 - wl.burst_factor * wl.burst_on)
                   / (1.0 - wl.burst_on))
            return max(off, 1e-9)
        if a == "diurnal":
            return wl.rate_hz * max(
                1e-9, 1.0 + wl.diurnal_amp
                * math.sin(2.0 * math.pi * t / wl.diurnal_period))
        return wl.rate_hz

    def _arrival(self) -> None:
        sched = self.cluster.sched
        if sched.now >= self.stop_at:
            return
        rng = sched.rng
        if len(self.outstanding) < self.wl.max_outstanding:
            self.seq += 1
            cmd = self._make_command(self.seq)
            rec = None
            if self.history is not None:
                rec = {"cid": self.id, "seq": self.seq, "op": cmd.op,
                       "key": cmd.key, "invoke": sched.now, "resp": None,
                       "ok": False, "rtag": None,
                       "wtag": getattr(cmd.value, "tag", None)}
                self.history.append(rec)
            self.outstanding[self.seq] = (sched.now, cmd, rec)
            req = ClientRequest(cmd=cmd)
            tr = self._tracer
            if tr is not None:
                ctx = tr.begin_op(self.net_id, sched.now)
                if ctx is not None:
                    self._tctxs[self.seq] = ctx
                    tr.attach(req, ctx)
            self.cluster.net.send(self.net_id, self.pick_target(), req)
            if self.wl.request_timeout:
                seq = self.seq
                sched.after(self.wl.request_timeout,
                            lambda: self._timeout_seq(seq))
        else:
            self.shed += 1
        sched.after(rng.exponential(1.0 / self._rate_at(sched.now)),
                    self._arrival)

    def deliver(self, msg: ClientReply) -> None:
        entry = self.outstanding.get(msg.seq)
        if entry is None:
            return   # stale duplicate
        sched = self.cluster.sched
        if not msg.ok:
            if self.wl.reject_action == "drop":
                del self.outstanding[msg.seq]
                self.rejected += 1
                ctx = self._tctxs.pop(msg.seq, None)
                if ctx is not None:
                    self._tracer.abort_op(ctx, sched.now)
                return
            seq = msg.seq
            sched.after(5e-3, lambda: self._retry_seq(seq))
            return
        del self.outstanding[msg.seq]
        rec = entry[2]
        if rec is not None:
            rec["resp"] = sched.now
            rec["ok"] = True
            rec["rtag"] = getattr(msg.value, "tag", None)
            rec["path"] = msg.path
        lat = sched.now - entry[0]
        self.latencies.append((sched.now, lat))
        if self.wl.read_ratio is not None:
            self.rw_lat[0 if entry[1].op == "get" else 1].append(lat)
        ctx = self._tctxs.pop(msg.seq, None)
        if ctx is not None:
            self._tracer.finish_op(ctx, sched.now)
        if self._obs is not None:
            self._obs.latency.note(lat)

    def _retry_seq(self, seq: int) -> None:
        entry = self.outstanding.get(seq)
        if entry is None:
            return
        if self.cluster.sched.now >= self.stop_at:
            del self.outstanding[seq]
            return
        self.cluster.net.send(self.net_id, self.pick_target(),
                              ClientRequest(cmd=entry[1]))

    def _timeout_seq(self, seq: int) -> None:
        entry = self.outstanding.get(seq)
        if entry is None or self.cluster.sched.now >= self.stop_at:
            return
        self.retries += 1
        self.cluster.net.send(self.net_id, self.pick_target(),
                              ClientRequest(cmd=entry[1]))
        self.cluster.sched.after(self.wl.request_timeout,
                                 lambda: self._timeout_seq(seq))


class Cluster:
    """A protocol deployment + clients on one scheduler."""

    def __init__(self, protocol: str, n: int, topo: Optional[Topology] = None,
                 pig: Optional[PigConfig] = None, seed: int = 0,
                 cost: Optional[CostModel] = None, leader_timeout: float = 50e-3,
                 quorums=None, engine: str = "exact",
                 record_history: bool = False, spare_nodes: int = 0,
                 batch=None, pipeline_depth: int = 0, obs=None, lease=None):
        """``engine`` selects the simulation engine:

        * ``"exact"`` (default) — fused slab engine, trace-identical to the
          seed implementation (golden-trace guarantee);
        * ``"fast"``  — flattened single-event-per-hop delivery; aggregate
          stats preserved, traces not bit-identical (big-N sweeps);
        * ``"ref"``   — the seed engine kept verbatim in refengine.py
          (golden-trace baseline and speedup benchmarks).

        ``record_history`` makes every client keep an invoke/response record
        per operation (with tagged put values) for the consistency auditor
        (``repro_torch.faults.audit``); off by default — the hot path is untouched.

        ``spare_nodes`` pre-provisions extra node objects (ids ``n`` ..
        ``n + spare_nodes - 1``) OUTSIDE the initial membership.  They sit
        inert (non-voting learners) until ``add_node`` joins them through
        the protocol's reconfiguration path.  DES engines only.

        ``batch`` (a ``core.paxos.BatchConfig``) enables leader-side
        request batching; ``pipeline_depth`` > 0 throttles the leader to
        that many uncommitted in-flight slots (0 = unbounded, the native
        behavior).  DES engines only — the verbatim seed stack has no
        batching surface.

        ``obs`` (a ``repro_torch.obs.ObsConfig``, a kwargs dict, or
        ``True``) enables the observability layer: per-op distributed
        tracing (``sample_rate``, event/RNG-neutral) and timeline metrics
        sampling (``metrics_dt``).  DES engines only — the seed stack has
        no hook surface.  Exposed afterwards as ``cluster.obs_tracer`` /
        ``cluster.obs_timelines``; ``Stats.timelines`` carries the
        exported series.
        """
        self.protocol = protocol
        self.n = n
        self.engine = engine
        self.record_history = record_history
        self.batch = batch
        self.pipeline_depth = pipeline_depth
        if spare_nodes and engine == "ref":
            raise ValueError("membership change is not supported by the "
                             "verbatim seed stack (engine='ref') — use "
                             "'exact' or 'fast'")
        if (batch is not None or pipeline_depth) and engine == "ref":
            raise ValueError("batching/pipelining is not supported by the "
                             "verbatim seed stack (engine='ref') — use "
                             "'exact' or 'fast'")
        if lease is not None:
            from .paxos import LeaseConfig
            if engine == "ref":
                raise ValueError("leader leases are not supported by the "
                                 "verbatim seed stack (engine='ref') — use "
                                 "'exact' or 'fast'")
            if protocol == "epaxos":
                raise ValueError("leader leases need a distinguished leader "
                                 "— EPaxos is leaderless; use "
                                 "read_path='quorum' for EPaxos reads")
            if isinstance(lease, dict):
                lease = LeaseConfig(**lease)
        self.lease = lease
        total = n + spare_nodes
        self.topo = topo or Topology(n=total)
        if self.topo.n < total:
            raise ValueError(f"topology has {self.topo.n} nodes but "
                             f"n + spare_nodes = {total}")
        if engine == "ref":
            # the verbatim seed stack: seed scheduler/network AND seed
            # protocol classes (golden-trace baseline, see refengine.py)
            from .refengine import (RefEPaxosNode, RefNetwork, RefPaxosNode,
                                    RefScheduler)
            self.sched = RefScheduler(seed=seed)
            self.net = RefNetwork(self.sched, self.topo, cost=cost)
            paxos_cls, epaxos_cls = RefPaxosNode, RefEPaxosNode
        elif engine in ("exact", "fast"):
            self.sched = Scheduler(seed=seed)
            self.net = Network(self.sched, self.topo, cost=cost,
                               fast_path=(engine == "fast"))
            paxos_cls, epaxos_cls = PaxosNode, EPaxosNode
        else:
            raise ValueError(f"unknown engine {engine!r}")
        self.obs_cfg = None
        self.obs_tracer = None
        self.obs_timelines = None
        if obs is not None and obs is not False:
            if engine == "ref":
                raise ValueError("observability is not supported by the "
                                 "verbatim seed stack (engine='ref') — use "
                                 "'exact' or 'fast'")
            from ..obs import ObsConfig, Timelines, Tracer
            cfg = ObsConfig.coerce(obs)
            self.obs_cfg = cfg
            self.obs_tracer = Tracer(cfg.sample_rate, cfg.max_spans)
            self.net.tracer = self.obs_tracer
            self.obs_timelines = Timelines(cfg.timeline_cap)
            self.net.obs = self.obs_timelines
        self.pig = pig
        self.leader_timeout = leader_timeout
        peers = list(range(n))
        self.nodes: List[Node] = []
        bkw = ({} if engine == "ref"
               else {"batch": batch, "pipeline_depth": pipeline_depth})
        # per-node drifting clocks (lease runs only): rate uniform in
        # [-b, +b], a small offset for realism (offsets cancel in all
        # elapsed-local lease comparisons).  A SEPARATE generator — the
        # shared sched.rng draw order is pinned by golden traces.
        if lease is not None:
            crng = np.random.default_rng(int(seed) + 0x10EA5E)
            b = lease.drift_bound
            clock = [(float(crng.uniform(-b, b)),
                      float(crng.uniform(0.0, 1e-3))) for _ in range(total)]
        else:
            clock = [(0.0, 0.0)] * total
        for i in range(total):
            if protocol == "epaxos":
                # the seed class has no recovery surface; the new engines
                # probe stuck instances after 2 leader timeouts (fault runs)
                ekw = ({} if engine == "ref"
                       else {"recovery_timeout": 2 * leader_timeout, **bkw})
                self.nodes.append(epaxos_cls(i, self.net, self.sched, peers,
                                             **ekw))
            else:
                pkw = dict(bkw)
                if engine != "ref":
                    pkw.update(lease=lease, clock_rate=clock[i][0],
                               clock_offset=clock[i][1])
                self.nodes.append(paxos_cls(i, self.net, self.sched, peers,
                                            pig=pig if protocol == "pigpaxos" else None,
                                            leader_timeout=leader_timeout,
                                            quorums=quorums, **pkw))
        # cluster-level membership view, fed by node callbacks as cfg
        # commands apply (client routing + the auditor's durable set)
        self.members: List[int] = list(peers)
        for nd in self.nodes:
            nd.on_membership_change = self._on_membership_change
            if protocol in ("paxos", "pigpaxos"):
                nd.on_became_leader = self._on_became_leader
        for i in range(n, total):
            self.nodes[i].joining = True   # inert learner until add_node
        self.leader_id = 0
        self.clients: List[Client] = []
        if protocol in ("paxos", "pigpaxos"):
            self.nodes[0].start_phase1()

    # ----------------------------------------------------------- membership
    def _on_became_leader(self, node) -> None:
        self.leader_id = node.id

    def _on_membership_change(self, node, op: str, nid: int) -> None:
        """Fired by EVERY node as it applies a cfg command; the first
        application updates the cluster-level view (idempotent after that).
        """
        if op == "add_node":
            if nid not in self.members:
                self.members.append(nid)
                self.members.sort()
        else:
            if nid in self.members:
                self.members.remove(nid)
                if (nid == self.leader_id and self.members
                        and self.protocol in ("paxos", "pigpaxos")):
                    # remove-the-leader: hand leadership to the lowest
                    # member (deferred a tick: we're inside an apply loop)
                    succ = self.members[0]
                    self.sched.after(0.0, self.nodes[succ].start_phase1)

    def add_node(self, j: int, catch_up: bool = True) -> None:
        """Join node ``j`` (usually a spare) through the protocol's
        reconfiguration path: snapshot + log suffix first, voting only after
        the ``add_node`` cfg command applies.  ``catch_up=False`` is the
        deliberately-broken control (state transfer skipped) that the
        auditor must catch."""
        nd = self.nodes[j]
        if self.protocol == "epaxos":
            ref = lambda: min(self.members)
        else:
            ref = lambda: self.leader_id
        nd.begin_join(ref, catch_up=catch_up)

    def remove_node(self, j: int, _tries: int = 40) -> None:
        """Propose removing node ``j`` from the membership.  Retries on a
        timer while no proposer is available (mid-election, or another cfg
        command in flight — the one-at-a-time invariant)."""
        proposer = (min(self.members) if self.protocol == "epaxos"
                    else self.leader_id)
        ok = self.nodes[proposer].propose_reconfig("remove_node", j)
        if not ok and _tries > 0:
            self.sched.after(2 * self.leader_timeout,
                             lambda: self.remove_node(j, _tries - 1))

    def replace_leader(self, j: int) -> None:
        """Planned leader handoff: ``j`` campaigns with a higher ballot and
        the incumbent steps down on its P1a.  No-op for EPaxos (leaderless)
        and for non-members."""
        if self.protocol in ("paxos", "pigpaxos") and j in self.members:
            self.nodes[j].start_phase1()

    # ------------------------------------------------------------- clients
    def add_clients(self, k: int, workload: Optional[WorkloadConfig] = None,
                    stop_at: float = float("inf"),
                    start_at: float = 20e-3) -> None:
        wl = workload or WorkloadConfig()
        cls = Client if wl.arrival == "closed" else OpenLoopClient
        rng = self.sched.rng
        for c in range(k):
            if self.protocol == "epaxos":
                # uniform over the CURRENT membership (identical rng draws
                # to the seed's integers(n) while membership never changes)
                pick = lambda: self.members[int(rng.integers(len(self.members)))]
            else:
                pick = lambda: self.leader_id
            cl = cls(self, len(self.clients), pick, wl, stop_at)
            self.clients.append(cl)
            # stagger client start to avoid a thundering herd at t0
            self.sched.at(start_at + 1e-4 * c, cl.start)

    # ------------------------------------------------------------- failures
    def crash_at(self, node_id: int, t: float) -> None:
        self.sched.at(t, self.nodes[node_id].crash)

    def recover_at(self, node_id: int, t: float) -> None:
        self.sched.at(t, self.nodes[node_id].recover)

    def partition_at(self, a: int, b: int, t: float) -> None:
        self.sched.at(t, lambda: self.net.partition(a, b))

    # ------------------------------------------------------------- running
    def run(self, until: float) -> None:
        self.sched.run(until=until)

    def measure(self, duration: float, warmup: float = 0.5,
                clients: int = 60, workload: Optional[WorkloadConfig] = None,
                reset_stats_at_warmup: bool = True) -> "Stats":
        stop = warmup + duration
        if (self.obs_timelines is not None
                and self.obs_cfg.metrics_dt > 0.0):
            from ..obs import install_sampler
            install_sampler(self, self.obs_timelines, self.obs_cfg.metrics_dt,
                            stop_at=stop + 0.2)
        self.add_clients(clients, workload, stop_at=stop)
        if reset_stats_at_warmup:
            self.sched.at(warmup, self.net.reset_stats)
        mark = {}
        def _mark_commits():
            for i, nd in enumerate(self.nodes):
                mark[i] = getattr(nd, "committed_count", 0)
        self.sched.at(warmup, _mark_commits)
        self.run(until=stop + 0.2)   # drain in-flight ops
        lats = [l for c in self.clients for (t, l) in c.latencies
                if warmup <= t <= stop]
        committed = sum(getattr(nd, "committed_count", 0) for nd in self.nodes) \
            - sum(mark.values())
        return Stats.from_lat(lats, duration, self, committed)

    def read_write_split(self) -> Optional[dict]:
        """Read/write latency+count split across all clients (ms), plus the
        number of leader-local leased reads served.  None unless the
        workload set ``read_ratio``."""
        reads = [l for c in self.clients for l in c.rw_lat[0]]
        writes = [l for c in self.clients for l in c.rw_lat[1]]
        if not reads and not writes:
            return None
        return {
            "reads": len(reads), "writes": len(writes),
            "read_mean_ms": float(np.mean(reads)) * 1e3 if reads else None,
            "write_mean_ms": float(np.mean(writes)) * 1e3 if writes else None,
            "read_p99_ms": (float(np.percentile(np.asarray(reads), 99)) * 1e3
                            if reads else None),
            "lease_reads": sum(getattr(nd, "lease_reads", 0)
                               for nd in self.nodes),
        }


@dataclass
class Stats:
    throughput: float
    mean_ms: float
    median_ms: float
    p25_ms: float
    p75_ms: float
    p99_ms: float
    count: int
    committed: int
    msg_in: np.ndarray = None
    msg_out: np.ndarray = None
    flight: np.ndarray = None
    cpu_busy: Dict[int, float] = None
    # exported observability timelines (repro_torch.obs.Timelines.export()) when
    # the cluster ran with obs enabled; None otherwise
    timelines: Optional[dict] = None

    @classmethod
    def from_lat(cls, lats: List[float], duration: float, cluster: Cluster,
                 committed: int) -> "Stats":
        a = np.asarray(lats) * 1e3 if lats else np.asarray([np.nan])
        n = cluster.n
        return cls(
            throughput=len(lats) / duration,
            mean_ms=float(np.mean(a)), median_ms=float(np.median(a)),
            p25_ms=float(np.percentile(a, 25)), p75_ms=float(np.percentile(a, 75)),
            p99_ms=float(np.percentile(a, 99)),
            count=len(lats), committed=committed,
            msg_in=cluster.net.msgs_in[:n].copy(),
            msg_out=cluster.net.msgs_out[:n].copy(),
            flight=cluster.net.flight_matrix[:n, :n].copy(),
            cpu_busy=dict(cluster.net.cpu_busy),
            timelines=(cluster.net.obs.export()
                       if getattr(cluster.net, "obs", None) is not None
                       else None),
        )

    def messages_per_op(self, node_id: int) -> float:
        ops = max(self.committed, 1)
        return float(self.msg_in[node_id] + self.msg_out[node_id]) / ops


def agreement_ok(cluster: Cluster) -> bool:
    """Safety check: all nodes applied the same commands in the same order.
    Each log must be a contiguous *window* of the longest one: laggards are
    prefixes, snapshot-joined nodes start mid-stream at their snapshot
    point, and a joiner promoted to leader may overhang the end (it applies
    at commit, before the commit messages land on followers)."""
    logs = []
    for nd in cluster.nodes:
        logs.append([(s, c.client_id, c.seq, c.op, c.key) for s, c in nd.applied_log])
    ref = max(logs, key=len)
    # slot/inst-id -> FIRST index (batched slots contribute one applied
    # entry per sub-command, so a slot id can repeat; windows start at
    # batch boundaries, i.e. the first entry of the slot)
    pos: Dict = {}
    for i, e in enumerate(ref):
        pos.setdefault(e[0], i)
    for lg in logs:
        if not lg or lg == ref[:len(lg)]:
            continue                               # prefix: the usual case
        i = pos.get(lg[0][0])
        if i is None:
            return False
        k = min(len(lg), len(ref) - i)
        # the window must match where it overlaps, and anything past the
        # ref's end must be genuinely new — a repeated slot is divergence
        if lg[:k] != ref[i:i + k] or any(e[0] in pos for e in lg[k:]):
            return False
    return True
