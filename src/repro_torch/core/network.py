"""Simulated transport: per-link latency + per-node CPU service queues.

Model (matches the paper's observed bottleneck, §2.2):
  send(msg):  src CPU busy for cost(msg)   (serialize)
              -> link latency L(src,dst)   (propagation + jitter)
              -> dst CPU busy for cost(msg) (deserialize + handle)
              -> dst handler runs

Each node's CPU is a single FIFO server; leader saturation emerges naturally
when its CPU utilization approaches 1.  Message counts per (src,dst) and per
node are recorded to validate the analytical model (Table 1/2) and to draw
the in-flight heatmap (Fig 17).

A copy of ``repro.core.network`` (its ``Topology`` and ``wan_topology``
feed the batch backend's lowering too).  Engine notes:

  * The three stages of a hop are slab events (see events.py) executed by
    the fused loop in :meth:`Network._run` — no closures, no per-event
    Python function call, no numpy scalars on the hot path.  Event times,
    tie-break order, and RNG consumption are identical to the reference's
    seed engine.
  * ``fast_path=True`` flattens each hop into a single delivery event whose
    CPU-queue start times are precomputed at send time (latency drawn and
    partitions checked at send instead of at serialize-done).  ~3x fewer
    heap operations; aggregate statistics (throughput, utilization, message
    counts) are preserved but traces are *not* bit-identical to the seed —
    use it for large-N sweeps, never for golden-trace comparisons.
  * Accounting uses plain Python ints (lists + a sparse flight dict); the
    numpy views are materialized lazily via properties.  Set
    ``accounting=False`` to skip it entirely in the hot loop.
"""
from __future__ import annotations

import gc
import heapq
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .events import (K_ARRIVE, K_CALL, K_DELIVER, K_HANDLE, K_TRANSMIT,
                     Scheduler)
from .messages import CostModel, Msg

_INF = float("inf")


@dataclass
class Topology:
    """Latency model. ``region_of`` maps node id -> region index;
    ``rtt_matrix[r1][r2]`` is the one-way base latency between regions."""
    n: int
    base_latency: float = 0.25e-3          # LAN one-way
    jitter: float = 0.05e-3
    region_of: Optional[list] = None
    region_latency: Optional[np.ndarray] = None   # one-way seconds

    def latency(self, rng: np.random.Generator, src: int, dst: int) -> float:
        return self.base_between(src, dst) + rng.exponential(self.jitter)

    def base_between(self, src: int, dst: int) -> float:
        """Deterministic part of :meth:`latency` (no jitter draw).
        Endpoints >= n are clients: co-located with the leader's region
        (region 0), as in the paper's WAN setup (§5.3)."""
        if self.region_of is None:
            return self.base_latency
        rs = self.region_of[src] if src < self.n else 0
        rd = self.region_of[dst] if dst < self.n else 0
        return float(self.region_latency[rs][rd])


def wan_topology(nodes_per_region: list[int], oneway_ms: list[list[float]]) -> Topology:
    region_of = []
    for r, k in enumerate(nodes_per_region):
        region_of += [r] * k
    return Topology(
        n=len(region_of),
        jitter=0.05e-3,
        region_of=region_of,
        region_latency=np.asarray(oneway_ms) * 1e-3,
    )


class Network:
    """Transport + CPU queues + failure injection + accounting."""

    def __init__(self, sched: Scheduler, topo: Topology,
                 cost: CostModel | None = None, fast_path: bool = False):
        self.sched = sched
        sched._net = self              # sched.run() degrades to our fused loop
        self.topo = topo
        self.cost = cost or CostModel()
        self.fast_path = fast_path
        self.n_servers = topo.n        # ids >= n are clients (free CPUs)
        cap = topo.n + 1024            # room for client endpoints (ids >= n)
        self._cap = cap
        self.nodes: list = [None] * cap          # id -> node (has ._dispatch & .crashed)
        self.cpu_free: list = [0.0] * cap        # id -> time CPU becomes free
        self._cpu_busy: list = [0.0] * cap       # id -> total busy seconds
        self._msgs_out: list = [0] * cap
        self._msgs_in: list = [0] * cap
        # deferred send accounting: the hot path appends one encoded int per
        # send ((src << 20) | dst); _materialize() folds the log into
        # _msgs_out/_flight when stats are actually read
        self._send_log: list = []
        self._flight: dict = {}                  # (src<<20|dst) -> count
        self._fixed = self.cost._fixed           # class -> constant cpu cost
        self.partitioned: set[Tuple[int, int]] = set()
        # per-node link degradation (gray/slow nodes, repro_torch.faults):
        # node -> (extra_latency_s, latency_factor, drop_prob), applied to
        # every hop touching the node.  Mutated in place by degrade/restore
        # so the fused loops' captured reference stays live (same pattern as
        # ``partitioned``); the empty-dict truthiness check keeps the
        # fault-free hot path unchanged.
        self._degraded: dict = {}
        self.accounting = True
        # fast-path jitter presampling: one rng call per hop is ~15% of the
        # flattened loop, so draw Exp(jitter) in blocks and hand out plain
        # Python floats.  The fast path is already not bit-identical to the
        # exact engine, so consuming the RNG in blocks is fair game (the
        # exact engine keeps its per-hop draws — golden traces depend on it).
        self._jitter_block: list = []
        self._jitter_idx = 0
        # observability (repro.obs): ``tracer`` collects per-op span trees
        # (purely observational — no events, no RNG, no message mutation, so
        # golden traces hold even with tracing on); ``obs`` is the Timelines
        # registry whose ring buffers reset with the rest of the stats at
        # the warmup boundary.  Both None unless Cluster(obs=...) wired them.
        self.tracer = None
        self.obs = None

    _JITTER_BLOCK = 4096

    def _next_jitter(self, rng, scale: float) -> float:
        i = self._jitter_idx
        block = self._jitter_block
        if i >= len(block):
            block = rng.exponential(scale, self._JITTER_BLOCK).tolist()
            self._jitter_block = block
            i = 0
        self._jitter_idx = i + 1
        return block[i]

    def register(self, node_id: int, node) -> None:
        if node_id >= self._cap:
            grow = node_id + 256 - self._cap
            self.nodes.extend([None] * grow)
            self.cpu_free.extend([0.0] * grow)
            self._cpu_busy.extend([0.0] * grow)
            self._msgs_out.extend([0] * grow)
            self._msgs_in.extend([0] * grow)
            self._cap = node_id + 256
        self.nodes[node_id] = node

    # -------------------------------------------------------------- failure
    def partition(self, a: int, b: int) -> None:
        self.partitioned.add((a, b))
        self.partitioned.add((b, a))

    def heal(self, a: int, b: int) -> None:
        self.partitioned.discard((a, b))
        self.partitioned.discard((b, a))

    def partition_oneway(self, a: int, b: int) -> None:
        """Asymmetric cut: a's messages to b are lost, b -> a still flows."""
        self.partitioned.add((a, b))

    def heal_oneway(self, a: int, b: int) -> None:
        self.partitioned.discard((a, b))

    def degrade(self, node: int, extra_latency: float = 0.0,
                factor: float = 1.0, drop_prob: float = 0.0) -> None:
        """Gray/slow node (§4.2 failure model): every hop touching ``node``
        pays ``latency * factor + extra_latency`` and is dropped with
        probability ``drop_prob``.  One degradation state per node — a new
        call replaces the previous one."""
        self._degraded[node] = (float(extra_latency), float(factor),
                                float(drop_prob))

    def restore(self, node: int) -> None:
        self._degraded.pop(node, None)

    def _degraded_latency(self, src: int, dst: int, lat: float, rng) -> float:
        """Latency for a hop with a degraded endpoint; -1.0 means dropped.
        The drop draw consumes the sim RNG only on degraded hops."""
        ds = self._degraded.get(src)
        dd = self._degraded.get(dst)
        drop = (ds[2] if ds else 0.0) + (dd[2] if dd else 0.0)
        if drop > 0.0 and rng.random() < drop:
            return -1.0
        if ds is not None:
            lat = lat * ds[1] + ds[0]
        if dd is not None:
            lat = lat * dd[1] + dd[0]
        return lat

    # -------------------------------------------------------------- send
    def send(self, src: int, dst: int, msg: Msg) -> None:
        msg.src = src
        node_src = self.nodes[src]
        if node_src is not None and node_src.crashed:
            return
        c = msg._cost
        if c < 0.0:
            c = self._fixed.get(msg.__class__)
            if c is None:
                c = self.cost.cpu_cost(msg)
        if self.accounting:
            self._send_log.append((src << 20) | dst)
        sched = self.sched
        if self.fast_path:
            self._send_fast(src, dst, msg, c, sched)
            return
        # serialize on the sender's CPU (clients, id >= n, have free CPUs)
        if src < self.n_servers:
            free = self.cpu_free[src]
            now = sched.now
            start = now if now > free else free
            done = start + c
            self.cpu_free[src] = done
            self._cpu_busy[src] += c
            tr = self.tracer
            if tr is not None:
                ctx = msg._tctx or tr.cur
                if ctx is not None:
                    tr.attach(msg, ctx)
                    tr.add_span(ctx, "ser", src, start, done)
        else:
            done = sched.now
            tr = self.tracer
            if tr is not None:
                ctx = msg._tctx or tr.cur
                if ctx is not None:
                    tr.attach(msg, ctx)
        sched._seq = seq = sched._seq + 1
        heapq.heappush(sched._heap, (done, seq, K_TRANSMIT, src, dst, msg, c))

    def _send_fast(self, src: int, dst: int, msg: Msg, c: float,
                   sched: Scheduler) -> None:
        """Flattened hop: ONE heap event per message.

        Serialize-reservation, partition check, and the latency draw all
        happen inline at send time; the single K_DELIVER event fires at the
        *arrival* time, where the loop reserves the receiver's CPU slot
        (preserving FIFO arrival-order queueing — reserving at send time
        would queue the receiver's own sends behind not-yet-arrived traffic)
        and runs the handler immediately with ``now`` advanced to the
        service-completion time.  Handler order per node and all CPU-queue
        occupancy match the exact engine; only the fine-grained interleaving
        across nodes (and hence RNG order) differs.
        """
        now = sched.now
        if src < self.n_servers:
            free = self.cpu_free[src]
            start = now if now > free else free
            done = start + c
            self.cpu_free[src] = done
            self._cpu_busy[src] += c
        else:
            done = now
        if self.partitioned and (src, dst) in self.partitioned:
            return
        topo = self.topo
        base = (topo.base_latency if topo.region_of is None
                else topo.base_between(src, dst))
        lat = base + self._next_jitter(sched.rng, topo.jitter)
        deg = self._degraded
        if deg and (src in deg or dst in deg):
            lat = self._degraded_latency(src, dst, lat, sched.rng)
            if lat < 0.0:
                return                     # dropped by a lossy gray node
        arrive = done + lat
        tr = self.tracer
        if tr is not None:
            ctx = msg._tctx or tr.cur
            if ctx is not None:
                tr.attach(msg, ctx)
                if src < self.n_servers:
                    tr.add_span(ctx, "ser", src, done - c, done)
                tr.add_span(ctx, "net", src, done, arrive)
        sched._seq = seq = sched._seq + 1
        heapq.heappush(sched._heap, (arrive, seq, K_DELIVER, dst, msg, c, None))

    # -------------------------------------------------------------- engine
    def _run(self, until: float, max_events: Optional[int]) -> int:
        """Fused event loop: executes message stages inline (no per-event
        Python call) and K_CALL timers via the scheduler slab.

        Semantics are identical to the reference's seed scheduler driving
        its closure chain (same times, same tie-breaks, same RNG order).

        The collector is paused for the duration of the loop: the hot path
        churns short-lived tuples/messages that gen-0 collections rescan
        constantly (~25% of wall time).  Simulation state is effectively
        acyclic, so deferring collection to the end of the run is safe.
        """
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            if self.fast_path:
                return self._run_fast(until, max_events)
            return self._run_exact(until, max_events)
        finally:
            if gc_was_enabled:
                gc.enable()

    def _run_exact(self, until: float, max_events: Optional[int]) -> int:
        sched = self.sched
        heap = sched._heap
        pop = heapq.heappop
        push = heapq.heappush
        nodes = self.nodes
        cpu_free = self.cpu_free
        cpu_busy = self._cpu_busy
        msgs_in = self._msgs_in
        gens = sched._gen
        free_slots = sched._free
        nsrv = self.n_servers
        topo = self.topo
        lan = topo.region_of is None
        base = topo.base_latency
        jitter = topo.jitter
        rng = sched.rng
        rng_exp = rng.exponential
        part = self.partitioned
        deg = self._degraded
        acct = self.accounting
        tr = self.tracer
        # tracer cost contract: an unsampled op costs one ``_tctx`` slot
        # load per event here — no id() call, no dict probe (the hop map
        # is only touched for messages that actually carry a context)
        tr_hop = tr._hop if tr is not None else None
        n = 0
        while heap:
            ev = pop(heap)
            t = ev[0]
            if t > until:
                push(heap, ev)
                break
            kind = ev[2]
            if kind == K_HANDLE:
                dst = ev[3]
                node = nodes[dst]
                sched.now = t
                if tr is not None and ev[4]._tctx is not None:
                    # ambient ctx: sends inside the handler inherit the
                    # hop's svc span recorded at K_ARRIVE (popped even for
                    # crashed nodes so the hop map can't leak on this path).
                    # Unsampled messages skip this entirely: ``cur`` is
                    # always None between handlers (the post-handler clear
                    # below; timer paths save/restore).
                    mid = id(ev[4])
                    h = tr_hop.get(mid)
                    if h is None:
                        tr.cur = None
                    else:
                        tr.cur = h.pop(dst, None)
                        if not h:
                            del tr_hop[mid]
                if node is not None and not node.crashed:
                    msg = ev[4]
                    if acct:
                        msgs_in[dst] += 1
                    try:
                        d = node._dispatch
                    except AttributeError:
                        node.deliver(msg)   # duck-typed node (runtime layer)
                    else:
                        h = d.get(msg.__class__)
                        if h is None:
                            h = node._bind_handler(msg.__class__)
                        h(msg)
                if tr is not None:
                    tr.cur = None
            elif kind == K_ARRIVE:
                sched.now = t
                dst = ev[4]
                node = nodes[dst]
                if node is not None and not node.crashed:
                    if dst < nsrv:
                        c = ev[6]
                        free = cpu_free[dst]
                        start = t if t > free else free
                        done = start + c
                        cpu_free[dst] = done
                        cpu_busy[dst] += c
                        sched._seq = seq = sched._seq + 1
                        push(heap, (done, seq, K_HANDLE, dst, ev[5], None, None))
                        if tr is not None:
                            ctx = ev[5]._tctx
                            if ctx is not None:
                                # ev[7]: transmit time (net span recorded
                                # here so K_TRANSMIT needs no tracer hook)
                                tr.add_span(ctx, "net", ev[3], ev[7], t)
                                if start > t:
                                    tr.add_span(ctx, "queue", dst, t, start)
                                sid = tr.add_span(ctx, "svc", dst, start, done)
                                mid = id(ev[5])
                                h = tr_hop.get(mid)
                                if h is None:
                                    h = tr_hop[mid] = {}
                                h[dst] = (ctx[0], sid)
                    else:
                        sched._seq = seq = sched._seq + 1
                        push(heap, (t, seq, K_HANDLE, dst, ev[5], None, None))
                        if tr is not None:
                            ctx = ev[5]._tctx
                            if ctx is not None:
                                tr.add_span(ctx, "net", ev[3], ev[7], t)
                                mid = id(ev[5])
                                h = tr_hop.get(mid)
                                if h is None:
                                    h = tr_hop[mid] = {}
                                h[dst] = ctx
            elif kind == K_TRANSMIT:
                sched.now = t
                src = ev[3]
                dst = ev[4]
                if not part or (src, dst) not in part:
                    if lan:
                        lat = base + rng_exp(jitter)
                    else:
                        lat = topo.latency(rng, src, dst)
                    if deg and (src in deg or dst in deg):
                        lat = self._degraded_latency(src, dst, lat, rng)
                        if lat >= 0.0:     # not dropped by a gray node
                            sched._seq = seq = sched._seq + 1
                            push(heap, (t + lat, seq, K_ARRIVE, src, dst,
                                        ev[5], ev[6], t))
                    else:
                        sched._seq = seq = sched._seq + 1
                        push(heap, (t + lat, seq, K_ARRIVE, src, dst,
                                    ev[5], ev[6], t))
            else:  # K_CALL timer via the generation slab
                slot = ev[3]
                gen = ev[4]
                free_slots.append(slot)
                if gens[slot] != gen:
                    continue           # cancelled: skip, don't count
                gens[slot] = gen + 1
                sched.now = t
                ev[5]()
                acct = self.accounting   # timers may toggle/reset accounting
                tr = self.tracer
                tr_hop = tr._hop if tr is not None else None
            n += 1
            if max_events is not None and n >= max_events:
                break
        if sched.now < until < _INF:
            sched.now = until
        sched.events += n
        return n

    def _run_fast(self, until: float, max_events: Optional[int]) -> int:
        """Flattened-mode loop: only K_DELIVER + K_CALL events exist."""
        sched = self.sched
        heap = sched._heap
        pop = heapq.heappop
        push = heapq.heappush
        nodes = self.nodes
        cpu_free = self.cpu_free
        cpu_busy = self._cpu_busy
        msgs_in = self._msgs_in
        gens = sched._gen
        free_slots = sched._free
        nsrv = self.n_servers
        acct = self.accounting
        tr = self.tracer
        n = 0
        while heap:
            ev = pop(heap)
            t = ev[0]
            if t > until:
                push(heap, ev)
                break
            if ev[2] == K_DELIVER:
                # reserve the receiver CPU slot now (arrival order) and run
                # the handler at the service-completion time
                dst = ev[3]
                node = nodes[dst]
                sched.now = t
                if node is not None and not node.crashed:
                    msg = ev[4]
                    if dst < nsrv:
                        c = ev[5]
                        free = cpu_free[dst]
                        start = t if t > free else free
                        done = start + c
                        cpu_free[dst] = done
                        cpu_busy[dst] += c
                        sched.now = done
                        if tr is not None:
                            ctx = msg._tctx
                            if ctx is not None:
                                if start > t:
                                    tr.add_span(ctx, "queue", dst, t, start)
                                sid = tr.add_span(ctx, "svc", dst, start, done)
                                tr.cur = (ctx[0], sid)
                    elif tr is not None:
                        tr.cur = msg._tctx
                    if acct:
                        msgs_in[dst] += 1
                    try:
                        d = node._dispatch
                    except AttributeError:
                        node.deliver(msg)   # duck-typed node (runtime layer)
                    else:
                        h = d.get(msg.__class__)
                        if h is None:
                            h = node._bind_handler(msg.__class__)
                        h(msg)
                    if tr is not None:
                        tr.cur = None
            else:  # K_CALL
                slot = ev[3]
                gen = ev[4]
                free_slots.append(slot)
                if gens[slot] != gen:
                    continue
                gens[slot] = gen + 1
                sched.now = t
                ev[5]()
                acct = self.accounting
                tr = self.tracer
            n += 1
            if max_events is not None and n >= max_events:
                break
        if sched.now < until < _INF:
            sched.now = until
        sched.events += n
        return n

    # -------------------------------------------------------------- stats
    def _materialize(self) -> None:
        """Fold the deferred send log into per-node counts + flight pairs."""
        log = self._send_log
        if not log:
            return
        out = self._msgs_out
        f = self._flight
        fget = f.get
        for k in log:
            out[k >> 20] += 1
            f[k] = fget(k, 0) + 1
        log.clear()

    @property
    def msgs_out(self) -> np.ndarray:
        self._materialize()
        return np.asarray(self._msgs_out, dtype=np.int64)

    @property
    def msgs_in(self) -> np.ndarray:
        return np.asarray(self._msgs_in, dtype=np.int64)

    @property
    def flight_matrix(self) -> np.ndarray:
        self._materialize()
        cap = self._cap
        m = np.zeros((cap, cap), dtype=np.int64)
        for k, v in self._flight.items():
            m[k >> 20, k & 0xFFFFF] = v
        return m

    @property
    def cpu_busy(self) -> dict:
        return {i: b for i, b in enumerate(self._cpu_busy)
                if self.nodes[i] is not None}

    def reset_stats(self) -> None:
        cap = self._cap
        self._send_log.clear()
        self._msgs_out[:] = [0] * cap
        self._msgs_in[:] = [0] * cap
        self._flight.clear()
        self._cpu_busy[:] = [0.0] * cap
        if self.obs is not None:
            self.obs.reset()   # warmup samples never pollute timelines

    def message_load(self, node_id: int) -> int:
        self._materialize()
        return self._msgs_out[node_id] + self._msgs_in[node_id]
