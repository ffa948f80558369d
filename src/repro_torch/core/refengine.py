"""Reference (seed) discrete-event engine, kept verbatim for equivalence
(a copy of ``repro.core.refengine``, line for line: ``Cluster(engine="ref")``
of the port runs it, and the port's tests hold it to the reference's seed
stack, event for event).

This module preserves the original closure-chain engine exactly as it shipped
in the seed: three heap events per message hop (serialize -> transmit ->
arrive -> handle), numpy accounting, and an unbounded ``_cancelled`` set.

It exists for two reasons:
  1. the golden-trace equivalence tests (tests/test_torch_refengine.py) run
     the fast engine and this reference side by side and require
     *identical* applied command logs, committed counts, and executed event
     counts;
  2. it is the baseline of the engines' events/sec ratio (chip_smoke.py
     prints it beside the ``exact`` engine's).

To keep the baseline honest, this module also preserves the seed's per-hop
machinery that has since been optimized in the shared layers: the
string-concatenation handler dispatch (``getattr(node, "on_" + msg.kind)``
per delivery, seed node.py) and the uncached cost computation
(``getattr(msg, "n_cluster", 0)`` per send, seed messages.py).

Do not optimize this file: its value is that it never changes behavior.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .messages import CostModel, Msg
from .network import Topology


class RefScheduler:
    """The seed scheduler: (time, seq, closure) heap entries."""

    __slots__ = ("now", "_heap", "_seq", "rng", "_cancelled", "events")

    def __init__(self, seed: int = 0):
        self.now: float = 0.0
        self._heap: list = []
        self._seq: int = 0
        self.rng = np.random.default_rng(seed)
        self._cancelled: set[int] = set()
        self.events: int = 0          # cumulative executed (bench accounting)

    def at(self, t: float, fn: Callable[[], None]) -> int:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn))
        return self._seq

    def after(self, dt: float, fn: Callable[[], None]) -> int:
        return self.at(self.now + dt, fn)

    def cancel(self, timer_id: int) -> None:
        self._cancelled.add(timer_id)

    def run(self, until: float = float("inf"), max_events: Optional[int] = None) -> int:
        n = 0
        heap = self._heap
        cancelled = self._cancelled
        while heap:
            t, seq, fn = heap[0]
            if t > until:
                break
            heapq.heappop(heap)
            if seq in cancelled:
                cancelled.discard(seq)
                continue
            self.now = t
            fn()
            n += 1
            if max_events is not None and n >= max_events:
                break
        if self.now < until < float("inf"):
            self.now = until
        self.events += n
        return n

    def idle(self) -> bool:
        return not self._heap


class RefNetwork:
    """The seed transport: one closure-chain event per message stage."""

    def __init__(self, sched: RefScheduler, topo: Topology,
                 cost: CostModel | None = None):
        self.sched = sched
        self.topo = topo
        self.cost = cost or CostModel()
        self.nodes: Dict[int, "object"] = {}
        self.cpu_free: Dict[int, float] = {}
        self.cpu_busy: Dict[int, float] = {}
        cap = topo.n + 1024
        self.msgs_out = np.zeros(cap, dtype=np.int64)
        self.msgs_in = np.zeros(cap, dtype=np.int64)
        self.flight_matrix = np.zeros((cap, cap), dtype=np.int64)
        self.partitioned: set[Tuple[int, int]] = set()
        self.accounting = True

    def register(self, node_id: int, node) -> None:
        self.nodes[node_id] = node
        self.cpu_free[node_id] = 0.0
        self.cpu_busy[node_id] = 0.0

    # -------------------------------------------------------------- failure
    def partition(self, a: int, b: int) -> None:
        self.partitioned.add((a, b))
        self.partitioned.add((b, a))

    def heal(self, a: int, b: int) -> None:
        self.partitioned.discard((a, b))
        self.partitioned.discard((b, a))

    # -------------------------------------------------------------- CPU
    def _cpu(self, node_id: int, cost: float, fn: Callable[[], None]) -> None:
        start = max(self.sched.now, self.cpu_free[node_id])
        done = start + cost
        self.cpu_free[node_id] = done
        self.cpu_busy[node_id] += cost
        self.sched.at(done, fn)

    # -------------------------------------------------------------- send
    def _seed_cpu_cost(self, msg: Msg) -> float:
        """The seed's uncached cost computation (pre-caching messages.py)."""
        cost = self.cost
        c = cost.base + cost.per_byte * msg.wire_size()
        n = getattr(msg, "n_cluster", 0)
        if n:
            c += cost.epaxos_extra_per_node * n
        return c

    def send(self, src: int, dst: int, msg: Msg) -> None:
        msg.src = src
        node_src = self.nodes.get(src)
        if node_src is not None and getattr(node_src, "crashed", False):
            return
        c = self._seed_cpu_cost(msg)
        if self.accounting:
            self.msgs_out[src] += 1
            self.flight_matrix[src][dst] += 1

        def _transmit() -> None:
            if (src, dst) in self.partitioned:
                return
            lat = self.topo.latency(self.sched.rng, src, dst)
            self.sched.after(lat, lambda: self._arrive(src, dst, msg, c))

        if src < self.topo.n:
            self._cpu(src, c, _transmit)
        else:
            self.sched.after(0.0, _transmit)

    def _arrive(self, src: int, dst: int, msg: Msg, c: float) -> None:
        node = self.nodes.get(dst)
        if node is None or getattr(node, "crashed", False):
            return

        def _handle() -> None:
            n2 = self.nodes.get(dst)
            if n2 is None or getattr(n2, "crashed", False):
                return
            if self.accounting:
                self.msgs_in[dst] += 1
            # seed dispatch: string-keyed getattr per delivery (seed node.py)
            handler = getattr(n2, "on_" + msg.kind, None)
            if handler is None:
                n2.deliver(msg)       # Client & handler-error path
            else:
                handler(msg)

        if dst < self.topo.n:
            self._cpu(dst, c, _handle)
        else:
            self.sched.after(0.0, _handle)

    # -------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        self.msgs_out[:] = 0
        self.msgs_in[:] = 0
        self.flight_matrix[:] = 0
        for k in self.cpu_busy:
            self.cpu_busy[k] = 0.0

    def message_load(self, node_id: int) -> int:
        return int(self.msgs_out[node_id] + self.msgs_in[node_id])


# ===========================================================================
# Seed protocol snapshot (commit e247e29), kept verbatim like the engine
# above.  The golden-trace tests run this full seed stack (seed scheduler +
# seed network + seed dispatch + seed protocol classes) against the
# optimized stack and require identical traces, which proves BOTH the engine
# rewrite AND the protocol-layer optimizations are behavior-preserving.
# benchmarks/sim_engine_bench.py uses it as the end-to-end seed baseline.
# Only the class names carry a Ref prefix so the two stacks can coexist.
# ===========================================================================
from dataclasses import dataclass, field
from typing import Callable as _Callable, Sequence

from .messages import (ClientReply, ClientRequest, Command, EAccept,
                       EAcceptReply, ECommit, P1a, P1b, P2a, P2b, P3,
                       PigAggregate, PigFanout, PigRelayed, PigReply,
                       PreAccept, PreAcceptReply)
from .node import KVStore
from .paxos import CatchUpReq, CatchUpResp
from .pig import PigConfig
from .quorums import QuorumSystem, fast_quorum, majority

class RefNode:
    """Base class: protocol nodes subclass and add ``on_<MsgType>`` handlers."""

    def __init__(self, node_id: int, net: Network, sched: Scheduler):
        self.id = node_id
        self.net = net
        self.sched = sched
        self.crashed = False
        self.store = KVStore()
        self.applied_log: list = []   # sequence of (slot/inst, command) applied
        net.register(node_id, self)

    # ------------------------------------------------------------ transport
    def send(self, dst: int, msg: Msg) -> None:
        self.net.send(self.id, dst, msg)

    def deliver(self, msg: Msg) -> None:
        if self.crashed:
            return
        handler = getattr(self, "on_" + msg.kind, None)
        if handler is None:
            raise RuntimeError(f"{type(self).__name__} has no handler for {msg.kind}")
        handler(msg)

    # ------------------------------------------------------------ timers
    def set_timer(self, delay: float, fn) -> int:
        def _fire():
            if not self.crashed:
                fn()
        return self.sched.after(delay, _fire)

    def cancel_timer(self, timer_id: int) -> None:
        self.sched.cancel(timer_id)

    # ------------------------------------------------------------ failure
    def crash(self) -> None:
        self.crashed = True

    def recover(self) -> None:
        self.crashed = False


class RefDirectComm:
    """Classic Paxos communication: leader <-> every follower directly."""

    name = "direct"

    def __init__(self, node, peers: Sequence[int]):
        self.node = node
        self.peers = [p for p in peers if p != node.id]

    # leader side -----------------------------------------------------------
    def broadcast(self, make_msg: Callable[[], Msg], round_key=None) -> list:
        for p in self.peers:
            self.node.send(p, make_msg())
        return []

    # follower side ---------------------------------------------------------
    def reply(self, to: int, msg: Msg) -> None:
        self.node.send(to, msg)

    # no-op hooks so Paxos can stay comm-agnostic
    def note_commit(self, slot: int) -> None:
        pass

    def note_committed_up_to(self, ci: int) -> None:
        pass

    def on_round_timeout(self, round_ids) -> None:
        pass


class RefPigComm:
    """Pig overlay communication used by the leader and all followers."""

    name = "pig"

    def __init__(self, node, peers: Sequence[int], cfg: PigConfig):
        self.node = node
        self.cfg = cfg
        self.all_nodes = list(peers)
        self._groups_cache: Dict[int, List[List[int]]] = {}
        self._pig_seq = node.id << 40
        # relay-side aggregation state: pig_id -> dict
        self._agg: Dict[int, dict] = {}
        # leader-side: pig_id -> (group_idx, relay, round_key)
        self._outstanding: Dict[int, tuple] = {}
        self._pending_sup: Dict[int, int] = {}   # slot -> pig_id (late votes)
        self.gray: Dict[int, float] = {}     # node -> expiry time (§4.2)

    @staticmethod
    def _partition(members: Sequence[int], r: int) -> List[List[int]]:
        r = max(1, min(r, len(members)))
        out: List[List[int]] = [[] for _ in range(r)]
        for i, m in enumerate(members):
            out[i % r].append(m)
        return out

    def groups_for(self, leader: int) -> List[List[int]]:
        """Relay groups are a cluster-wide static partition of the *followers*
        (paper §3.2) — i.e. of all nodes except the current leader.  Every
        node derives the same partition deterministically from the leader id,
        so relays and the leader agree without extra coordination."""
        g = self._groups_cache.get(leader)
        if g is None:
            if self.cfg.groups is not None:
                g = [[m for m in grp if m != leader] for grp in self.cfg.groups]
                g = [grp for grp in g if grp]
            else:
                g = self._partition([p for p in self.all_nodes if p != leader],
                                    self.cfg.n_groups)
            self._groups_cache[leader] = g
        return g

    # ---------------------------------------------------------------- leader
    def _pick_relay(self, group: List[int]) -> int:
        rng = self.node.sched.rng
        if not self.cfg.rotate_relays:
            return group[0]
        candidates = group
        if self.cfg.use_gray_list:
            now = self.node.sched.now
            healthy = [g for g in group if self.gray.get(g, 0.0) <= now]
            if healthy and (len(healthy) == len(group)
                            or rng.random() > self.cfg.gray_probe_prob):
                candidates = healthy
        return candidates[int(rng.integers(len(candidates)))]

    def _required_per_group(self, groups: List[List[int]]) -> List[int]:
        """PRC thresholds q_i = n_i - PRC, subject to the paper's §4.1
        constraint sum(q_i) >= majority - 1 (the leader votes for itself);
        violating it would let a single crashed group block liveness."""
        maj = len(self.all_nodes) // 2 + 1
        if self.cfg.single_group_majority and len(groups) == 1:
            return [min(len(groups[0]), maj - 1)]     # §4.3: global majority
        req = [max(1, len(g) - self.cfg.prc) for g in groups]
        i = 0
        while sum(req) < maj - 1:
            if req[i % len(req)] < len(groups[i % len(req)]):
                req[i % len(req)] += 1
            i += 1
            if i > 4 * len(req):       # all groups already at n_i
                break
        return req

    def broadcast(self, make_msg: Callable[[], Msg], round_key=None) -> list:
        """Start one Pig round per relay group.  Returns the pig ids used,
        so the caller can gray non-responsive relays on its own timeout."""
        ids = []
        groups = self.groups_for(self.node.id)
        required = self._required_per_group(groups)
        for gi, group in enumerate(groups):
            self._pig_seq += 1
            pid = self._pig_seq
            relay = self._pick_relay(group)
            self._outstanding[pid] = (gi, relay, round_key)
            self.node.send(relay, PigFanout(pig_id=pid, group=gi,
                                            inner=make_msg(),
                                            required=required[gi]))
            ids.append(pid)
        return ids

    def on_round_timeout(self, pig_ids) -> None:
        """Leader timed out on a round: gray the relays that never replied."""
        now = self.node.sched.now
        for pid in pig_ids:
            st = self._outstanding.pop(pid, None)
            if st is not None and self.cfg.use_gray_list:
                self.gray[st[1]] = now + self.cfg.gray_duration

    def leader_handle_aggregate(self, msg: PigAggregate) -> None:
        st = self._outstanding.pop(msg.pig_id, None)
        if st is None:
            return None
        # only nodes that made the relay *time out* are failure suspects;
        # nodes skipped by early PRC flushes are merely slow-this-round (§4.2)
        if self.cfg.use_gray_list and msg.timed_out:
            now = self.node.sched.now
            for m in msg.missing:
                self.gray[m] = now + self.cfg.gray_duration
        return None

    # ---------------------------------------------------------------- relay
    def on_PigFanout(self, msg: PigFanout) -> None:
        node = self.node
        gi = msg.group
        groups = self.groups_for(msg.src)   # groups relative to the leader
        group = groups[gi] if gi < len(groups) else []
        peers = [p for p in group if p != node.id]
        st = {
            "replies": [],
            "voters": set(),
            "required": msg.required,
            "leader": msg.src,
            "group": gi,
            "expect": set(peers),
            "done": False,
            "timer": None,
        }
        self._agg[msg.pig_id] = st
        # 1) act as a regular follower on the inner message
        my_reply = node.process_inner(msg.inner)
        if my_reply is not None:
            self._accumulate(msg.pig_id, node.id, my_reply)
        # 2) re-transmit to the rest of the group
        for p in peers:
            node.send(p, PigRelayed(pig_id=msg.pig_id, relay=node.id,
                                    inner=msg.inner))
        # 3) arm the relay timeout T_r (§3.4)
        st["timer"] = node.set_timer(self.cfg.relay_timeout,
                                     lambda: self._flush(msg.pig_id, timeout=True))
        self._maybe_flush(msg.pig_id)

    # ---------------------------------------------------------------- follower
    def on_PigRelayed(self, msg: PigRelayed) -> None:
        reply = self.node.process_inner(msg.inner)
        if reply is not None:
            self.node.send(msg.relay, PigReply(pig_id=msg.pig_id, inner=reply))

    def on_PigReply(self, msg: PigReply) -> None:
        self._accumulate(msg.pig_id, msg.src, msg.inner)
        self._maybe_flush(msg.pig_id)

    # ---------------------------------------------------------------- agg
    def _accumulate(self, pig_id: int, voter: int, reply: Msg) -> None:
        st = self._agg.get(pig_id)
        if st is None:
            return
        if st["done"]:
            self._queue_late_vote(pig_id, st, voter, reply)
            return
        st["voters"].add(voter)
        st["replies"].append(reply)
        # reject short-circuit: don't wait for aggregation (§3.2, footnote 1)
        if getattr(reply, "ok", True) is False:
            self._flush(pig_id, reject=True)

    def _queue_late_vote(self, pig_id: int, st: dict, voter: int,
                         reply: Msg) -> None:
        """A vote arriving after the PRC/timeout flush.  The leader usually
        doesn't need it (other groups give the majority), so batch it for
        T_r and cancel if the slot is seen committed in the meantime; only a
        starved round actually pays the extra message (§4.1: 'requiring more
        communication to learn the missing votes')."""
        if voter in st["voters"] or not getattr(reply, "ok", True):
            return
        st["voters"].add(voter)
        if isinstance(reply, P1b):
            # leader election is liveness-critical: forward immediately
            sup = _RefP1Aggregate(PigAggregate(
                pig_id=pig_id, group=st["group"], ballot=reply.ballot,
                slot=-1, acks=1, voters=(voter,)), [reply])
            self.node.send(st["leader"], sup)
            return
        st.setdefault("late", []).append((voter, reply))
        if st.get("sup_timer") is None:
            st["sup_timer"] = self.node.set_timer(
                self.cfg.relay_timeout,
                lambda: self._send_supplement(pig_id))
            slot = getattr(reply, "slot", None)
            if slot is not None and slot >= 0:
                self._pending_sup[slot] = pig_id

    def _send_supplement(self, pig_id: int) -> None:
        st = self._agg.get(pig_id)
        if st is None or not st.get("late"):
            return
        late = st.pop("late")
        st["sup_timer"] = None
        first = late[0][1]
        self.node.send(st["leader"], PigAggregate(
            pig_id=pig_id, group=st["group"],
            ballot=getattr(first, "ballot", (0, 0)),
            slot=getattr(first, "slot", -1), acks=len(late),
            voters=tuple(v for v, _ in late), missing=()))

    def note_committed_up_to(self, ci: int) -> None:
        """Called when this node learns a commit index: pending supplements
        for committed slots are unnecessary — drop them."""
        if not self._pending_sup:
            return
        for slot in [s for s in self._pending_sup if s <= ci]:
            pid = self._pending_sup.pop(slot)
            st = self._agg.get(pid)
            if st is not None:
                st["late"] = []
                if st.get("sup_timer") is not None:
                    self.node.cancel_timer(st["sup_timer"])
                    st["sup_timer"] = None

    def _maybe_flush(self, pig_id: int) -> None:
        st = self._agg.get(pig_id)
        if st is None or st["done"]:
            return
        # group size = peers + the relay itself
        full = len(st["expect"]) + 1
        if len(st["voters"]) >= min(st["required"], full):
            self._flush(pig_id)

    def _flush(self, pig_id: int, timeout: bool = False, reject: bool = False) -> None:
        st = self._agg.get(pig_id)
        if st is None or st["done"]:
            return
        st["done"] = True
        if st["timer"] is not None:
            self.node.cancel_timer(st["timer"])
        replies: List[Msg] = st["replies"]
        oks = [r for r in replies if getattr(r, "ok", True)]
        rejects = [r for r in replies if not getattr(r, "ok", True)]
        missing = tuple(sorted((st["expect"] | {self.node.id}) - st["voters"]))
        proto = replies[0] if replies else None
        agg = PigAggregate(
            pig_id=pig_id,
            group=st["group"],
            ballot=getattr(proto, "ballot", (0, 0)),
            slot=getattr(proto, "slot", -1),
            acks=len(oks),
            voters=tuple(sorted(st["voters"])) if replies else (),
            missing=missing,
            timed_out=timeout,
            reject=bool(rejects) or reject,
            reject_ballot=max((getattr(r, "ballot", (0, 0)) for r in rejects),
                              default=(0, 0)),
        )
        # Phase-1 aggregation must carry the accepted-log bodies upward.
        p1 = [r for r in replies if isinstance(r, P1b)]
        if p1:
            agg = _RefP1Aggregate(agg, p1)
        self.node.send(st["leader"], agg)
        # keep the entry briefly so late votes become supplementary
        # aggregates (§4.1), then GC it
        st["replies"] = []
        self.node.set_timer(4 * self.cfg.relay_timeout,
                            lambda: self._agg.pop(pig_id, None))

    # ---------------------------------------------------------------- misc
    def note_commit(self, slot: int) -> None:
        pass


class _RefP1Aggregate(PigAggregate):
    """PigAggregate that additionally carries P1b bodies (value recovery)."""

    def __init__(self, base: PigAggregate, p1bs: List[P1b]):
        super().__init__(pig_id=base.pig_id, group=base.group,
                         ballot=base.ballot, slot=base.slot, acks=base.acks,
                         voters=base.voters, missing=base.missing,
                         timed_out=base.timed_out,
                         reject=base.reject, reject_ballot=base.reject_ballot)
        self.p1bs = p1bs

    @property
    def kind(self) -> str:  # dispatch as the base type
        return "PigAggregate"

    def wire_size(self) -> int:
        return super().wire_size() + sum(m.wire_size() for m in self.p1bs)


@dataclass
class _Slot:
    cmd: Command
    client_src: int = -1
    voters: set = field(default_factory=set)
    committed: bool = False
    pig_ids: list = field(default_factory=list)
    timer: Optional[int] = None
    retries: int = 0


class RefPaxosNode(RefNode):
    def __init__(self, node_id: int, net: Network, sched: Scheduler,
                 peers: list[int], pig: Optional[PigConfig] = None,
                 leader_timeout: float = 50e-3,
                 quorums: Optional["QuorumSystem"] = None):
        super().__init__(node_id, net, sched)
        self.peers = list(peers)
        self.n = len(peers)
        # flexible quorums (FPaxos, paper §7.1): Q1+Q2 > N; classic Paxos
        # uses majorities for both.  Pig composes with either (§7.1).
        self.quorums = quorums
        self.majority = quorums.q2 if quorums else majority(self.n)
        self.q1 = quorums.q1 if quorums else majority(self.n)
        self.comm = (RefPigComm(self, peers, pig) if pig is not None
                     else RefDirectComm(self, peers))
        self.leader_timeout = leader_timeout

        # acceptor state
        self.promised: tuple = (0, 0)
        self.accepted: Dict[int, tuple] = {}      # slot -> (ballot, cmd)
        # learner state
        self.committed: Dict[int, Command] = {}
        self.commit_index: int = -1               # contiguous applied prefix
        self._catching_up: set = set()
        # leader state
        self.ballot: tuple = (0, 0)
        self.is_leader = False
        self.next_slot: int = 0
        self.log: Dict[int, _Slot] = {}
        self._p1_voters: set = set()
        self._p1_accepted: Dict[int, tuple] = {}
        self._p1_timer: Optional[int] = None
        self._p1_max_ci: tuple = (-1, -1)
        # metrics
        self.committed_count = 0

    # ================================================================ leader
    def start_phase1(self) -> None:
        b = (max(self.promised[0], self.ballot[0]) + 1, self.id)
        self.ballot = b
        self.is_leader = False
        self._p1_voters = {self.id}
        self._p1_accepted = {s: v for s, v in self.accepted.items()
                             if s > self.commit_index}
        self._p1_max_ci = (-1, -1)
        self.promised = b
        self.comm.broadcast(lambda: P1a(ballot=b), round_key=("p1", b))
        self._p1_timer = self.set_timer(self.leader_timeout, self._p1_retry)

    def _p1_retry(self) -> None:
        if not self.is_leader and self.ballot[1] == self.id:
            self.start_phase1()

    def _ingest_p1(self, voter: int, msg: P1b) -> None:
        if self.is_leader or msg.ballot != self.ballot:
            if not msg.ok and msg.ballot > self.ballot:
                self._step_down(msg.ballot)
            return
        self._p1_voters.add(voter)
        ci = getattr(msg, "commit_index", -1)
        if ci > self._p1_max_ci[0]:
            self._p1_max_ci = (ci, voter)
        for s, (b, cmd) in msg.accepted.items():
            cur = self._p1_accepted.get(s)
            if cur is None or b > cur[0]:
                self._p1_accepted[s] = (b, cmd)
        if len(self._p1_voters) >= self.q1:
            self._become_leader()

    def _become_leader(self) -> None:
        self.is_leader = True
        if self._p1_timer is not None:
            self.cancel_timer(self._p1_timer)
        # catch up slots that a quorum already committed (they are pruned
        # from P1b.accepted, so they must be *learned*, not re-proposed)
        max_ci, ci_src = self._p1_max_ci
        if max_ci > self.commit_index and ci_src >= 0:
            self._learn_commit(max_ci, ci_src)
        # re-propose uncommitted values found during phase-1 (§2.1)
        slots = sorted(self._p1_accepted)
        for s in slots:
            _, cmd = self._p1_accepted[s]
            if s <= max(self.commit_index, max_ci) or s in self.log:
                continue
            self.next_slot = max(self.next_slot, s + 1)
            self._propose_at(s, cmd, client_src=-1)
        self.next_slot = max(self.next_slot, self.commit_index + 1,
                             max_ci + 1)

    def _step_down(self, higher: tuple) -> None:
        self.is_leader = False
        for e in self.log.values():
            if e.timer is not None:
                self.cancel_timer(e.timer)
        self.log.clear()

    # -------------------------------------------------------------- phase 2
    def on_ClientRequest(self, msg: ClientRequest) -> None:
        if not self.is_leader:
            self.send(msg.src, ClientReply(client_id=msg.cmd.client_id,
                                           seq=msg.cmd.seq, ok=False))
            return
        slot = self.next_slot
        self.next_slot += 1
        self._propose_at(slot, msg.cmd, client_src=msg.src)

    def _propose_at(self, slot: int, cmd: Command, client_src: int) -> None:
        entry = _Slot(cmd=cmd, client_src=client_src)
        entry.voters.add(self.id)
        self.log[slot] = entry
        # leader accepts locally
        self.accepted[slot] = (self.ballot, cmd)
        self._send_p2a(slot)

    def _send_p2a(self, slot: int) -> None:
        entry = self.log[slot]
        b, ci = self.ballot, self.commit_index

        def make() -> P2a:
            return P2a(ballot=b, slot=slot, cmd=entry.cmd, commit_index=ci)

        entry.pig_ids = self.comm.broadcast(make, round_key=slot) or []
        entry.timer = self.set_timer(self.leader_timeout,
                                     lambda: self._slot_timeout(slot))

    def _slot_timeout(self, slot: int) -> None:
        entry = self.log.get(slot)
        if entry is None or entry.committed or not self.is_leader:
            return
        # gray non-responsive relays, then retry with fresh random relays (§3.4)
        self.comm.on_round_timeout(entry.pig_ids)
        entry.retries += 1
        self._send_p2a(slot)

    def ingest_vote(self, ballot: tuple, slot: int, voter: int, ok: bool,
                    reject_ballot: tuple = (0, 0)) -> None:
        if not ok:
            if reject_ballot > self.ballot:
                self._step_down(reject_ballot)
            return
        if ballot != self.ballot or not self.is_leader:
            return
        entry = self.log.get(slot)
        if entry is None or entry.committed:
            return
        entry.voters.add(voter)   # set => duplicate votes counted once (§3.4)
        if len(entry.voters) >= self.majority:
            self._commit(slot)

    def _commit(self, slot: int) -> None:
        entry = self.log[slot]
        entry.committed = True
        if entry.timer is not None:
            self.cancel_timer(entry.timer)
        self.committed[slot] = entry.cmd
        self.committed_count += 1
        self._advance()

    def _advance(self) -> None:
        """Apply contiguously committed slots; reply to waiting clients."""
        while (self.commit_index + 1) in self.committed:
            s = self.commit_index + 1
            cmd = self.committed[s]
            val = self.store.apply(cmd)
            self.applied_log.append((s, cmd))
            self.commit_index = s
            e = self.log.get(s)
            if e is not None and e.client_src >= 0:
                self.send(e.client_src,
                          ClientReply(client_id=cmd.client_id, seq=cmd.seq,
                                      ok=True, value=val))

    def flush_commits(self) -> None:
        """Idle-time commit propagation (harness use; P3 is normally
        piggybacked on the next P2a)."""
        for p in self.peers:
            if p != self.id:
                self.send(p, P3(commit_index=self.commit_index))

    # ============================================================== acceptor
    def process_inner(self, msg: Msg):
        """Handle a (possibly relayed) leader message; return the reply."""
        if isinstance(msg, P2a):
            return self._accept(msg)
        if isinstance(msg, P1a):
            return self._promise(msg)
        if isinstance(msg, P3):
            self._learn_commit(msg.commit_index, msg.src)
            return None
        raise RuntimeError(f"unexpected inner {msg.kind}")

    def _accept(self, msg: P2a) -> P2b:
        if msg.ballot >= self.promised:
            self.promised = msg.ballot
            self.accepted[msg.slot] = (msg.ballot, msg.cmd)
            self._learn_commit(msg.commit_index, msg.src)
            r = P2b(ballot=msg.ballot, slot=msg.slot, ok=True)
        else:
            r = P2b(ballot=self.promised, slot=msg.slot, ok=False)
        r.src = self.id
        return r

    def _promise(self, msg: P1a) -> P1b:
        if msg.ballot > self.promised:
            self.promised = msg.ballot
            acc = {s: v for s, v in self.accepted.items()
                   if s > self.commit_index}
            r = P1b(ballot=msg.ballot, ok=True, accepted=acc,
                    commit_index=self.commit_index)
        else:
            r = P1b(ballot=self.promised, ok=False)
        r.src = self.id
        return r

    def _learn_commit(self, ci: int, leader_src: int) -> None:
        self.comm.note_committed_up_to(ci)
        while self.commit_index < ci:
            s = self.commit_index + 1
            if s in self.committed:
                cmd = self.committed[s]
            elif s in self.accepted:
                cmd = self.accepted[s][1]
            else:
                if s not in self._catching_up and leader_src >= 0:
                    self._catching_up.add(s)
                    self.send(leader_src, CatchUpReq(slots=(s,)))
                    # allow a re-request if the response gets lost
                    self.set_timer(2 * self.leader_timeout,
                                   lambda s=s: self._catching_up.discard(s))
                return
            self.committed.setdefault(s, cmd)
            self.store.apply(cmd)
            self.applied_log.append((s, cmd))
            self.commit_index = s

    def on_CatchUpReq(self, msg: CatchUpReq) -> None:
        ent = {s: self.committed[s] for s in msg.slots if s in self.committed}
        if ent:
            self.send(msg.src, CatchUpResp(entries=ent))

    def on_CatchUpResp(self, msg: CatchUpResp) -> None:
        for s, cmd in msg.entries.items():
            self.committed.setdefault(s, cmd)
            self._catching_up.discard(s)
        # replay contiguous applies
        while (self.commit_index + 1) in self.committed:
            s = self.commit_index + 1
            cmd = self.committed[s]
            self.store.apply(cmd)
            self.applied_log.append((s, cmd))
            self.commit_index = s

    # ====================================================== direct handlers
    def on_P2a(self, msg: P2a) -> None:
        self.send(msg.src, self._accept(msg))

    def on_P1a(self, msg: P1a) -> None:
        self.send(msg.src, self._promise(msg))

    def on_P3(self, msg: P3) -> None:
        self._learn_commit(msg.commit_index, msg.src)

    def on_P2b(self, msg: P2b) -> None:
        self.ingest_vote(msg.ballot, msg.slot, msg.src, msg.ok,
                         reject_ballot=msg.ballot)

    def on_P1b(self, msg: P1b) -> None:
        self._ingest_p1(msg.src, msg)

    # ========================================================= pig handlers
    def on_PigFanout(self, msg) -> None:
        self.comm.on_PigFanout(msg)

    def on_PigRelayed(self, msg) -> None:
        self.comm.on_PigRelayed(msg)

    def on_PigReply(self, msg) -> None:
        self.comm.on_PigReply(msg)

    def on_PigAggregate(self, msg: PigAggregate) -> None:
        self.comm.leader_handle_aggregate(msg)
        if isinstance(msg, _RefP1Aggregate):
            for p1b in msg.p1bs:
                self._ingest_p1(p1b.src, p1b)
            return
        if msg.reject:
            self.ingest_vote(msg.ballot, msg.slot, -1, False,
                             reject_ballot=msg.reject_ballot)
        for v in msg.voters:
            self.ingest_vote(msg.ballot, msg.slot, v, True)


@dataclass
class _Inst:
    cmd: Optional[Command] = None
    deps: frozenset = frozenset()
    seq: int = 0
    state: str = "none"       # none|preaccepted|accepted|committed|executed
    client_src: int = -1
    replies: list = field(default_factory=list)
    accept_acks: int = 0
    is_mine: bool = False


class RefEPaxosNode(RefNode):
    def __init__(self, node_id: int, net: Network, sched: Scheduler,
                 peers: list[int]):
        super().__init__(node_id, net, sched)
        self.peers = list(peers)
        self.n = len(peers)
        self.fq = fast_quorum(self.n)
        self.maj = majority(self.n)
        self.next_inum = 0
        self.insts: Dict[tuple, _Inst] = {}
        # per-key: latest interfering instance per replica (standard EPaxos
        # optimization: depend on the most recent conflict per replica)
        self.interf: Dict[int, Dict[int, tuple]] = {}
        self._pending_exec: list = []
        self.committed_count = 0

    # ---------------------------------------------------------------- leader
    def on_ClientRequest(self, msg: ClientRequest) -> None:
        cmd = msg.cmd
        inst_id = (self.id, self.next_inum)
        self.next_inum += 1
        deps = self._conflicts(cmd.key, exclude=inst_id)
        seq = 1 + max([self.insts[d].seq for d in deps], default=0)
        inst = _Inst(cmd=cmd, deps=deps, seq=seq, state="preaccepted",
                     client_src=msg.src, is_mine=True)
        self.insts[inst_id] = inst
        self._note_interf(cmd.key, inst_id)
        for p in self.peers:
            if p != self.id:
                self.send(p, PreAccept(inst=inst_id, cmd=cmd, deps=deps,
                                       seq=seq, n_cluster=self.n))

    def _conflicts(self, key: int, exclude: tuple) -> frozenset:
        m = self.interf.get(key)
        if not m:
            return frozenset()
        return frozenset(v for v in m.values() if v != exclude)

    def _note_interf(self, key: int, inst_id: tuple) -> None:
        self.interf.setdefault(key, {})[inst_id[0]] = inst_id

    # -------------------------------------------------------------- replicas
    def on_PreAccept(self, msg: PreAccept) -> None:
        local = self._conflicts(msg.cmd.key, exclude=msg.inst)
        deps = msg.deps | local
        seq = max(msg.seq, 1 + max([self.insts[d].seq for d in local
                                    if d in self.insts], default=0))
        inst = self.insts.setdefault(msg.inst, _Inst())
        if inst.state in ("committed", "executed"):
            return
        inst.cmd, inst.deps, inst.seq, inst.state = msg.cmd, deps, seq, "preaccepted"
        self._note_interf(msg.cmd.key, msg.inst)
        self.send(msg.src, PreAcceptReply(inst=msg.inst, ok=True, deps=deps,
                                          seq=seq, n_cluster=self.n))

    def on_PreAcceptReply(self, msg: PreAcceptReply) -> None:
        inst = self.insts.get(msg.inst)
        if inst is None or not inst.is_mine or inst.state != "preaccepted":
            return
        inst.replies.append(msg)
        if len(inst.replies) < self.fq - 1:
            return
        # fast path: fast quorum (incl. self) agrees on (deps, seq)
        if all(r.deps == inst.deps and r.seq == inst.seq for r in inst.replies):
            self._commit(msg.inst, inst)
        else:
            # slow path: union deps, max seq, Paxos-accept round
            for r in inst.replies:
                inst.deps = inst.deps | r.deps
                inst.seq = max(inst.seq, r.seq)
            inst.state = "accepted"
            inst.accept_acks = 1
            for p in self.peers:
                if p != self.id:
                    self.send(p, EAccept(inst=msg.inst, cmd=inst.cmd,
                                         deps=inst.deps, seq=inst.seq,
                                         n_cluster=self.n))

    def on_EAccept(self, msg: EAccept) -> None:
        inst = self.insts.setdefault(msg.inst, _Inst())
        if inst.state in ("committed", "executed"):
            return
        inst.cmd, inst.deps, inst.seq, inst.state = msg.cmd, msg.deps, msg.seq, "accepted"
        self._note_interf(msg.cmd.key, msg.inst)
        self.send(msg.src, EAcceptReply(inst=msg.inst, ok=True))

    def on_EAcceptReply(self, msg: EAcceptReply) -> None:
        inst = self.insts.get(msg.inst)
        if inst is None or not inst.is_mine or inst.state != "accepted":
            return
        inst.accept_acks += 1
        if inst.accept_acks >= self.maj:
            self._commit(msg.inst, inst)

    # ---------------------------------------------------------------- commit
    def _commit(self, inst_id: tuple, inst: _Inst) -> None:
        inst.state = "committed"
        self.committed_count += 1
        for p in self.peers:
            if p != self.id:
                self.send(p, ECommit(inst=inst_id, cmd=inst.cmd,
                                     deps=inst.deps, seq=inst.seq,
                                     n_cluster=self.n))
        self._pending_exec.append(inst_id)
        self._drain_exec()

    def on_ECommit(self, msg: ECommit) -> None:
        inst = self.insts.setdefault(msg.inst, _Inst())
        inst.cmd, inst.deps, inst.seq = msg.cmd, msg.deps, msg.seq
        if inst.state != "executed":
            inst.state = "committed"
        self._note_interf(msg.cmd.key, msg.inst)
        self._pending_exec.append(msg.inst)
        self._drain_exec()

    def _drain_exec(self) -> None:
        """Retry blocked instances until no more progress can be made."""
        progress = True
        while progress:
            progress = False
            still = []
            for iid in self._pending_exec:
                if self.insts[iid].state == "executed":
                    progress = True
                    continue
                if self._try_execute(iid):
                    progress = True
                else:
                    still.append(iid)
            self._pending_exec = still

    # --------------------------------------------------------------- execute
    def _try_execute(self, start: tuple) -> bool:
        """Execute committed instances: SCCs in dependency order, ties by
        (seq, instance id) — the EPaxos execution algorithm."""
        # Tarjan over committed subgraph reachable from ``start``
        sys_stack = [start]
        index: Dict[tuple, int] = {}
        low: Dict[tuple, int] = {}
        onstack: Dict[tuple, bool] = {}
        stack: list = []
        counter = [0]
        sccs: list = []
        blocked = [False]

        def strongconnect(v: tuple) -> None:
            work = [(v, iter(sorted(self.insts[v].deps)))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            onstack[v] = True
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    iw = self.insts.get(w)
                    if iw is None or iw.state in ("none", "preaccepted", "accepted"):
                        blocked[0] = True    # an uncommitted dep: defer
                        continue
                    if iw.state == "executed":
                        continue
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        onstack[w] = True
                        work.append((w, iter(sorted(self.insts[w].deps))))
                        advanced = True
                        break
                    elif onstack.get(w):
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        onstack[w] = False
                        scc.append(w)
                        if w == node:
                            break
                    sccs.append(scc)

        inst0 = self.insts.get(start)
        if inst0 is None or inst0.state != "committed":
            return inst0 is not None and inst0.state == "executed"
        strongconnect(start)
        if blocked[0]:
            return False   # retried by _drain_exec when the dep commits
        for scc in sccs:   # Tarjan emits SCCs in reverse topological order
            for iid in sorted(scc, key=lambda i: (self.insts[i].seq, i)):
                self._execute(iid)
        return True

    def _execute(self, inst_id: tuple) -> None:
        inst = self.insts[inst_id]
        if inst.state == "executed":
            return
        val = self.store.apply(inst.cmd)
        self.applied_log.append((inst_id, inst.cmd))
        inst.state = "executed"
        if inst.is_mine and inst.client_src >= 0:
            self.send(inst.client_src,
                      ClientReply(client_id=inst.cmd.client_id,
                                  seq=inst.cmd.seq, ok=True, value=val))
