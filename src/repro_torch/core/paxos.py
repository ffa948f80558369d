"""Multi-Paxos with a pluggable communication layer.

The consensus core below is *identical* for Paxos and PigPaxos — only the
``comm`` strategy object differs (DirectComm vs PigComm), mirroring the
paper's central claim (§3.3) that Pig modifies only the communication
implementation and therefore inherits Paxos's safety/liveness proofs.

Multi-Paxos specifics implemented (§2.1):
  * phase-1 once per leadership, subsequent instances go straight to phase-2;
  * phase-3 (commit) piggybacked on the next phase-2 via ``commit_index``;
  * pipelined slots (multiple outstanding instances);
  * duplicate-vote suppression at the leader (voter-id sets, §3.4);
  * leader retry with fresh relays on timeout (§3.4);
  * catch-up path for followers that miss a slot body.

Copied from ``repro.core.paxos``; the port's tests hold it to the
reference's run, event for event.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .events import Scheduler
from .messages import (BatchCmd, ClientReply, ClientRequest, Command, JoinReq,
                       LeaseAck, LeaseGrant, Msg, P1a, P1b, P2a, P2b, P3,
                       PigAggregate, ReadProbe, ReadReply, Snapshot)
from .network import Network
from .node import Node
from .pig import DirectComm, PigComm, PigConfig, _P1Aggregate
from .quorums import QuorumSystem, majority


@dataclass(slots=True)
class CatchUpReq(Msg):
    slots: tuple = ()


@dataclass(slots=True)
class CatchUpResp(Msg):
    entries: dict = field(default_factory=dict)   # slot -> Command

    def wire_size(self) -> int:
        return 24 + sum(16 + c.wire_size() for c in self.entries.values())


@dataclass(frozen=True)
class BatchConfig:
    """Leader-side request batching (HT-Paxos-style ordering-stage batching).

    The leader buffers incoming client commands and packs up to
    ``max_batch`` of them into ONE slot (one phase-2 fan-out/fan-in — and
    one Pig relay round — amortized across the batch).  A partial buffer
    flushes after ``max_delay_ms``.  ``max_batch=1`` is byte-identical to
    the unbatched engine: the buffer flushes on the first enqueue, arms no
    timer, and proposes the bare command (no BatchCmd envelope).
    """
    max_batch: int = 8
    max_delay_ms: float = 1.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")


@dataclass(frozen=True)
class LeaseConfig:
    """Leader leases for linearizable local reads (Spinnaker-style).

    A quorum of ``LeaseAck``s lets the leader answer ``get`` requests from
    its own store for ``duration_ms`` — measured on each node's LOCAL clock,
    which drifts at an unknown per-node rate bounded by ``drift_bound``
    (|rate error| <= drift_bound, e.g. 1e-4 = 100 ppm).  Followers holding
    an unexpired lease promise withhold their phase-1 vote from any OTHER
    candidate, so a new leader cannot be elected until the lease drains.

    Safety under drift: the leader only believes the lease for
    ``duration * (1 - 2*drift_bound)`` of its own clock, which is provably
    inside every follower's promise window for any rates within the bound
    ((1-2b)(1+b) <= 1-b).  ``lease_safety=False`` drops that margin — the
    deliberately-broken control: under adversarial drift the leader keeps
    serving reads after a quorum of promises has really expired, and the
    linearizability auditor must flag the resulting stale reads.
    """
    duration_ms: float = 200.0
    renew_ms: Optional[float] = None     # default: duration_ms / 3
    drift_bound: float = 1e-4
    lease_safety: bool = True

    def __post_init__(self):
        if self.duration_ms <= 0:
            raise ValueError("lease duration_ms must be > 0")
        if self.renew_ms is not None and not (0 < self.renew_ms <= self.duration_ms):
            raise ValueError("lease renew_ms must be in (0, duration_ms]")
        if not (0.0 <= self.drift_bound < 0.4):
            raise ValueError("drift_bound must be in [0, 0.4) — the safety "
                             "margin 1 - 2*drift_bound must stay positive")

    @property
    def duration_s(self) -> float:
        return self.duration_ms * 1e-3

    @property
    def renew_s(self) -> float:
        r = self.renew_ms if self.renew_ms is not None else self.duration_ms / 3.0
        return r * 1e-3


@dataclass
class _Slot:
    cmd: Command
    client_src: int = -1
    voters: set = field(default_factory=set)
    committed: bool = False
    pig_ids: list = field(default_factory=list)
    timer: Optional[int] = None
    retries: int = 0
    # batching/pipelining extensions (None/False on the unbatched path)
    client_srcs: Optional[tuple] = None   # per-sub-command reply routing
    gated: bool = False                   # counted against pipeline_depth
    # observability: trace ctx of the op that caused this slot (None when
    # untraced).  Carried so timer-driven re-proposals and the commit-time
    # client reply rejoin the op's span tree (repro.obs).
    trace: Optional[tuple] = None


class PaxosNode(Node):
    def __init__(self, node_id: int, net: Network, sched: Scheduler,
                 peers: list[int], pig: Optional[PigConfig] = None,
                 leader_timeout: float = 50e-3,
                 quorums: Optional["QuorumSystem"] = None,
                 batch: Optional[BatchConfig] = None,
                 pipeline_depth: int = 0,
                 lease: Optional[LeaseConfig] = None,
                 clock_rate: float = 0.0, clock_offset: float = 0.0):
        super().__init__(node_id, net, sched)
        self.peers = list(peers)
        self.n = len(peers)
        # flexible quorums (FPaxos, paper §7.1): Q1+Q2 > N; classic Paxos
        # uses majorities for both.  Pig composes with either (§7.1).
        self.quorums = quorums
        self.majority = quorums.q2 if quorums else majority(self.n)
        self.q1 = quorums.q1 if quorums else majority(self.n)
        self.comm = (PigComm(self, peers, pig) if pig is not None
                     else DirectComm(self, peers))
        if pig is not None:
            # bind relay-path handlers directly (instance attrs shadow the
            # delegating methods below — saves a frame on ~60% of hops)
            self.on_PigFanout = self.comm.on_PigFanout
            self.on_PigRelayed = self.comm.on_PigRelayed
            self.on_PigReply = self.comm.on_PigReply
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
        # leader-side batching + slot pipelining.  pipeline_depth == 0 is
        # "unbounded" — the seed engine's native behavior (every request
        # proposes immediately); depth k > 0 throttles to k uncommitted
        # gated slots, queueing sealed batches in _held until a commit
        # frees a pipeline stage.
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self.batch = batch
        self.pipeline_depth = pipeline_depth
        self._batching = batch is not None or pipeline_depth > 0
        self._buf: list = []            # (cmd, client_src) awaiting a slot
        self._buf_timer: Optional[int] = None
        self._held: list = []           # sealed batches awaiting pipeline room
        self._inflight = 0              # gated slots proposed, not committed
        self._p1_voters: set = set()
        self._p1_accepted: Dict[int, tuple] = {}
        self._p1_timer: Optional[int] = None
        self._p1_max_ci: tuple = (-1, -1)
        # at-most-once session state: client_id -> (last applied seq, result).
        # Client request-timeout retries re-send the same (client_id, seq),
        # which can legitimately get proposed in two slots (e.g. the original
        # commits via post-crash value recovery after the retry was already
        # proposed); the duplicate is skipped at apply time — identically on
        # every replica, since the decision depends only on the shared log
        # prefix — and answered from the cached result.
        self._session: Dict[int, tuple] = {}
        # membership state (single-server reconfiguration, Raft-style):
        # ``members`` is the replica set this node believes is in force;
        # configuration commands ride the normal log and activate at apply
        # time, which is safe for single-server changes because any old and
        # new majority intersect.  A ``joining`` learner accepts state but
        # never votes; a ``removed`` node stops voting permanently.
        self.members: list = sorted(peers)
        self.joining = False
        self.removed = False
        self._cfg_inflight: Optional[int] = None   # slot of the pending cfg cmd
        self._cfg_seq = 0
        self._learners: set = set()     # joiners fed P2a directly, pre-membership
        self._leader_ref: Optional[Callable[[], int]] = None
        self._join_catch_up = True
        self._snap_installed = False
        # cluster-level hooks (no protocol semantics; used by Cluster to track
        # the current leader / membership view for client routing and audits)
        self.on_became_leader: Optional[Callable] = None
        self.on_membership_change: Optional[Callable] = None
        # ---- read paths: leader leases + per-key commit frontiers ----
        # each node owns a drifting local clock: local = (1+rate)*t + offset.
        # All lease comparisons are elapsed-local (offsets cancel); the rate
        # term is what makes an unsafe lease margin a REAL stale-read hazard.
        self.lease = lease
        self.clock_rate = clock_rate
        self.clock_offset = clock_offset
        self._lease_seq = 0                       # leader: renewal counter
        self._lease_acks: Dict[int, set] = {}     # lseq -> acked node ids
        self._lease_sent_local: Dict[int, float] = {}
        self._lease_held_until_local = float("-inf")
        self._lease_timer: Optional[int] = None
        self._lease_promise: Optional[tuple] = None  # (holder, expiry_local)
        # per-key frontiers for quorum reads: applied = (slot, wtag) of the
        # latest locally-applied put; accepted = highest slot that MIGHT
        # hold a put to the key (accepted-but-unapplied included)
        self._applied_frontier: Dict[int, tuple] = {}
        self._accepted_frontier: Dict[int, int] = {}
        # metrics
        self.committed_count = 0
        self.lease_reads = 0

    # ================================================================ leader
    def start_phase1(self) -> None:
        if self.joining or self.removed:
            return      # non-members never campaign
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
        if self._batching:
            # buffered commands are volatile leader state: a crash lost them
            # (clients retry; session dedup absorbs duplicates), and surviving
            # log entries re-arm ungated — recovery correctness outranks the
            # pipeline throttle for one round
            self._drop_buffers(bounce=False)
            for e in self.log.values():
                e.gated = False
        # catch up slots that a quorum already committed (they are pruned
        # from P1b.accepted, so they must be *learned*, not re-proposed)
        max_ci, ci_src = self._p1_max_ci
        if max_ci > self.commit_index and ci_src >= 0:
            self._learn_commit(max_ci, ci_src)
        # re-propose uncommitted values found during phase-1 (§2.1)
        pre_existing = sorted(self.log)   # local proposals surviving a crash
        slots = sorted(self._p1_accepted)
        for s in slots:
            _, cmd = self._p1_accepted[s]
            if s <= max(self.commit_index, max_ci) or s in self.log:
                continue
            self.next_slot = max(self.next_slot, s + 1)
            self._propose_at(s, cmd, client_src=-1)
        self.next_slot = max(self.next_slot, self.commit_index + 1,
                             max_ci + 1)
        # re-arm uncommitted local proposals that survived a crash-recover:
        # their slot timers died with the crash (set_timer suppresses fires
        # on crashed nodes) and the phase-1 recovery above deliberately
        # skips slots still present in self.log — without this, an in-flight
        # slot at crash time would stall the contiguous-apply prefix forever.
        # Only PRE-EXISTING entries re-arm (slots the recovery loop just
        # proposed already broadcast); first-time elections have an empty
        # log, so this is a no-op there.
        for s in pre_existing:
            entry = self.log[s]
            if entry.committed or s <= self.commit_index:
                continue
            if entry.timer is not None:    # pre-crash timer may still pend
                self.cancel_timer(entry.timer)
            entry.voters = {self.id}       # stale-ballot votes don't count
            self.accepted[s] = (self.ballot, entry.cmd)
            self._send_p2a(s)
        if self.lease is not None:
            self._lease_renew()
        cb = self.on_became_leader
        if cb is not None:
            cb(self)

    # ================================================================ leases
    def local_now(self) -> float:
        """This node's drifting local clock (lease math only — timers and
        the network stay on simulated real time)."""
        return (1.0 + self.clock_rate) * self.sched.now + self.clock_offset

    def lease_held(self) -> bool:
        return self.local_now() < self._lease_held_until_local

    def _lease_renew(self) -> None:
        if not self.is_leader or self.lease is None or self.crashed:
            return
        lz = self.lease
        self._lease_seq += 1
        lseq = self._lease_seq
        # the grant-SEND instant anchors the belief window: it precedes
        # every follower's receipt, so leader-elapsed >= follower-elapsed
        # modulo drift (which the margin covers)
        self._lease_sent_local[lseq] = self.local_now()
        self._lease_acks[lseq] = {self.id}       # self-ack: own promise
        stale = [q for q in self._lease_acks if q < lseq - 8]
        for q in stale:
            self._lease_acks.pop(q, None)
            self._lease_sent_local.pop(q, None)
        m = LeaseGrant(ballot=self.ballot, lseq=lseq, duration=lz.duration_s)
        for p in self.members:
            if p != self.id:
                self.send(p, m)
        self._lease_timer = self.set_timer(lz.renew_s, self._lease_renew)

    def on_LeaseGrant(self, msg: LeaseGrant) -> None:
        if self.joining or self.removed:
            return
        if msg.ballot < self.promised:
            return        # a newer leader exists: never re-arm an old lease
        holder = msg.ballot[1]
        now_l = self.local_now()
        pr = self._lease_promise
        if pr is not None and pr[0] != holder and pr[1] > now_l:
            return        # conflicting unexpired promise: refuse silently
        # promise duration runs on THIS node's clock from receipt
        self._lease_promise = (holder, now_l + msg.duration)
        self.send(msg.src, LeaseAck(ballot=msg.ballot, lseq=msg.lseq))

    def on_LeaseAck(self, msg: LeaseAck) -> None:
        if not self.is_leader or msg.ballot != self.ballot:
            return
        acks = self._lease_acks.get(msg.lseq)
        if acks is None:
            return
        acks.add(msg.src)
        if len(acks) >= self.majority:
            sent = self._lease_sent_local.get(msg.lseq)
            if sent is None:
                return
            lz = self.lease
            # the safety margin: believe only (1 - 2b) of the granted
            # duration (measured on our clock) — see LeaseConfig docstring.
            # lease_safety=False is the checkable broken control.
            margin = (1.0 - 2.0 * lz.drift_bound) if lz.lease_safety else 1.0
            until = sent + lz.duration_s * margin
            if until > self._lease_held_until_local:
                self._lease_held_until_local = until

    def _lease_clear(self) -> None:
        self._lease_held_until_local = float("-inf")
        self._lease_acks.clear()
        self._lease_sent_local.clear()
        if self._lease_timer is not None:
            self.cancel_timer(self._lease_timer)
            self._lease_timer = None

    # ========================================================== quorum reads
    def on_ReadProbe(self, msg: ReadProbe) -> None:
        key = msg.key
        ap = self._applied_frontier.get(key)
        acc = self._accepted_frontier.get(key, -1)
        applied = ap[0] if ap is not None else -1
        self.send(msg.src, ReadReply(
            rid=msg.rid, key=key, applied=applied,
            accepted=max(acc, applied),
            value=self.store.data.get(key),
            wtag=ap[1] if ap is not None else None))

    def _note_accepted(self, slot: int, cmd: Command) -> None:
        if cmd.__class__ is BatchCmd:
            fr = self._accepted_frontier
            for c in cmd.cmds:
                if c.op == "put" and slot > fr.get(c.key, -1):
                    fr[c.key] = slot
        elif cmd.op == "put":
            fr = self._accepted_frontier
            if slot > fr.get(cmd.key, -1):
                fr[cmd.key] = slot

    def _step_down(self, higher: tuple) -> None:
        self.is_leader = False
        self._lease_clear()
        self._cfg_inflight = None      # a pending cfg cmd is the new leader's
        for e in self.log.values():
            if e.timer is not None:
                self.cancel_timer(e.timer)
        self.log.clear()
        if self._batching:
            self._drop_buffers(bounce=True)

    def _drop_buffers(self, bounce: bool) -> None:
        """Clear the batching buffers.  ``bounce=True`` (step-down) answers
        each buffered client ok=False — the same fast not-leader bounce an
        unbatched follower sends — so clients re-route without waiting out
        their request timeout."""
        if self._buf_timer is not None:
            self.cancel_timer(self._buf_timer)
            self._buf_timer = None
        pending = self._buf + [p for b in self._held for p in b]
        self._buf = []
        self._held = []
        self._inflight = 0
        if bounce:
            for cmd, src in pending:
                if src >= 0:
                    self.send(src, ClientReply(client_id=cmd.client_id,
                                               seq=cmd.seq, ok=False))

    # -------------------------------------------------------------- phase 2
    def on_ClientRequest(self, msg: ClientRequest) -> None:
        if not self.is_leader:
            self.send(msg.src, ClientReply(client_id=msg.cmd.client_id,
                                           seq=msg.cmd.seq, ok=False))
            return
        cmd = msg.cmd
        if (self.lease is not None and cmd.op == "get"
                and self.local_now() < self._lease_held_until_local):
            # leased local read: the store reflects every write this leader
            # has acked (acks happen at apply), and the lease promise quorum
            # blocks any other leader from committing writes we can't see —
            # no slot, no fan-out, no round trip.  Linearizable iff the
            # belief window really is inside the promise windows (the
            # drift-margin argument in LeaseConfig).
            self.lease_reads += 1
            self.send(msg.src, ClientReply(client_id=cmd.client_id,
                                           seq=cmd.seq, ok=True,
                                           value=self.store.data.get(cmd.key),
                                           path="lease"))
            return
        if self._batching:
            self._enqueue(msg.cmd, msg.src)
            return
        slot = self.next_slot
        self.next_slot += 1
        self._propose_at(slot, msg.cmd, client_src=msg.src)

    # ------------------------------------------------ batching + pipelining
    def _enqueue(self, cmd: Command, client_src: int) -> None:
        self._buf.append((cmd, client_src))
        b = self.batch
        if b is None or len(self._buf) >= b.max_batch:
            self._flush_buf()
        elif self._buf_timer is None:
            self._buf_timer = self.set_timer(b.max_delay_ms * 1e-3,
                                             self._buf_timeout)

    def _buf_timeout(self) -> None:
        self._buf_timer = None
        self._flush_buf()

    def _flush_buf(self) -> None:
        if self._buf_timer is not None:
            self.cancel_timer(self._buf_timer)
            self._buf_timer = None
        if not self._buf:
            return
        buf = self._buf
        self._buf = []
        d = self.pipeline_depth
        if d > 0 and self._inflight >= d:
            self._held.append(buf)     # pipeline full: hold the sealed batch
            return
        self._propose_batch(buf)

    def _propose_batch(self, buf: list) -> None:
        slot = self.next_slot
        self.next_slot += 1
        gated = self.pipeline_depth > 0
        if gated:
            self._inflight += 1
        if len(buf) == 1:
            # size-1 batch proposes the bare command: identical wire bytes,
            # replies, and session state to the unbatched engine
            cmd, src = buf[0]
            self._propose_at(slot, cmd, client_src=src)
        else:
            self._propose_at(slot, BatchCmd(cmds=tuple(c for c, _ in buf)),
                             client_src=-1,
                             client_srcs=tuple(s for _, s in buf))
        if gated:
            self.log[slot].gated = True

    def _release_held(self) -> None:
        d = self.pipeline_depth
        while self._held and (d <= 0 or self._inflight < d):
            self._propose_batch(self._held.pop(0))

    def _propose_at(self, slot: int, cmd: Command, client_src: int,
                    client_srcs: Optional[tuple] = None) -> None:
        entry = _Slot(cmd=cmd, client_src=client_src, client_srcs=client_srcs)
        entry.voters.add(self.id)
        tr = self.net.tracer
        if tr is not None:
            # the ambient ctx (the ClientRequest hop that proposed, when
            # message-driven; None from batch-flush/retry timers)
            entry.trace = tr.cur
        self.log[slot] = entry
        # leader accepts locally
        self.accepted[slot] = (self.ballot, cmd)
        self._note_accepted(slot, cmd)
        self._send_p2a(slot)

    def _send_p2a(self, slot: int) -> None:
        entry = self.log[slot]
        b, ci = self.ballot, self.commit_index

        def make() -> P2a:
            return P2a(ballot=b, slot=slot, cmd=entry.cmd, commit_index=ci)

        tr = self.net.tracer
        if tr is not None and entry.trace is not None:
            # re-establish the op's ctx so timer-driven re-proposals (slot
            # timeout retries) broadcast hops that rejoin its span tree
            prev = tr.cur
            tr.cur = entry.trace
            entry.pig_ids = self.comm.broadcast(make, round_key=slot) or []
            tr.cur = prev
        else:
            entry.pig_ids = self.comm.broadcast(make, round_key=slot) or []
        if self._learners:
            # joining learners are outside the comm's member set: feed them
            # the P2a directly so they follow the log (they never vote)
            m = make()
            for lid in self._learners:
                self.send(lid, m)
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
        if entry.gated:
            entry.gated = False
            self._inflight -= 1
            if self._held:
                self._release_held()
        self._advance()

    def _apply_slot(self, s: int, cmd: Command) -> tuple:
        """Apply one contiguously-committed slot with at-most-once session
        dedup.  THE single apply path — every caller (_advance,
        _learn_commit, on_CatchUpResp) must go through it, because the
        auditor's replica-agreement check relies on all replicas making
        byte-identical apply/skip decisions over the shared log prefix.

        Returns ``(ack, val)``: ``ack`` is True when a waiting client
        should be answered with ``val`` — either a fresh apply or an exact
        duplicate (timeout retry) answered from the session cache; a stale
        duplicate (seq below the session high-water mark) gets neither an
        apply nor a reply.

        A ``BatchCmd`` applies its sub-commands in order, each through the
        same dedup logic (identical skip decisions on every replica); the
        return value is then ``(True, [(ack, val), ...])`` — one pair per
        sub-command, in batch order."""
        if cmd.__class__ is BatchCmd:
            return True, [self._apply_slot(s, c) for c in cmd.cmds]
        sess = self._session.get(cmd.client_id)
        if sess is not None and cmd.seq <= sess[0]:
            if cmd.seq == sess[0]:
                return True, sess[1]       # duplicate: cached result
            return False, None             # stale duplicate: drop
        store = self.store                 # inline KVStore.apply (hot path)
        store.applied_ops += 1
        if cmd.op == "put":
            store.data[cmd.key] = cmd.value
            self._applied_frontier[cmd.key] = (s, (cmd.client_id, cmd.seq))
            val = None
        elif cmd.op == "get":
            val = store.data.get(cmd.key)
        else:
            val = None                     # configuration command
            self._apply_membership(cmd)
        self._session[cmd.client_id] = (cmd.seq, val)
        self.applied_log.append((s, cmd))
        return True, val

    def _advance(self) -> None:
        """Apply contiguously committed slots; reply to waiting clients."""
        while (self.commit_index + 1) in self.committed:
            s = self.commit_index + 1
            cmd = self.committed[s]
            self.commit_index = s
            ack, val = self._apply_slot(s, cmd)
            e = self.log.get(s)
            if e is None:
                continue
            tr = self.net.tracer
            if cmd.__class__ is BatchCmd:
                srcs = e.client_srcs
                if srcs:    # None after crash-recovery re-propose: no replies
                    owner = (tr.meta[e.trace[0]]["client"]
                             if tr is not None and e.trace is not None
                             else -1)
                    for c, src, (a, v) in zip(cmd.cmds, srcs, val):
                        if a and src >= 0:
                            reply = ClientReply(client_id=c.client_id,
                                                seq=c.seq, ok=True, value=v)
                            if src == owner:
                                # only the slot-owning op's reply rejoins
                                # its span tree (the batch shares one ctx)
                                tr.attach(reply, e.trace)
                            self.send(src, reply)
            elif ack and e.client_src >= 0:
                reply = ClientReply(client_id=cmd.client_id, seq=cmd.seq,
                                    ok=True, value=val)
                if tr is not None and e.trace is not None:
                    tr.attach(reply, e.trace)
                self.send(e.client_src, reply)

    # ===================================================== membership change
    def propose_reconfig(self, op: str, nid: int) -> bool:
        """Propose a single-server membership change (``add_node`` /
        ``remove_node``) through the normal log.  At most ONE configuration
        command may be in flight at a time — the Raft one-at-a-time
        invariant that keeps every old/new majority pair intersecting.
        Returns False (caller retries later) when this node is not the
        leader, a cfg command is already pending, or the change is a no-op.
        """
        if (not self.is_leader or self.removed
                or self._cfg_inflight is not None):
            return False
        if (op == "add_node") == (nid in self.members):
            return False                   # no-op change
        self._cfg_seq += 1
        # negative client ids keep cfg commands out of the client session
        # space; the session table still dedups re-proposed cfg commands
        cmd = Command(client_id=-(self.id + 1), seq=self._cfg_seq,
                      op=op, key=nid)
        slot = self.next_slot
        self.next_slot += 1
        self._cfg_inflight = slot
        self._propose_at(slot, cmd, client_src=-1)
        return True

    def _apply_membership(self, cmd: Command) -> None:
        """Activate a committed configuration command.  Runs on every
        replica at apply time (the single shared apply path), so all members
        switch configurations at the same log position."""
        nid = cmd.key
        members = self.members
        changed = False
        if cmd.op == "add_node":
            if nid not in members:
                members.append(nid)
                members.sort()
                changed = True
            if nid == self.id:
                self.joining = False       # promoted from learner to member
        elif cmd.op == "remove_node":
            if nid in members:
                members.remove(nid)
                changed = True
        else:
            raise RuntimeError(f"unknown configuration op {cmd.op!r}")
        # one-at-a-time: the cfg command being applied IS the pending one
        self._cfg_inflight = None
        if not changed:
            return
        self._refresh_membership()
        if cmd.op == "remove_node":
            self._learners.discard(nid)
            if nid == self.id:
                self.removed = True
                if self.is_leader:
                    self._step_down(self.ballot)
        cb = self.on_membership_change
        if cb is not None:
            cb(self, cmd.op, nid)

    def _refresh_membership(self) -> None:
        """Re-derive quorum sizes and the comm topology from ``members`` —
        for PigComm this re-partitions the relay groups (stale cached
        partitions are dropped; in-flight rounds finish under the leader's
        timeout/retry path)."""
        self.peers = list(self.members)
        self.n = len(self.peers)
        q = self.quorums
        self.majority = q.q2 if q else majority(self.n)
        self.q1 = q.q1 if q else majority(self.n)
        self.comm.set_members(self.peers)

    def begin_join(self, leader_ref: Callable[[], int],
                   catch_up: bool = True) -> None:
        """Start the learner protocol: ask the leader for a state snapshot,
        then follow the log (via the direct learner P2a feed + the normal
        commit_index/CatchUp suffix path) WITHOUT voting until the
        ``add_node`` command naming this node is applied.  ``catch_up=False``
        is the deliberately-broken control for the auditor tests: the joiner
        skips the snapshot state and serves from an empty store."""
        self.joining = True
        self._leader_ref = leader_ref
        self._join_catch_up = catch_up
        self._snap_installed = False
        self._send_join()

    def _send_join(self) -> None:
        if not self.joining or self.crashed:
            return
        self.send(self._leader_ref(), JoinReq(node=self.id))
        # retried against the (possibly new) leader until membership lands
        self.set_timer(4 * self.leader_timeout, self._send_join)

    def on_JoinReq(self, msg: JoinReq) -> None:
        if not self.is_leader:
            return                         # joiner retries on its timer
        nid = msg.node
        self._learners.add(nid)
        self.send(nid, Snapshot(commit_index=self.commit_index,
                                store=dict(self.store.data),
                                session=dict(self._session),
                                members=tuple(self.members)))
        if nid not in self.members:
            self.propose_reconfig("add_node", nid)

    def on_Snapshot(self, msg: Snapshot) -> None:
        if not self.joining or self._snap_installed:
            return                         # only the first snapshot installs
        self._snap_installed = True
        if self._join_catch_up:
            self.store.data = dict(msg.store)
            self._session = dict(msg.session)
        # state below the snapshot point arrives as *state*, not log: the
        # applied log restarts here (the auditor checks joiner logs as a
        # contiguous infix of the witness order)
        self.applied_log = []
        self.committed = {}
        self.accepted = {s: v for s, v in self.accepted.items()
                         if s > msg.commit_index}
        self.commit_index = max(self.commit_index, msg.commit_index)
        self.members = sorted(msg.members)
        self._refresh_membership()

    # ============================================================== recovery
    def recover(self) -> None:
        """Node recovery with protocol semantics (the base class only clears
        the crashed flag).  A recovered follower needs nothing — it catches
        up through the commit_index piggybacked on later traffic.  A
        recovered *leader* (the owner of the current ballot) must re-run
        phase 1 with a fresh ballot: all its timers died while it was down
        (``set_timer`` suppresses fires on crashed nodes), so without a
        re-election every slot that was in flight at crash time — and hence
        the contiguous-apply prefix — would stall forever.  ``_become_leader``
        then re-proposes both phase-1-recovered values and the surviving
        local log entries (client reply routing intact)."""
        if not self.crashed:
            return
        super().recover()
        # a CatchUpReq outstanding at crash time is lost (its response was
        # dropped and the discard timer was suppressed while down): forget
        # it so _learn_commit re-requests instead of wedging at that slot
        self._catching_up.clear()
        # the lease BELIEF is volatile (a restarted leader must re-acquire
        # before serving local reads); the lease PROMISE survives — the
        # conservative direction, a restarted follower keeps withholding
        self._lease_clear()
        if self.ballot[1] == self.id and not self.removed:
            self.is_leader = False
            self.start_phase1()

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

    def _accept(self, msg: P2a) -> Optional[P2b]:
        if msg.ballot >= self.promised:
            self.promised = msg.ballot
            self.accepted[msg.slot] = (msg.ballot, msg.cmd)
            self._note_accepted(msg.slot, msg.cmd)
            self._learn_commit(msg.commit_index, msg.src)
            if self.joining or self.removed:
                return None    # learners/removed nodes follow but never vote
            r = P2b(ballot=msg.ballot, slot=msg.slot, ok=True)
        else:
            if self.joining or self.removed:
                return None
            r = P2b(ballot=self.promised, slot=msg.slot, ok=False)
        r.src = self.id
        return r

    def _promise(self, msg: P1a) -> Optional[P1b]:
        if self.joining or self.removed:
            return None        # non-members don't vote in elections either
        pr = self._lease_promise
        if (pr is not None and pr[0] != msg.ballot[1]
                and pr[1] > self.local_now()):
            # lease promise in force for another node: withhold the vote
            # entirely (the candidate re-campaigns on its leader timeout),
            # so a new leader is blocked until the lease drains — the
            # availability price of leased reads, measured by the `lease`
            # scenario family
            return None
        if msg.ballot > self.promised:
            if self.is_leader:
                # a live leader yielding to a higher ballot (planned handoff
                # via replace_leader, or a competing campaign): step down so
                # in-flight slots fail over to the new leader's phase-1
                self._step_down(msg.ballot)
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
        comm = self.comm
        if comm._pending_sup:       # no-op unless supplements are pending
            comm.note_committed_up_to(ci)
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
            self.commit_index = s
            self._apply_slot(s, cmd)

    def on_CatchUpReq(self, msg: CatchUpReq) -> None:
        ent = {s: self.committed[s] for s in msg.slots if s in self.committed}
        if ent:
            self.send(msg.src, CatchUpResp(entries=ent))

    def on_CatchUpResp(self, msg: CatchUpResp) -> None:
        for s, cmd in msg.entries.items():
            self.committed.setdefault(s, cmd)
            self._catching_up.discard(s)
        # replay contiguous applies (shared apply path: caught-up replicas
        # make identical apply decisions)
        while (self.commit_index + 1) in self.committed:
            s = self.commit_index + 1
            cmd = self.committed[s]
            self.commit_index = s
            self._apply_slot(s, cmd)

    # ====================================================== direct handlers
    def on_P2a(self, msg: P2a) -> None:
        r = self._accept(msg)
        if r is not None:       # None => non-voting learner/removed node
            self.send(msg.src, r)

    def on_P1a(self, msg: P1a) -> None:
        r = self._promise(msg)
        if r is not None:
            self.send(msg.src, r)

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
        if isinstance(msg, _P1Aggregate):
            for p1b in msg.p1bs:
                self._ingest_p1(p1b.src, p1b)
            return
        if msg.reject:
            self.ingest_vote(msg.ballot, msg.slot, -1, False,
                             reject_ballot=msg.reject_ballot)
        # batch-ingest the ok votes (same guards as ingest_vote, hoisted out
        # of the per-voter loop; set.update dedups exactly like repeated .add)
        voters = msg.voters
        if not voters or msg.ballot != self.ballot or not self.is_leader:
            return
        entry = self.log.get(msg.slot)
        if entry is None or entry.committed:
            return
        entry.voters.update(voters)
        if len(entry.voters) >= self.majority:
            self._commit(msg.slot)
