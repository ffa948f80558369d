"""Egalitarian Paxos (EPaxos) — the paper's strongest baseline (§5, §7.2).

Implemented faithfully enough for the paper's comparison:
  * every node is an opportunistic command leader (clients pick a random node);
  * PreAccept to the other replicas; fast-path commit when a fast quorum
    (3N/4, §5.3) returns identical (deps, seq); slow path runs an Accept
    round with a majority;
  * dependency tracking per key; commit before execute; execution orders
    strongly-connected components by sequence number;
  * message sizes grow with N (dependency bookkeeping), reproducing the
    paper's observation that 25-node EPaxos messages serialize ~4x slower
    than 5-node ones (§5.3) — see messages.CostModel.

Copied from ``repro.core.epaxos``; the port's tests hold it to the
reference's run, event for event.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .events import Scheduler
from .messages import (BatchCmd, ClientReply, ClientRequest, Command, EAccept,
                       EAcceptReply, ECommit, EPrepare, EPrepareReply,
                       JoinReq, PreAccept, PreAcceptReply, ReadProbe,
                       ReadReply, Snapshot)
from .network import Network
from .node import Node
from .paxos import BatchConfig
from .quorums import fast_quorum, majority


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
    # explicit-prepare recovery: ballot the current attributes were
    # (pre-)accepted at, and the highest ballot promised for this instance.
    # The original command leader proposes at (0, 0); recovery ballots are
    # (epoch >= 1, recoverer_id), so they always win comparisons.
    ballot: tuple = (0, 0)
    max_ballot: tuple = (0, 0)
    # batching/pipelining extensions (None/False on the unbatched path)
    client_srcs: Optional[tuple] = None   # per-sub-command reply routing
    gated: bool = False                   # counted against pipeline_depth
    # observability: trace ctx of the proposing op (None when untraced) —
    # deferred execution (dep-wait) replies rejoin the span tree through it
    trace: Optional[tuple] = None


@dataclass
class _Recovery:
    """One in-flight explicit-prepare recovery (per instance)."""
    ballot: tuple
    phase: str = "prepare"              # "prepare" | "accept"
    replies: dict = field(default_factory=dict)   # src -> EPrepareReply
    acks: int = 0


class EPaxosNode(Node):
    def __init__(self, node_id: int, net: Network, sched: Scheduler,
                 peers: list[int], recovery_timeout: float = 100e-3,
                 batch: Optional[BatchConfig] = None,
                 pipeline_depth: int = 0):
        super().__init__(node_id, net, sched)
        self.peers = list(peers)
        self.n = len(peers)
        self.fq = fast_quorum(self.n)
        self.maj = majority(self.n)
        self.next_inum = 0
        self.insts: Dict[tuple, _Inst] = {}
        # leaderless batching: every node batches the requests IT receives
        # (clients pick random command leaders, so each node runs its own
        # buffer).  pipeline_depth throttles this node's own uncommitted
        # instances; 0 = unbounded (native behavior).
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        self.batch = batch
        self.pipeline_depth = pipeline_depth
        self._batching = batch is not None or pipeline_depth > 0
        self._buf: list = []            # (cmd, client_src) awaiting an inst
        self._buf_timer: Optional[int] = None
        self._held: list = []           # sealed batches awaiting pipeline room
        self._inflight = 0              # own gated insts proposed, uncommitted
        # ---- explicit-prepare recovery (off unless a fault plan enables
        # it: arming probe timers on every transiently-blocked dependency
        # would perturb the golden traces and the fault-free hot path) ----
        self.recovery_enabled = False
        self.recovery_timeout = recovery_timeout
        self._recover_armed: set = set()          # inst ids with a probe timer
        self._recoveries: Dict[tuple, _Recovery] = {}
        # per-key: latest interfering instance per replica (standard EPaxos
        # optimization: depend on the most recent conflict per replica)
        self.interf: Dict[int, Dict[int, tuple]] = {}
        # quorum-read frontier: key -> (executed-put count, wtag).  The
        # put-count is a consistent per-key version across replicas because
        # interfering commands execute in the same relative order everywhere.
        self._applied_ver: Dict[int, tuple] = {}
        self._pending_exec: list = []
        # at-most-once execution: (client_id, seq) -> result.  A client
        # timeout retry can create a second instance of the same command at
        # a different command leader; both instances interfere (same key),
        # so every replica executes them in the same relative order and
        # makes the identical skip decision for the duplicate.  Keyed by the
        # exact op id (not a per-client high-water mark) because EPaxos only
        # orders *interfering* commands — a client's ops on different keys
        # may execute in different relative orders on different replicas.
        self._done_ops: Dict[tuple, Optional[bytes]] = {}
        # membership state (single-server reconfiguration): cfg commands ride
        # the normal instance space but interfere with EVERY command (they
        # depend on all latest instances and everything after depends on
        # them), so all replicas execute the switch at the same point of the
        # dependency order.  One deterministic proposer (the lowest member,
        # routed by Cluster) approximates the one-at-a-time invariant.
        self.members: list = sorted(peers)
        self.joining = False
        self.removed = False
        self._last_cfg: Optional[tuple] = None    # latest cfg instance id
        self._cfg_seq = 0
        self._leader_ref = None
        self._join_catch_up = True
        self._snap_installed = False
        self.on_membership_change = None
        self.committed_count = 0

    # ---------------------------------------------------------------- leader
    def on_ClientRequest(self, msg: ClientRequest) -> None:
        if self.joining or self.removed:
            # not (yet / anymore) a member: bounce like a non-leader Paxos
            # node so the client re-picks from the current membership
            self.send(msg.src, ClientReply(client_id=msg.cmd.client_id,
                                           seq=msg.cmd.seq, ok=False))
            return
        if self._batching:
            self._enqueue(msg.cmd, msg.src)
            return
        self._propose_cmd(msg.cmd, msg.src)

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
        gated = self.pipeline_depth > 0
        if gated:
            self._inflight += 1
        if len(buf) == 1:
            cmd, src = buf[0]
            iid = self._propose_cmd(cmd, src)
        else:
            iid = self._propose_cmd(BatchCmd(cmds=tuple(c for c, _ in buf)),
                                    client_src=-1,
                                    client_srcs=tuple(s for _, s in buf))
        if gated:
            self.insts[iid].gated = True

    def _release_held(self) -> None:
        d = self.pipeline_depth
        while self._held and (d <= 0 or self._inflight < d):
            self._propose_batch(self._held.pop(0))

    def _drop_buffers(self, bounce: bool) -> None:
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

    def _propose_cmd(self, cmd: Command, client_src: int,
                     client_srcs: Optional[tuple] = None) -> tuple:
        inst_id = (self.id, self.next_inum)
        self.next_inum += 1
        deps = self._deps_for(cmd, exclude=inst_id)
        seq = 1 + max([self.insts[d].seq for d in deps
                       if d in self.insts], default=0)
        inst = _Inst(cmd=cmd, deps=deps, seq=seq, state="preaccepted",
                     client_src=client_src, is_mine=True,
                     client_srcs=client_srcs)
        tr = self.net.tracer
        if tr is not None:
            inst.trace = tr.cur   # ambient ClientRequest ctx (None on timers)
        self.insts[inst_id] = inst
        self._note_cmd(cmd, inst_id)
        # one shared instance per broadcast: receivers never mutate messages
        m = PreAccept(inst=inst_id, cmd=cmd, deps=deps, seq=seq,
                      n_cluster=self.n)
        if tr is not None and inst.trace is not None:
            tr.attach(m, inst.trace)
        for p in self.peers:
            if p != self.id:
                self.send(p, m)
        return inst_id

    def _conflicts(self, key: int, exclude: tuple) -> frozenset:
        m = self.interf.get(key)
        if not m:
            return frozenset()
        return frozenset(v for v in m.values() if v != exclude)

    def _deps_for(self, cmd: Command, exclude: tuple) -> frozenset:
        """Dependency set for a command: per-key conflicts for data ops
        (plus the latest cfg instance, so every command orders after the
        membership switch), ALL latest instances for cfg ops."""
        op = cmd.op
        if op == "put" or op == "get":
            deps = self._conflicts(cmd.key, exclude=exclude)
            lc = self._last_cfg
            if lc is not None and lc != exclude and lc not in deps:
                deps = deps | {lc}
            return deps
        if op == "batch":
            # a batch interferes with whatever any sub-command interferes with
            bs: set = set()
            for c in cmd.cmds:
                bs.update(self._conflicts(c.key, exclude=exclude))
            lc = self._last_cfg
            if lc is not None and lc != exclude:
                bs.add(lc)
            return frozenset(bs)
        ds: set = set()
        for m in self.interf.values():
            ds.update(m.values())
        if self._last_cfg is not None:
            ds.add(self._last_cfg)
        ds.discard(exclude)
        return frozenset(ds)

    def _note_interf(self, key: int, inst_id: tuple) -> None:
        self.interf.setdefault(key, {})[inst_id[0]] = inst_id

    def _note_cmd(self, cmd: Command, inst_id: tuple) -> None:
        op = cmd.op
        if op == "put" or op == "get":
            self._note_interf(cmd.key, inst_id)
        elif op == "batch":
            for c in cmd.cmds:
                self._note_interf(c.key, inst_id)
        else:
            # cfg commands live outside the per-key map (their ``key`` is a
            # node id and must not collide with data keys)
            self._last_cfg = inst_id

    # -------------------------------------------------------------- replicas
    def on_PreAccept(self, msg: PreAccept) -> None:
        local = self._deps_for(msg.cmd, exclude=msg.inst)
        deps = msg.deps | local
        seq = max(msg.seq, 1 + max([self.insts[d].seq for d in local
                                    if d in self.insts], default=0))
        inst = self.insts.setdefault(msg.inst, _Inst())
        if inst.state in ("committed", "executed"):
            return
        if msg.ballot < inst.max_ballot:
            return    # a recovery already raised this instance's ballot
        inst.cmd, inst.deps, inst.seq, inst.state = msg.cmd, deps, seq, "preaccepted"
        self._note_cmd(msg.cmd, msg.inst)
        if self.joining or self.removed:
            return    # non-members record state but never vote
        self.send(msg.src, PreAcceptReply(inst=msg.inst, ok=True, deps=deps,
                                          seq=seq, n_cluster=self.n))

    def on_PreAcceptReply(self, msg: PreAcceptReply) -> None:
        inst = self.insts.get(msg.inst)
        # max_ballot > ballot means a recovery prepare preempted the
        # original (0, 0) round: stop counting, or a delayed round could
        # fast-path commit attributes diverging from the recoverer's
        if inst is None or not inst.is_mine or inst.state != "preaccepted" \
                or inst.max_ballot > inst.ballot:
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
            m = EAccept(inst=msg.inst, cmd=inst.cmd, deps=inst.deps,
                        seq=inst.seq, n_cluster=self.n)
            tr = self.net.tracer
            if tr is not None and inst.trace is not None:
                tr.attach(m, inst.trace)   # slow-path round stays on-trace
            for p in self.peers:
                if p != self.id:
                    self.send(p, m)

    def on_EAccept(self, msg: EAccept) -> None:
        inst = self.insts.setdefault(msg.inst, _Inst())
        if inst.state in ("committed", "executed"):
            return
        if msg.ballot < inst.max_ballot:
            # stale accept round (a recovery preempted it): reject so the
            # sender stops counting; never true on the fault-free path,
            # where every ballot is the original (0, 0)
            self.send(msg.src, EAcceptReply(inst=msg.inst, ok=False,
                                            ballot=inst.max_ballot))
            return
        inst.max_ballot = max(inst.max_ballot, msg.ballot)
        inst.ballot = msg.ballot
        inst.cmd, inst.deps, inst.seq, inst.state = msg.cmd, msg.deps, msg.seq, "accepted"
        if msg.cmd is not None:       # recovery no-ops carry no command
            self._note_cmd(msg.cmd, msg.inst)
        if self.joining or self.removed:
            return    # non-members record state but never vote
        self.send(msg.src, EAcceptReply(inst=msg.inst, ok=True,
                                        ballot=msg.ballot))

    def on_EAcceptReply(self, msg: EAcceptReply) -> None:
        rec = self._recoveries.get(msg.inst)
        if rec is not None and rec.phase == "accept":
            self._recovery_accept_reply(msg.inst, rec, msg)
            return
        inst = self.insts.get(msg.inst)
        # acks must match the ballot the attributes were accepted at — a
        # recovery that preempted the original round leaves its own ballot
        # on the instance, so stale (0, 0) acks stop counting
        if inst is None or not inst.is_mine or inst.state != "accepted" \
                or not msg.ok or msg.ballot != inst.ballot:
            return
        inst.accept_acks += 1
        if inst.accept_acks >= self.maj:
            self._commit(msg.inst, inst)

    # ---------------------------------------------------------------- commit
    def _commit(self, inst_id: tuple, inst: _Inst) -> None:
        inst.state = "committed"
        # count a commit once cluster-wide: at the owning coordinator only.
        # Recovery commits (is_mine False at the recoverer) stay uncounted —
        # dueling recoverers may both reach this point for one instance, and
        # a small undercount beats inflating the summed committed stat
        if inst.cmd is not None and inst.is_mine:
            self.committed_count += 1
        if inst.gated:
            inst.gated = False
            self._inflight -= 1
            if self._held:
                self._release_held()
        m = ECommit(inst=inst_id, cmd=inst.cmd, deps=inst.deps, seq=inst.seq,
                    n_cluster=self.n)
        tr = self.net.tracer
        if tr is not None and inst.trace is not None:
            tr.attach(m, inst.trace)
        for p in self.peers:
            if p != self.id:
                self.send(p, m)
        self._pending_exec.append(inst_id)
        self._drain_exec()

    def on_ECommit(self, msg: ECommit) -> None:
        inst = self.insts.setdefault(msg.inst, _Inst())
        if inst.state in ("committed", "executed"):
            return                    # recovery re-broadcasts are idempotent
        inst.cmd, inst.deps, inst.seq = msg.cmd, msg.deps, msg.seq
        inst.state = "committed"
        if msg.cmd is not None:
            self._note_cmd(msg.cmd, msg.inst)
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
        track = self.recovery_enabled

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
                        if track:
                            # fault mode: a dep stuck uncommitted past the
                            # probe timeout gets an explicit-prepare recovery
                            self._arm_recovery(w)
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
        cmd = inst.cmd
        if cmd is None:
            # recovered no-op (no quorum member ever saw the command): mark
            # executed without touching the store — successors unblock, the
            # client's retry re-proposes the real command elsewhere
            inst.state = "executed"
            return
        if cmd.__class__ is BatchCmd:
            # apply sub-commands in batch order, each through the same
            # at-most-once dedup; replicas make identical skip decisions
            done = self._done_ops
            results = []
            for c in cmd.cmds:
                op_id = (c.client_id, c.seq)
                if op_id in done:
                    results.append(done[op_id])
                    continue
                val = self.store.apply(c)
                done[op_id] = val
                self.applied_log.append((inst_id, c))
                if c.op == "put":
                    v = self._applied_ver.get(c.key)
                    self._applied_ver[c.key] = ((v[0] if v else 0) + 1, op_id)
                results.append(val)
            inst.state = "executed"
            srcs = inst.client_srcs
            if inst.is_mine and srcs:
                tr = self.net.tracer
                owner = (tr.meta[inst.trace[0]]["client"]
                         if tr is not None and inst.trace is not None else -1)
                for c, src, val in zip(cmd.cmds, srcs, results):
                    if src >= 0:
                        reply = ClientReply(client_id=c.client_id,
                                            seq=c.seq, ok=True, value=val)
                        if src == owner:
                            tr.attach(reply, inst.trace)
                        self.send(src, reply)
            return
        op_id = (cmd.client_id, cmd.seq)
        done = self._done_ops
        if op_id in done:
            # duplicate instance of an already-executed op (client timeout
            # retry): skip the apply, answer from the cached result
            inst.state = "executed"
            if inst.is_mine and inst.client_src >= 0:
                self.send(inst.client_src,
                          ClientReply(client_id=cmd.client_id, seq=cmd.seq,
                                      ok=True, value=done[op_id]))
            return
        if cmd.op != "put" and cmd.op != "get":
            # configuration command: activates membership, not the store
            done[op_id] = None
            self.applied_log.append((inst_id, cmd))
            inst.state = "executed"
            self._apply_membership(cmd)
            return
        val = self.store.apply(cmd)
        done[op_id] = val
        self.applied_log.append((inst_id, cmd))
        if cmd.op == "put":
            v = self._applied_ver.get(cmd.key)
            self._applied_ver[cmd.key] = ((v[0] if v else 0) + 1, op_id)
        inst.state = "executed"
        if inst.is_mine and inst.client_src >= 0:
            reply = ClientReply(client_id=cmd.client_id,
                                seq=cmd.seq, ok=True, value=val)
            tr = self.net.tracer
            if tr is not None and inst.trace is not None:
                tr.attach(reply, inst.trace)
            self.send(inst.client_src, reply)

    # ========================================================== quorum reads
    def on_ReadProbe(self, msg: ReadProbe) -> None:
        """Per-key frontier for client-side quorum reads.  ``applied`` is
        this replica's executed-put count for the key; ``accepted`` adds 1
        when a known interfering instance has not executed here yet (the
        client rinses until some quorum member has executed everything the
        quorum knows about)."""
        key = msg.key
        av = self._applied_ver.get(key)
        ver, wtag = av if av is not None else (0, None)
        acc = ver
        m = self.interf.get(key)
        if m:
            for iid in m.values():
                inst = self.insts.get(iid)
                if inst is None or (inst.state != "executed"
                                    and inst.cmd is not None
                                    and inst.cmd.op != "get"):
                    acc = ver + 1
                    break
        self.send(msg.src, ReadReply(rid=msg.rid, key=key, applied=ver,
                                     accepted=acc,
                                     value=self.store.data.get(key),
                                     wtag=wtag))

    # ===================================================== membership change
    def propose_reconfig(self, op: str, nid: int) -> bool:
        """Propose a single-server membership change as a cfg instance.
        Routed by ``Cluster`` to one deterministic proposer (the lowest
        member), which refuses a second cfg while one is still un-executed —
        the one-at-a-time invariant, leaderless edition."""
        if self.joining or self.removed:
            return False
        lc = self._last_cfg
        if lc is not None:
            prev = self.insts.get(lc)
            if prev is not None and prev.state != "executed":
                return False               # previous cfg still in flight
        if (op == "add_node") == (nid in self.members):
            return False                   # no-op change
        self._cfg_seq += 1
        cmd = Command(client_id=-(self.id + 1), seq=self._cfg_seq,
                      op=op, key=nid)
        self._propose_cmd(cmd, client_src=-1)
        return True

    def _apply_membership(self, cmd: Command) -> None:
        """Activate an executed cfg command.  Ordered identically on every
        replica because cfg instances interfere with everything."""
        nid = cmd.key
        members = self.members
        if cmd.op == "add_node":
            if nid not in members:
                members.append(nid)
                members.sort()
        elif cmd.op == "remove_node":
            if nid in members:
                members.remove(nid)
            if nid == self.id:
                self.removed = True
                if self._batching:
                    self._drop_buffers(bounce=True)
        else:
            raise RuntimeError(f"unknown configuration op {cmd.op!r}")
        self._refresh_quorums()
        if cmd.op == "add_node" and nid != self.id \
                and cmd.client_id == -(self.id + 1):
            # the proposer confirms the join directly: the new node never
            # executes this cfg instance (it has no dependency history), so
            # it learns "you are a member now" out of band
            self.send(nid, Snapshot(members=tuple(members),
                                    payload={"confirm": True}))
        cb = self.on_membership_change
        if cb is not None:
            cb(self, cmd.op, nid)

    def _refresh_quorums(self) -> None:
        self.peers = list(self.members)
        self.n = len(self.peers)
        self.fq = fast_quorum(self.n)
        self.maj = majority(self.n)

    def begin_join(self, leader_ref, catch_up: bool = True) -> None:
        """Learner protocol: fetch a state snapshot from the cfg proposer,
        then stay mute (recording but never voting) until the proposer's
        confirm promotes this node to a member.  ``catch_up=False`` is the
        deliberately-broken control for the auditor tests."""
        self.joining = True
        self._leader_ref = leader_ref
        self._join_catch_up = catch_up
        self._snap_installed = False
        self._send_join()

    def _send_join(self) -> None:
        if not self.joining or self.crashed:
            return
        self.send(self._leader_ref(), JoinReq(node=self.id))
        self.set_timer(4 * self.recovery_timeout, self._send_join)

    def on_JoinReq(self, msg: JoinReq) -> None:
        if self.joining or self.removed:
            return
        nid = msg.node
        payload = {
            "interf": {k: dict(m) for k, m in self.interf.items()},
            # executed instances ship as stubs: the execution graph skips
            # executed-state dependencies, so the joiner can order new
            # commands without replaying history
            "executed": [(iid, inst.seq) for iid, inst in self.insts.items()
                         if inst.state == "executed"],
            "last_cfg": self._last_cfg,
        }
        self.send(nid, Snapshot(store=dict(self.store.data),
                                session=dict(self._done_ops),
                                members=tuple(self.members),
                                payload=payload))
        if nid not in self.members:
            self.propose_reconfig("add_node", nid)

    def on_Snapshot(self, msg: Snapshot) -> None:
        p = msg.payload or {}
        if p.get("confirm"):
            if self.joining:
                self.members = sorted(set(msg.members) | {self.id})
                self._refresh_quorums()
                self.joining = False
            return
        if not self.joining or self._snap_installed:
            return                         # only the first snapshot installs
        self._snap_installed = True
        if self._join_catch_up:
            self.store.data = dict(msg.store)
            self._done_ops = dict(msg.session)
            self.interf = {k: dict(m) for k, m in p.get("interf", {}).items()}
            for iid, seq in p.get("executed", ()):
                self.insts.setdefault(iid, _Inst(state="executed", seq=seq))
            self._last_cfg = p.get("last_cfg")
        self.applied_log = []
        self.members = sorted(msg.members)
        self._refresh_quorums()

    # ======================================================= recovery (§4.7)
    # Explicit-prepare instance recovery: when a command leader crashes with
    # instances in flight, peers whose execution stays blocked on them run a
    # per-instance prepare phase with a higher ballot, adopt the highest
    # (pre-)accepted attributes a majority reports, and re-commit through a
    # Paxos-accept round — or commit a no-op when no quorum member ever saw
    # the command.  Enabled by ``faults.apply_plan`` (fault scenarios only):
    # probe timers on every transiently-blocked dependency would perturb the
    # fault-free golden traces for nothing.
    #
    # Decision safety mirrors full EPaxos restricted to what this simulation
    # can produce: a fast-path commit broadcasts ECommit to every peer in
    # the same handler that decides it (before the client can be answered),
    # so a committed-but-unknown-to-everyone instance never outlives the
    # ~one-hop delivery window — orders of magnitude shorter than the probe
    # timeout that gates any recovery.  By probe time, either some quorum
    # member reports "committed" (adopted verbatim) or no fast-path commit
    # happened and the accepted/pre-accepted union is free to win.
    def enable_recovery(self) -> None:
        self.recovery_enabled = True

    def recover(self) -> None:
        """Crash-recover with protocol semantics: suppressed probe timers
        are forgotten (they died with the crash), and the node's own
        in-flight instances — whose replies were dropped while it was down —
        re-run through the explicit-prepare path (re-commit or no-op)."""
        if not self.crashed:
            return
        super().recover()
        if self._batching:
            # buffered commands are volatile: the crash lost them (clients
            # retry; _done_ops absorbs duplicates) and gated flags re-derive
            self._drop_buffers(bounce=False)
            for inst in self.insts.values():
                inst.gated = False
        if not self.recovery_enabled:
            return
        self._recover_armed.clear()
        self._recoveries.clear()
        for iid, inst in list(self.insts.items()):
            if iid[0] == self.id and inst.state in ("preaccepted", "accepted"):
                inst.replies = []
                inst.accept_acks = 0
                self._start_prepare(iid)
        self._drain_exec()

    def _arm_recovery(self, inst_id: tuple) -> None:
        if inst_id in self._recover_armed or inst_id in self._recoveries:
            return
        self._recover_armed.add(inst_id)
        # stagger by distance from the owner so probes rarely duel: the
        # recovered owner itself re-commits fastest, then successive peers
        rank = (self.id - inst_id[0]) % self.n
        delay = self.recovery_timeout * (1.0 + 0.25 * rank)
        self.set_timer(delay, lambda: self._probe_recovery(inst_id))

    def _probe_recovery(self, inst_id: tuple) -> None:
        self._recover_armed.discard(inst_id)
        inst = self.insts.get(inst_id)
        if inst is not None and inst.state in ("committed", "executed"):
            return
        if inst_id in self._recoveries:
            return
        self._start_prepare(inst_id)

    def _start_prepare(self, inst_id: tuple) -> None:
        inst = self.insts.setdefault(inst_id, _Inst())
        b = (max(inst.max_ballot[0], inst.ballot[0]) + 1, self.id)
        inst.max_ballot = b
        rec = _Recovery(ballot=b)
        self._recoveries[inst_id] = rec
        # the local snapshot is this node's own prepare reply
        rec.replies[self.id] = EPrepareReply(
            inst=inst_id, ok=True, ballot=b, state=inst.state, cmd=inst.cmd,
            deps=inst.deps, seq=inst.seq, accepted_ballot=inst.ballot,
            n_cluster=self.n)
        m = EPrepare(inst=inst_id, ballot=b, n_cluster=self.n)
        for p in self.peers:
            if p != self.id:
                self.send(p, m)
        # stall guard: a round started while a quorum was unreachable (its
        # EPrepares were dropped at crashed peers) would otherwise pend
        # forever and block re-arming — abandon and re-probe
        self.set_timer(4 * self.recovery_timeout,
                       lambda: self._abandon_stalled(inst_id, b))

    def _abandon_stalled(self, inst_id: tuple, ballot: tuple) -> None:
        rec = self._recoveries.get(inst_id)
        if rec is None or rec.ballot != ballot:
            return
        del self._recoveries[inst_id]
        inst = self.insts.get(inst_id)
        if inst is not None and inst.state not in ("committed", "executed"):
            self._arm_recovery(inst_id)

    def on_EPrepare(self, msg: EPrepare) -> None:
        inst = self.insts.setdefault(msg.inst, _Inst())
        if self.joining or self.removed:
            return    # non-members don't vote in recovery rounds either
        if msg.ballot > inst.max_ballot:
            inst.max_ballot = msg.ballot
            r = EPrepareReply(inst=msg.inst, ok=True, ballot=msg.ballot,
                              state=inst.state, cmd=inst.cmd, deps=inst.deps,
                              seq=inst.seq, accepted_ballot=inst.ballot,
                              n_cluster=self.n)
        else:
            r = EPrepareReply(inst=msg.inst, ok=False, ballot=inst.max_ballot)
        self.send(msg.src, r)

    def on_EPrepareReply(self, msg: EPrepareReply) -> None:
        rec = self._recoveries.get(msg.inst)
        if rec is None or rec.phase != "prepare" or msg.ballot != rec.ballot:
            # a reject is only a preemption when the promise it carries
            # beats OUR current round — late rejects answering an earlier
            # abandoned round must not tear down the live one
            if rec is not None and rec.phase == "prepare" and not msg.ok \
                    and msg.ballot > rec.ballot:
                del self._recoveries[msg.inst]
                self._arm_recovery(msg.inst)
            return
        rec.replies[msg.src] = msg
        if len(rec.replies) >= self.maj:
            self._decide_recovery(msg.inst, rec)

    def _decide_recovery(self, inst_id: tuple, rec: _Recovery) -> None:
        rs = list(rec.replies.values())
        committed = [r for r in rs if r.state in ("committed", "executed")]
        if committed:
            del self._recoveries[inst_id]
            r0 = committed[0]
            self._commit_recovered(inst_id, r0.cmd, r0.deps, r0.seq)
            return
        accepted = [r for r in rs if r.state == "accepted"]
        if accepted:
            r0 = max(accepted, key=lambda r: r.accepted_ballot)
            cmd, deps, seq = r0.cmd, r0.deps, r0.seq
        else:
            pre = [r for r in rs
                   if r.state == "preaccepted" and r.cmd is not None]
            if pre:
                cmd = pre[0].cmd
                deps = frozenset().union(*[r.deps for r in pre])
                seq = max(r.seq for r in pre)
            else:
                cmd, deps, seq = None, frozenset(), 0   # no-op the instance
        rec.phase, rec.acks = "accept", 1
        inst = self.insts[inst_id]
        inst.cmd, inst.deps, inst.seq = cmd, deps, seq
        inst.state = "accepted"
        inst.ballot = rec.ballot
        if cmd is not None:
            self._note_cmd(cmd, inst_id)
        m = EAccept(inst=inst_id, ballot=rec.ballot, cmd=cmd, deps=deps,
                    seq=seq, n_cluster=self.n)
        for p in self.peers:
            if p != self.id:
                self.send(p, m)

    def _recovery_accept_reply(self, inst_id: tuple, rec: _Recovery,
                               msg: EAcceptReply) -> None:
        if not msg.ok:
            if msg.ballot > rec.ballot:        # genuinely preempted
                del self._recoveries[inst_id]
                self._arm_recovery(inst_id)
            return                             # stale reject: ignore
        if msg.ballot != rec.ballot:
            return                             # stale round
        rec.acks += 1
        if rec.acks >= self.maj:
            del self._recoveries[inst_id]
            inst = self.insts[inst_id]
            if inst.state not in ("committed", "executed"):
                self._commit(inst_id, inst)

    def _commit_recovered(self, inst_id: tuple, cmd, deps, seq) -> None:
        """Adopt a commit learned through a prepare quorum; _commit
        re-broadcasts ECommit — the original may have been lost to the
        crash window."""
        inst = self.insts[inst_id]
        if inst.state in ("committed", "executed"):
            return
        inst.cmd, inst.deps, inst.seq = cmd, deps, seq
        if cmd is not None:
            self._note_cmd(cmd, inst_id)
        self._commit(inst_id, inst)
