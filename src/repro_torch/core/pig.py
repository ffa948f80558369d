"""The Pig communication primitive (§3.1) and the classic direct layer.

Pig replaces the leader's direct fan-out/fan-in with relay-group overlays:

  leader --PigFanout--> relay --PigRelayed--> group peers
  leader <--PigAggregate-- relay <--PigReply-- group peers

Key properties implemented here, exactly as in the paper:
  * static non-overlapping relay groups (reference implementation, §3.2);
  * uniformly-random relay rotation per round (§3.1) — or static relays for
    the Fig 8 comparison (no liveness guarantee in that mode);
  * in-network aggregation with deduplicated missing-voter lists (§6.4);
  * relay timeout T_r << leader timeout T_l (§3.4);
  * partial response collection: reply after group_size - PRC acks (§4.1);
  * single-relay-group global-majority shortcut (§4.3);
  * gray lists with occasional probing of suspected nodes (§4.2);
  * reject short-circuit on higher ballots (§3.2 footnote).

The layer is deliberately protocol-agnostic: it moves opaque ``inner``
messages and vote summaries, so PigPaxos = Paxos + PigComm with *zero*
changes to the consensus core — mirroring the paper's claim that Pig only
changes the communication implementation (and hence inherits Paxos proofs).

Copied from ``repro.core.pig``; the port's tests hold it to the
reference's run, event for event.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from .messages import (Msg, P1b, P2a, P2b, PigAggregate, PigFanout,
                       PigRelayed, PigReply)


# --------------------------------------------------------------------------
@dataclass
class PigConfig:
    n_groups: int = 1
    rotate_relays: bool = True          # False => static relay (Fig 8 baseline)
    prc: int = 0                        # of slowest group members to not wait on (§4.1)
    relay_timeout: float = 10e-3        # T_r (must be << leader timeout T_l, §3.4)
    single_group_majority: bool = False  # §4.3 optimization for R == 1
    use_gray_list: bool = False         # §4.2
    gray_duration: float = 2.0
    gray_probe_prob: float = 0.02
    groups: Optional[List[List[int]]] = None   # explicit (e.g. per-region, §5.3)
    # elasticity: re-derive R from the *current* membership on every
    # re-partition (R ~ sqrt(N), the paper's §5.2 sweet spot) instead of
    # keeping n_groups fixed while the cluster grows/shrinks
    auto_groups: bool = False


def auto_group_count(n_members: int) -> int:
    """Elasticity policy for the relay-group count: R ~ sqrt(N-1) balances
    the leader's R aggregates against each relay's (N-1)/R fan-out (paper
    §5.2 finds the throughput plateau around this point)."""
    return max(1, int(round(math.sqrt(max(n_members - 1, 1)))))


def partition_followers(members: Sequence[int], r: int) -> List[List[int]]:
    """Round-robin partition of the followers into ``r`` relay groups —
    THE cluster-wide static partition (§3.2), shared by the DES comm layer
    and the batched backend (``core.vectorsim``)."""
    r = max(1, min(r, len(members)))
    out: List[List[int]] = [[] for _ in range(r)]
    for i, m in enumerate(members):
        out[i % r].append(m)
    return out


def required_per_group(groups: List[List[int]], n: int, prc: int,
                       single_group_majority: bool) -> List[int]:
    """PRC thresholds q_i = n_i - PRC, subject to the paper's §4.1
    constraint sum(q_i) >= majority - 1 (the leader votes for itself);
    violating it would let a single crashed group block liveness.
    ``single_group_majority`` is the §4.3 R == 1 global-majority shortcut.
    Shared by PigComm and the batched backend (``core.vectorsim``)."""
    maj = n // 2 + 1
    if single_group_majority and len(groups) == 1:
        return [min(len(groups[0]), maj - 1)]     # §4.3: global majority
    req = [max(1, len(g) - prc) for g in groups]
    i = 0
    while sum(req) < maj - 1:
        if req[i % len(req)] < len(groups[i % len(req)]):
            req[i % len(req)] += 1
        i += 1
        if i > 4 * len(req):       # all groups already at n_i
            break
    return req


class DirectComm:
    """Classic Paxos communication: leader <-> every follower directly.

    Comm interface note: every comm strategy exposes ``_pending_sup``
    (slot -> pig round with batched late votes); PaxosNode._learn_commit
    peeks at it to skip the ``note_committed_up_to`` call on the commit hot
    path when no supplements are pending.  DirectComm never queues any.
    """

    name = "direct"

    def __init__(self, node, peers: Sequence[int]):
        self.node = node
        self.peers = [p for p in peers if p != node.id]
        self._pending_sup: Dict[int, int] = {}   # always empty (see above)

    # leader side -----------------------------------------------------------
    def broadcast(self, make_msg: Callable[[], Msg], round_key=None) -> list:
        # one shared instance: receivers never mutate messages, and the
        # network stamps the same .src on every send (cost computed once)
        m = make_msg()
        for p in self.peers:
            self.node.send(p, m)
        return []

    # follower side ---------------------------------------------------------
    def reply(self, to: int, msg: Msg) -> None:
        self.node.send(to, msg)

    def set_members(self, members: Sequence[int]) -> None:
        """Membership changed: rebuild the direct fan-out list."""
        self.peers = [p for p in members if p != self.node.id]

    # no-op hooks so Paxos can stay comm-agnostic
    def note_commit(self, slot: int) -> None:
        pass

    def note_committed_up_to(self, ci: int) -> None:
        pass

    def on_round_timeout(self, round_ids) -> None:
        pass


class PigComm:
    """Pig overlay communication used by the leader and all followers."""

    name = "pig"

    def __init__(self, node, peers: Sequence[int], cfg: PigConfig):
        self.node = node
        self.cfg = cfg
        self.all_nodes = list(peers)
        self._groups_cache: Dict[int, List[List[int]]] = {}
        self._peers_cache: Dict[tuple, tuple] = {}   # (leader, gi) -> (peers, expect)
        self._pig_seq = node.id << 40
        # relay-side aggregation state: pig_id -> dict
        self._agg: Dict[int, dict] = {}
        # leader-side: pig_id -> (group_idx, relay, round_key)
        self._outstanding: Dict[int, tuple] = {}
        self._pending_sup: Dict[int, int] = {}   # slot -> pig_id (late votes)
        self.gray: Dict[int, float] = {}     # node -> expiry time (§4.2)

    _partition = staticmethod(partition_followers)

    def groups_for(self, leader: int) -> List[List[int]]:
        """Relay groups are a cluster-wide static partition of the *followers*
        (paper §3.2) — i.e. of all nodes except the current leader.  Every
        node derives the same partition deterministically from the leader id,
        so relays and the leader agree without extra coordination."""
        g = self._groups_cache.get(leader)
        if g is None:
            if self.cfg.groups is not None:
                live = set(self.all_nodes)
                g = [[m for m in grp if m != leader and m in live]
                     for grp in self.cfg.groups]
                g = [grp for grp in g if grp]
            else:
                r = (auto_group_count(len(self.all_nodes))
                     if self.cfg.auto_groups else self.cfg.n_groups)
                g = self._partition([p for p in self.all_nodes if p != leader],
                                    r)
            self._groups_cache[leader] = g
        return g

    def set_members(self, members: Sequence[int]) -> None:
        """Membership changed: re-partition the relay groups.  Cached
        partitions (and the per-(leader, group) peer sets derived from them)
        are invalidated; rounds already in flight complete or fail over to
        the leader's timeout/retry path, which re-derives fresh groups."""
        self.all_nodes = list(members)
        self._groups_cache.clear()
        self._peers_cache.clear()

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
        return required_per_group(groups, len(self.all_nodes), self.cfg.prc,
                                  self.cfg.single_group_majority)

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
    def _group_peers(self, leader: int, gi: int) -> tuple:
        """(peers, expect-set) for relay duty, cached per (leader, group).
        The expect set is shared across rounds — aggregation never mutates
        it (only reads / set-unions)."""
        key = (leader, gi)
        pe = self._peers_cache.get(key)
        if pe is None:
            groups = self.groups_for(leader)   # groups relative to the leader
            group = groups[gi] if gi < len(groups) else []
            peers = [p for p in group if p != self.node.id]
            pe = self._peers_cache.setdefault(key, (peers, set(peers)))
        return pe

    def on_PigFanout(self, msg: PigFanout) -> None:
        node = self.node
        peers, expect = self._group_peers(msg.src, msg.group)
        st = {
            "replies": [],
            "voters": set(),
            "required": msg.required,
            "leader": msg.src,
            "group": msg.group,
            "expect": expect,
            "done": False,
            "timer": None,
            # flush threshold: min(required, group size incl. the relay)
            "thresh": min(msg.required, len(peers) + 1),
        }
        tr = node.net.tracer
        if tr is not None:
            # remember the op's ctx + fan-in start so the timer-driven
            # flush can close a "relay" (aggregation-wait) span and the
            # PigAggregate rejoins the op's trace (repro.obs)
            ctx = tr.cur or tr.ctx_of(msg)
            if ctx is not None:
                st["trace"] = ctx
                st["t_fan"] = node.sched.now
        self._agg[msg.pig_id] = st
        # 1) act as a regular follower on the inner message (common case
        #    dispatched inline: P2a accept, skipping the process_inner frame)
        inner = msg.inner
        my_reply = (node._accept(inner) if inner.__class__ is P2a
                    else node.process_inner(inner))
        if my_reply is not None:
            self._accumulate(msg.pig_id, node.id, my_reply)
        # 2) re-transmit to the rest of the group (one shared wrapper:
        #    identical payload per peer, receivers don't mutate it)
        if peers:
            relayed = PigRelayed(pig_id=msg.pig_id, relay=node.id,
                                 inner=msg.inner)
            for p in peers:
                node.send(p, relayed)
        # 3) arm the relay timeout T_r (§3.4)
        st["timer"] = node.set_timer(self.cfg.relay_timeout,
                                     lambda: self._flush(msg.pig_id, timeout=True))
        self._maybe_flush(msg.pig_id)

    # ---------------------------------------------------------------- follower
    def on_PigRelayed(self, msg: PigRelayed) -> None:
        node = self.node
        inner = msg.inner
        reply = (node._accept(inner) if inner.__class__ is P2a
                 else node.process_inner(inner))
        if reply is not None:
            node.send(msg.relay, PigReply(pig_id=msg.pig_id, inner=reply))

    def on_PigReply(self, msg: PigReply) -> None:
        # fused accumulate + flush check (the per-reply hot path)
        pig_id = msg.pig_id
        st = self._agg.get(pig_id)
        if st is None:
            return
        reply = msg.inner
        if st["done"]:
            self._queue_late_vote(pig_id, st, msg.src, reply)
            return
        st["voters"].add(msg.src)
        st["replies"].append(reply)
        if reply.ok is False:
            # reject short-circuit (§3.2, footnote 1)
            self._flush(pig_id, reject=True)
        elif len(st["voters"]) >= st["thresh"]:
            self._flush(pig_id)

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
        # reject short-circuit: don't wait for aggregation (§3.2, footnote 1).
        # process_inner only yields P1b/P2b replies, so .ok always exists.
        if reply.ok is False:
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
            sup = _P1Aggregate(PigAggregate(
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
        if len(st["voters"]) >= st["thresh"]:
            self._flush(pig_id)

    def _flush(self, pig_id: int, timeout: bool = False, reject: bool = False) -> None:
        st = self._agg.get(pig_id)
        if st is None or st["done"]:
            return
        st["done"] = True
        if st["timer"] is not None:
            self.node.cancel_timer(st["timer"])
        replies: List[Msg] = st["replies"]
        voters = st["voters"]
        if not timeout and not reject and len(voters) > len(st["expect"]):
            # fast path: full group voted, nothing missing, no rejects
            oks = replies
            rejects = []
            missing = ()
        else:
            oks = [r for r in replies if getattr(r, "ok", True)]
            rejects = [r for r in replies if not getattr(r, "ok", True)]
            missing = tuple(sorted((st["expect"] | {self.node.id}) - voters))
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
            agg = _P1Aggregate(agg, p1)
        tr = self.node.net.tracer
        if tr is not None:
            ctx = st.get("trace")
            if ctx is not None:
                # the relay-aggregation window: fan-in start -> flush
                sid = tr.add_span(ctx, "relay", self.node.id,
                                  st["t_fan"], self.node.sched.now)
                tr.attach(agg, (ctx[0], sid))
        self.node.send(st["leader"], agg)
        # keep the entry briefly so late votes become supplementary
        # aggregates (§4.1), then GC it
        st["replies"] = []
        self.node.set_timer(4 * self.cfg.relay_timeout,
                            lambda: self._agg.pop(pig_id, None))

    # ---------------------------------------------------------------- misc
    def note_commit(self, slot: int) -> None:
        pass


class _P1Aggregate(PigAggregate):
    """PigAggregate that additionally carries P1b bodies (value recovery)."""

    _kind_name = "PigAggregate"   # dispatch as the base type (see Msg.kind)

    def __init__(self, base: PigAggregate, p1bs: List[P1b]):
        super().__init__(pig_id=base.pig_id, group=base.group,
                         ballot=base.ballot, slot=base.slot, acks=base.acks,
                         voters=base.voters, missing=base.missing,
                         timed_out=base.timed_out,
                         reject=base.reject, reject_ballot=base.reject_ballot)
        self.p1bs = p1bs

    def wire_size(self) -> int:
        return super().wire_size() + sum(m.wire_size() for m in self.p1bs)
