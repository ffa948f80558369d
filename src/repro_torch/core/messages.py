"""Protocol messages and the CPU/byte cost model.

The paper establishes (§2.2) that the leader bottleneck is CPU time spent
serializing/deserializing messages ("~100,000 phase-2a/2b messages saturate
one core" => ~10us/message), with a secondary dependence on payload size
(§5.5) and, for EPaxos, on cluster size N through dependency tracking
(§5.3: 25-node EPaxos messages serialize ~4x slower than 5-node ones).

Every message type reports ``wire_size()``; the cost model converts sizes to
CPU seconds at each endpoint.  Constants are calibrated in
benchmarks/fig9_latency_throughput.py against the paper's reported saturation
points (Paxos ~2k, EPaxos ~3k, PigPaxos >7k req/s at N=25).

Copied from ``repro.core.messages``; the port's tests hold it to the
reference's run, event for event.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

HEADER_BYTES = 24  # type tag + ballot + slot + ids


@dataclass(slots=True)
class Command:
    """A state-machine command (KV get/put)."""
    client_id: int
    seq: int          # per-client sequence number
    op: str           # 'get' | 'put'
    key: int
    value: Optional[bytes] = None

    def wire_size(self) -> int:
        return 16 + (len(self.value) if self.value is not None else 0)


@dataclass(slots=True)
class BatchCmd:
    """Several client commands packed into one slot by a batching leader.

    Quacks like :class:`Command` (same field names) so it can ride inside
    the existing ``P2a``/``PreAccept``/``ECommit`` envelopes and survive
    P1b / explicit-prepare recovery unchanged: recovery re-proposes the
    whole batch as one opaque value, so a batch commits or recovers
    atomically — sub-commands are never split across slots.
    """
    cmds: tuple = ()              # tuple[Command, ...]
    client_id: int = -1
    seq: int = 0
    op: str = "batch"
    key: int = -1
    value: Optional[bytes] = None

    def wire_size(self) -> int:
        # 8-byte batch header (count + framing) + concatenated commands
        return 8 + sum(c.wire_size() for c in self.cmds)


@dataclass(slots=True)
class Msg:
    src: int = -1
    # per-instance CPU-cost cache (CostModel.cpu_cost): broadcasts reuse one
    # message instance for every destination, so the cost is computed once.
    # Excluded from __eq__/__repr__ so caching never changes message identity.
    _cost: float = field(default=-1.0, compare=False, repr=False)
    # trace context (repro.obs): (trace_id, span_id) of the span that caused
    # this message, set once by Tracer.attach on sampled ops only.  A slot
    # (not a side table) because the engine loops test it per event — a slot
    # load is the only per-message tracing cost an unsampled op ever pays.
    _tctx: Any = field(default=None, compare=False, repr=False)

    def wire_size(self) -> int:
        return HEADER_BYTES

    @property
    def kind(self) -> str:
        # subclasses that must dispatch as another type (e.g. pig._P1Aggregate)
        # set ``_kind_name`` on the class instead of overriding this property
        cls = type(self)
        return getattr(cls, "_kind_name", None) or cls.__name__


# ---------------------------------------------------------------- client I/O
@dataclass(slots=True)
class ClientRequest(Msg):
    cmd: Command = None

    def wire_size(self) -> int:
        return HEADER_BYTES + self.cmd.wire_size()


@dataclass(slots=True)
class ClientReply(Msg):
    client_id: int = 0
    seq: int = 0
    ok: bool = True
    value: Optional[bytes] = None
    # which read path produced this reply: "log" (through consensus),
    # "lease" (leader-local leased read), or "quorum" (client-side quorum
    # read).  Metadata for the history/auditor — a real implementation
    # would not ship it, so it does not count toward wire_size().
    path: str = "log"

    def wire_size(self) -> int:
        return HEADER_BYTES + 8 + (len(self.value) if self.value else 0)


# ---------------------------------------------------------------- Paxos
@dataclass(slots=True)
class P1a(Msg):
    ballot: tuple = (0, 0)


@dataclass(slots=True)
class P1b(Msg):
    ballot: tuple = (0, 0)
    ok: bool = True
    # accepted: {slot: (ballot, Command)} for value recovery
    accepted: dict = field(default_factory=dict)
    # the follower's committed prefix: slots <= commit_index are pruned from
    # ``accepted``, so a behind new leader must catch them up instead of
    # re-proposing
    commit_index: int = -1

    def wire_size(self) -> int:
        return HEADER_BYTES + 8 + sum(24 + c.wire_size() for (_, c) in self.accepted.values())


@dataclass(slots=True)
class P2a(Msg):
    ballot: tuple = (0, 0)
    slot: int = 0
    cmd: Command = None
    commit_index: int = -1   # phase-3 piggybacked on phase-2 (§2.1)

    def wire_size(self) -> int:
        return HEADER_BYTES + 16 + self.cmd.wire_size()


class P2b(Msg):
    """Phase-2 vote. Hand-written init: this is the hottest message class
    (one per follower per slot), and the dataclass-generated __init__ costs
    ~100ns more per instantiation."""
    __slots__ = ("ballot", "slot", "ok")

    def __init__(self, ballot=(0, 0), slot=0, ok=True):
        self.src = -1
        self._cost = -1.0
        self._tctx = None
        self.ballot = ballot
        self.slot = slot
        self.ok = ok


@dataclass(slots=True)
class P3(Msg):
    """Explicit commit (used on idle / trailing slots)."""
    commit_index: int = -1


# ------------------------------------------------------- membership change
@dataclass(slots=True)
class JoinReq(Msg):
    """Joiner -> leader (Paxos) / config proposer (EPaxos): ask to be added
    to the replica set.  The receiver answers with a ``Snapshot`` and drives
    the ``add_node`` configuration command through the normal log."""
    node: int = -1


@dataclass(slots=True)
class Snapshot(Msg):
    """State transfer to a joining learner: applied KV state + client
    session table + the sender's membership view.  ``payload`` carries
    protocol-specific extras (EPaxos ships its interference map and executed
    instance ids; a zero-store Snapshot with ``payload={"confirm": True}``
    confirms a completed EPaxos join)."""
    commit_index: int = -1
    store: dict = field(default_factory=dict)
    session: dict = field(default_factory=dict)
    members: tuple = ()
    payload: Any = None

    def wire_size(self) -> int:
        extra = len(self.payload) if isinstance(self.payload, (dict, list)) else 0
        return (HEADER_BYTES + 16
                + 24 * (len(self.store) + len(self.session) + extra)
                + 2 * len(self.members))


# ------------------------------------------------------ leases + read paths
@dataclass(slots=True)
class LeaseGrant(Msg):
    """Leader -> members: ask for a read lease of ``duration`` seconds
    (measured on each receiver's LOCAL clock).  A follower that acks
    promises not to vote for a different leader until the lease expires
    locally — so a quorum of acks lets the leader serve reads from its own
    store without a round trip (Spinnaker-style leader leases)."""
    ballot: tuple = (0, 0)
    lseq: int = 0             # lease sequence number (one per renewal)
    duration: float = 0.0     # seconds, interpreted on the receiver's clock


@dataclass(slots=True)
class LeaseAck(Msg):
    """Member -> leader: the lease promise for (ballot, lseq) is in effect."""
    ballot: tuple = (0, 0)
    lseq: int = 0


@dataclass(slots=True)
class ReadProbe(Msg):
    """Client -> replica: report your commit frontier for ``key`` (quorum
    reads).  ``rid`` ties replies to one read attempt across rinse rounds."""
    key: int = 0
    rid: int = 0


@dataclass(slots=True)
class ReadReply(Msg):
    """Replica -> client: per-key frontier snapshot.  ``applied`` is the
    position of the latest locally-applied write to the key, ``accepted``
    the highest position the replica knows MIGHT hold a write to the key
    (accepted-but-not-applied).  The client rinses (re-probes) while any
    quorum member's ``accepted`` exceeds the quorum's max ``applied``."""
    rid: int = 0
    key: int = 0
    applied: int = -1
    accepted: int = -1
    value: Optional[bytes] = None
    wtag: Any = None          # (client_id, seq) of the witnessed write

    def wire_size(self) -> int:
        return HEADER_BYTES + 16 + (len(self.value) if self.value else 0)


# ---------------------------------------------------------------- Pig overlay
@dataclass(slots=True)
class PigFanout(Msg):
    """Leader -> relay: carry an inner message + the Pig round id (§3.1)."""
    pig_id: int = 0
    group: int = 0
    inner: Any = None
    required: int = 0   # acks the relay must gather before replying (PRC, §4.1)

    def wire_size(self) -> int:
        return HEADER_BYTES + 8 + self.inner.wire_size()


@dataclass(slots=True)
class PigRelayed(Msg):
    """Relay -> group peers: the re-broadcast inner message."""
    pig_id: int = 0
    relay: int = -1
    inner: Any = None

    def wire_size(self) -> int:
        return HEADER_BYTES + 8 + self.inner.wire_size()


class PigReply(Msg):
    """Follower -> relay: reply to the inner message, tagged with pig_id.
    Hand-written init like P2b: one instance per follower reply."""
    __slots__ = ("pig_id", "inner")

    def __init__(self, pig_id=0, inner=None):
        self.src = -1
        self._cost = -1.0
        self._tctx = None
        self.pig_id = pig_id
        self.inner = inner

    def wire_size(self) -> int:
        return HEADER_BYTES + 8 + self.inner.wire_size()


@dataclass(slots=True)
class PigAggregate(Msg):
    """Relay -> leader: aggregated acks.

    Deduplicated per §6.4: carries vote summary + ids of *missing* voters
    (usually empty), not the full voter list.
    """
    pig_id: int = 0
    group: int = 0
    ballot: tuple = (0, 0)
    slot: int = -1
    acks: int = 0
    voters: tuple = ()       # kept for leader-side dedup across retries
    missing: tuple = ()
    timed_out: bool = False  # True => missing nodes are failure suspects (§4.2)
    reject: bool = False
    reject_ballot: tuple = (0, 0)

    def wire_size(self) -> int:
        # leader needs only the missing-voter list on the wire (§6.4);
        # the voters tuple models state the leader can reconstruct.
        return HEADER_BYTES + 16 + 2 * len(self.missing)


# ---------------------------------------------------------------- EPaxos
@dataclass(slots=True)
class PreAccept(Msg):
    inst: tuple = (0, 0)      # (replica, instance_no)
    ballot: tuple = (0, 0)
    cmd: Command = None
    deps: frozenset = frozenset()
    seq: int = 0
    n_cluster: int = 0        # drives the O(N) serialization cost (§5.3)

    def wire_size(self) -> int:
        return HEADER_BYTES + self.cmd.wire_size() + 12 * max(len(self.deps), 1) + 8 * self.n_cluster


@dataclass(slots=True)
class PreAcceptReply(Msg):
    inst: tuple = (0, 0)
    ok: bool = True
    deps: frozenset = frozenset()
    seq: int = 0
    n_cluster: int = 0

    def wire_size(self) -> int:
        return HEADER_BYTES + 12 * max(len(self.deps), 1) + 8 * self.n_cluster


@dataclass(slots=True)
class EAccept(Msg):
    inst: tuple = (0, 0)
    ballot: tuple = (0, 0)
    cmd: Command = None       # None = recovery no-op
    deps: frozenset = frozenset()
    seq: int = 0
    n_cluster: int = 0

    def wire_size(self) -> int:
        return (HEADER_BYTES
                + (self.cmd.wire_size() if self.cmd is not None else 0)
                + 12 * max(len(self.deps), 1) + 8 * self.n_cluster)


@dataclass(slots=True)
class EAcceptReply(Msg):
    inst: tuple = (0, 0)
    ok: bool = True
    # ballot of the accept round being answered: (0, 0) on the original
    # coordinator's slow path, the prepare ballot on recovery rounds (so a
    # recoverer can tell its own round's acks from stale ones); rejects
    # carry the replier's promised ballot instead
    ballot: tuple = (0, 0)


@dataclass(slots=True)
class ECommit(Msg):
    inst: tuple = (0, 0)
    cmd: Command = None       # None = recovery no-op
    deps: frozenset = frozenset()
    seq: int = 0
    n_cluster: int = 0

    def wire_size(self) -> int:
        return (HEADER_BYTES
                + (self.cmd.wire_size() if self.cmd is not None else 0)
                + 12 * max(len(self.deps), 1) + 8 * self.n_cluster)


@dataclass(slots=True)
class EPrepare(Msg):
    """Explicit-prepare (EPaxos recovery, §4.7 of Moraru et al.): a peer
    suspecting a crashed command leader raises the per-instance ballot and
    asks everyone for their view of the instance."""
    inst: tuple = (0, 0)
    ballot: tuple = (0, 0)
    n_cluster: int = 0        # dependency bookkeeping cost ∝ N, like PreAccept

    def wire_size(self) -> int:
        return HEADER_BYTES + 16


@dataclass(slots=True)
class EPrepareReply(Msg):
    """A replica's instance snapshot: its state plus the attributes and the
    ballot they were (pre-)accepted at.  ``ok=False`` rejects a stale
    prepare ballot (``ballot`` then carries the replier's promise)."""
    inst: tuple = (0, 0)
    ok: bool = True
    ballot: tuple = (0, 0)
    state: str = "none"
    cmd: Command = None
    deps: frozenset = frozenset()
    seq: int = 0
    accepted_ballot: tuple = (0, 0)
    n_cluster: int = 0

    def wire_size(self) -> int:
        return (HEADER_BYTES + 24
                + (self.cmd.wire_size() if self.cmd is not None else 0)
                + 12 * max(len(self.deps), 1) + 8 * self.n_cluster)


# ---------------------------------------------------------------- cost model
# message classes carrying an O(N) dependency payload (resolved lazily so
# protocol modules can add their own Msg subclasses without registering here)
_HAS_N_CLUSTER: dict = {}
# wrapper classes whose wire size is HEADER + 8 + inner.wire_size()
_PIG_WRAPPERS = frozenset((PigFanout, PigRelayed, PigReply))


@dataclass
class CostModel:
    """CPU seconds charged per message at each endpoint.

    cpu = base + per_byte * wire_size       (serialize at src, parse at dst)

    Defaults give ~10us per small message per endpoint => a 25-node Paxos
    leader handling 2R+2=50 messages/request saturates at ~2000 req/s,
    matching §2.2 and Fig 9.

    Hot-path note: classes that inherit ``Msg.wire_size`` have a constant
    wire size, so their cost is computed once and cached per class (about
    half of all hops are fixed-size replies: P1a/P2b/P3/EAcceptReply/...).
    Costs depend only on the frozen constants above; mutate them only by
    constructing a fresh CostModel.
    """
    base: float = 10e-6
    per_byte: float = 0.7e-9        # ~1.4 GB/s serialization bandwidth
    epaxos_extra_per_node: float = 1.2e-6   # dependency-tracking cost ∝ N (§5.3)
    epaxos_exec_graph: float = 14e-6        # per-op dependency graph bookkeeping

    def __post_init__(self):
        self._fixed: dict = {}      # class -> constant cpu cost
        self._wrap_fixed: dict = {} # (wrapper cls, inner cls) -> cpu cost

    def cpu_cost(self, msg: Msg) -> float:
        c = msg._cost
        if c >= 0.0:
            return c                # instance cache (broadcast reuse)
        cls = msg.__class__
        c = self._fixed.get(cls)
        if c is not None:
            msg._cost = c
            return c
        if cls in _PIG_WRAPPERS:
            # Pig wrappers: wire = HEADER + 8 + inner.wire_size(); constant
            # per (wrapper, inner) pair when the inner is header-only
            icls = msg.inner.__class__
            key = (cls, icls)
            c = self._wrap_fixed.get(key)
            if c is None:
                if icls.wire_size is Msg.wire_size:
                    c = self.base + self.per_byte * (2 * HEADER_BYTES + 8)
                    self._wrap_fixed[key] = c
                else:
                    c = self.base + self.per_byte * msg.wire_size()
            msg._cost = c
            return c
        c = self.base + self.per_byte * msg.wire_size()
        has_n = _HAS_N_CLUSTER.get(cls)
        if has_n is None:
            has_n = _HAS_N_CLUSTER.setdefault(cls, hasattr(msg, "n_cluster"))
        if has_n:
            c += self.epaxos_extra_per_node * msg.n_cluster
        elif cls.wire_size is Msg.wire_size:
            self._fixed[cls] = c    # header-only message: constant per class
        msg._cost = c
        return c
