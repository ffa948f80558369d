"""Per-op distributed tracing for the DES engines.

A *trace* is the span tree of one client op.  A *context* is the pair
``(trace_id, span_id)`` naming the span that caused whatever happens
next; it rides messages in the ``Msg._tctx`` slot (set once per message
by :meth:`Tracer.attach` — broadcasts share one instance, so the op that
caused a broadcast owns all its hops) and rides handler invocations
through the ambient ``Tracer.cur`` attribute, which the engines set for
the duration of each message handler.  Any ``Network.send`` during a
handler inherits the ambient context automatically, which is how a trace
follows the causal chain client -> leader -> relay -> follower -> ack
without per-protocol plumbing; protocols only stash contexts explicitly
where a *timer* re-drives work (slot retry, batch flush, relay timeout
flush).

The slot (rather than an id-keyed side table) is a hot-path decision:
the engine loops test ``msg._tctx`` once per event, so the whole
per-event cost of an installed tracer on an unsampled op is a slot load
— no ``id()`` call, no dict probe, no tuple key.

Everything here is observation only: no scheduler events, no RNG draws,
no message mutation.  A run with tracing enabled is bit-identical to one
without (pinned by ``tests/test_torch_obs.py``).

Span record layout (list, mutated once to close the span):
``[span_id, parent_id, cat, node, t0, t1]`` with ``cat`` one of
``op | ser | net | queue | svc | relay`` and ``t1 is None`` while open.
"""
from __future__ import annotations


class Tracer:
    """Samples client ops deterministically and collects span trees.

    Sampling is every-k-th-op (k = round(1/sample_rate)) so the tracer
    never consumes RNG; ``sample_rate=0`` keeps the tracer installed but
    samples nothing (hooks still run, contexts are never created).  When
    observability is disabled entirely, ``Network.tracer`` is ``None``
    and every engine hook is a single attribute test.
    """

    __slots__ = (
        "sample_every", "max_spans", "n_spans", "n_ops", "dropped",
        "spans", "meta", "_next_tid", "_hop", "cur",
        "_open", "finished",
    )

    def __init__(self, sample_rate: float = 1.0, max_spans: int = 200_000):
        if sample_rate <= 0.0:
            self.sample_every = 0          # sampling off
        else:
            self.sample_every = max(1, int(round(1.0 / sample_rate)))
        self.max_spans = max_spans
        self.n_spans = 0                   # spans across all traces
        self.n_ops = 0                     # client ops seen (sampled or not)
        self.dropped = 0                   # ops skipped due to max_spans
        self.spans = {}                    # tid -> [span records]
        self.meta = {}                     # tid -> {"client": .., "ok": ..}
        self._next_tid = 0
        self._hop = {}                     # id(msg) -> {dst: (tid, sid)}
        self.cur = None                    # ambient ctx inside a handler
        self._open = set()                 # tids still awaiting finish/abort
        self.finished = []                 # tids with a committed reply

    # -- op lifecycle -------------------------------------------------

    def begin_op(self, client: int, t0: float):
        """Maybe start a trace for a client op; returns a ctx or None."""
        self.n_ops += 1
        k = self.sample_every
        if k == 0 or self.n_ops % k:
            return None
        if self.n_spans >= self.max_spans:
            self.dropped += 1
            return None
        tid = self._next_tid
        self._next_tid = tid + 1
        self.spans[tid] = [[0, -1, "op", client, t0, None]]
        self.meta[tid] = {"client": client, "ok": None}
        self.n_spans += 1
        self._open.add(tid)
        return (tid, 0)

    def finish_op(self, ctx, t1: float):
        """Close a trace's root span at commit-reply time."""
        tid = ctx[0]
        root = self.spans[tid][0]
        if root[5] is None:
            root[5] = t1
            self.meta[tid]["ok"] = True
            self._open.discard(tid)
            self.finished.append(tid)

    def abort_op(self, ctx, t1: float):
        """Close a trace whose op was shed/abandoned (excluded from stats)."""
        tid = ctx[0]
        root = self.spans[tid][0]
        if root[5] is None:
            root[5] = t1
            self.meta[tid]["ok"] = False
            self._open.discard(tid)

    # -- message context ----------------------------------------------

    def attach(self, msg, ctx):
        """Bind a context to a message instance (first binding wins —
        broadcasts share one instance, so the op that caused the
        broadcast owns all its hops).  The context dies with the
        message; ``_hop`` entries (per-destination svc-span parents) are
        popped by the engine at each K_HANDLE, so neither needs a purge
        pass."""
        if msg._tctx is None:
            msg._tctx = ctx

    def ctx_of(self, msg):
        return msg._tctx

    # -- spans --------------------------------------------------------

    def add_span(self, ctx, cat: str, node: int, t0: float, t1: float) -> int:
        """Record a closed span under ctx's trace; returns its span id.

        Spans for already-closed traces are refused (returns -1): stale
        contexts linger on long-lived messages and in protocol stashes
        after an op finishes, and accepting their spans would grow finished
        traces without bound."""
        tid, parent = ctx
        if tid not in self._open:
            return -1
        sp = self.spans[tid]
        sid = len(sp)
        sp.append([sid, parent, cat, node, t0, t1])
        self.n_spans += 1
        return sid

    # -- accessors ----------------------------------------------------

    def trace_of(self, tid: int):
        """All spans of one trace (root first)."""
        return self.spans[tid]

    def op_latency(self, tid: int) -> float:
        root = self.spans[tid][0]
        return root[5] - root[4]

    def summary(self) -> dict:
        return {
            "ops_seen": self.n_ops,
            "ops_traced": self._next_tid,
            "ops_finished": len(self.finished),
            "ops_dropped": self.dropped,
            "spans": self.n_spans,
            "sample_every": self.sample_every,
        }
