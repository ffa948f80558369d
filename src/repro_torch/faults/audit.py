"""Consistency auditor: linearizability of the applied logs vs client
histories.

The cluster is a keyed register store, and linearizability is *composable*
(local): a multi-object history is linearizable iff every per-object
subhistory is.  The replicas' applied logs supply a candidate linearization
directly — the commit/execution order — so instead of a Wing–Gong search the
check verifies, per key, that this witness order is a *valid* linearization
of what the clients observed:

1. **replica agreement** — every node's per-key applied projection is a
   contiguous *window* of one merged witness order (for (Pig)Paxos the whole
   log is totally ordered; for EPaxos only interfering — same-key — commands
   are ordered, which is exactly the per-key projection).  Windows rather
   than prefixes because the replica set is time-varying: a node joined from
   a snapshot starts applying mid-stream, a removed node stops early, and
   the current leader applies at commit so it can run ahead of every
   follower's end;
2. **at-most-once** — no ``(client_id, seq)`` appears twice in the witness
   (client timeout-retries must not double-apply);
3. **durability** — every operation a client saw complete (``ok`` reply)
   appears in the log of some replica in the FINAL membership (a copy held
   only by a removed node does not count — the cluster walked away from it);
4. **real-time order** — if operation A completed before operation B was
   invoked (on the same key), A precedes B in the witness;
5. **read values** — every completed ``get`` returned the value written by
   the latest ``put`` preceding it in the witness (write identity comes
   from the per-op value tags the history-recording clients attach);
6. **non-logged reads** (``path`` in ``{"lease", "quorum"}`` — leased
   leader-local reads and client-side quorum reads never enter the log, so
   checks 1–5 cannot see them): each must return a value that (a) is a real
   witness put or the initial value (no phantoms), (b) is at least as fresh
   as every put — and every other non-logged read — that COMPLETED before
   this read was invoked (no stale reads, no read inversion), and (c) was
   not written by a put invoked after the read completed (no reads from the
   future).  These reads are exempt from the durability check: not being
   logged is their point.

Model boundary: the auditor sees the DES histories only — batch-backend
cells are never audited directly (their read/write semantics are
cross-checked against audited DES twins by the `reads` scenario family).

``check_history`` is a pure function over plain data so tests can feed it
deliberately corrupted fixtures; ``audit_cluster`` adapts a finished
``Cluster`` run (requires ``Cluster(record_history=True)``).

Copied from ``repro.faults.audit``; the port's tests hold it to the
reference's run, event for event.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_INF = float("inf")
_MAX_VIOLATIONS = 20


@dataclass
class AuditResult:
    ok: bool
    ops: int = 0                 # witness operations checked
    completed: int = 0           # client-completed operations
    reads_checked: int = 0       # gets with verified return values
    violations: List[str] = field(default_factory=list)

    def summary(self) -> dict:
        return {"ok": self.ok, "ops": self.ops, "completed": self.completed,
                "reads_checked": self.reads_checked,
                "violations": self.violations[:5]}


def client_histories(cluster) -> List[dict]:
    """Flatten the per-client operation records of a history-recording run."""
    out: List[dict] = []
    for cl in cluster.clients:
        if cl.history is None:
            raise ValueError("cluster was not run with record_history=True")
        out.extend(cl.history)
    return out


def applied_ops(node) -> List[Tuple[int, int, str, int]]:
    """A node's applied log as (client_id, seq, op, key) in apply order."""
    return [(c.client_id, c.seq, c.op, c.key) for _, c in node.applied_log]


def check_history(history: List[dict],
                  logs: List[List[Tuple[int, int, str, int]]],
                  durable_logs: Optional[List[int]] = None) -> AuditResult:
    """Run the five checks above.  ``history`` entries are dicts with keys
    ``cid, seq, op, key, invoke, resp, ok, rtag, wtag`` (``resp`` None for
    incomplete ops; ``rtag`` is the tag of the value a get returned, ``wtag``
    the tag a put wrote — both None-able).  ``logs`` is one (cid, seq, op,
    key) list per replica, in that replica's apply order.  ``durable_logs``
    names the indices into ``logs`` that count for the durability check —
    the membership in force at the end of the run; None means all replicas
    (the fixed-membership case)."""
    res = AuditResult(ok=True)
    hist: Dict[Tuple[int, int], dict] = {}
    for h in history:
        hist[(h["cid"], h["seq"])] = h
    res.completed = sum(1 for h in history if h.get("ok"))

    def violate(msg: str) -> None:
        res.ok = False
        if len(res.violations) < _MAX_VIOLATIONS:
            res.violations.append(msg)

    # per-key projections per replica (data ops only — membership-change
    # commands ride the same logs but their "key" is a node id, not a
    # register, so they are excluded from the linearizability space)
    proj: List[Dict[int, list]] = []
    for lg in logs:
        p: Dict[int, list] = {}
        for (cid, seq, op, key) in lg:
            if op in ("put", "get"):
                p.setdefault(key, []).append((cid, seq, op))
        proj.append(p)

    # non-logged reads (leased / quorum) never appear in any applied log:
    # they get their own per-key freshness checks against the witness below
    nl_reads: Dict[int, list] = {}
    for h in history:
        if (h.get("op") == "get" and h.get("ok")
                and h.get("path") in ("lease", "quorum")):
            nl_reads.setdefault(h["key"], []).append(h)

    for key in sorted({k for p in proj for k in p} | set(nl_reads)):
        ps = [p[key] for p in proj if key in p]
        if not ps:
            # only non-logged reads touched this key: empty witness, every
            # read must have returned the initial value
            self_reads = nl_reads.get(key, ())
            for h in self_reads:
                res.reads_checked += 1
                if h.get("rtag") is not None:
                    violate(f"phantom read on key {key}: {h.get('path')} "
                            f"read (client={h['cid']}, seq={h['seq']}) "
                            f"returned {h.get('rtag')} but no put to the "
                            f"key was ever applied")
            continue
        # Merge the per-replica orders into one witness.  Every replica's
        # projection must be a contiguous *window* of a single total order:
        # long-lived replicas hold prefixes, snapshot-joined replicas hold
        # infixes, and the current leader can overhang everyone's end (it
        # applies at commit; followers apply when the commit message lands).
        # Windows must agree wherever they overlap; consistent overhangs are
        # grafted onto the witness so the downstream checks cover them too.
        witness = list(max(ps, key=len))
        for p in ps:
            if not p or p == witness[:len(p)]:
                continue                              # prefix: the usual case
            pos = {e: i for i, e in enumerate(witness)}
            if p[0] in pos:
                j = pos[p[0]]
                k = min(len(p), len(witness) - j)
                ext = p[k:]                   # overhang past the witness end
                # grafted entries must be NEW — an "overhang" that re-orders
                # entries already in the witness is a cycle, i.e. divergence
                if p[:k] != witness[j:j + k] or any(e in pos for e in ext):
                    violate(f"replica divergence on key {key}: one replica's "
                            f"apply order conflicts with the merged witness "
                            f"order on their overlap")
                    break
                witness.extend(ext)
            elif witness[0] in p:
                j = p.index(witness[0])
                k = min(len(witness), len(p) - j)
                head, tail = p[:j], p[j + k:]
                if witness[:k] != p[j:j + k] or \
                        any(e in pos for e in head) or \
                        any(e in pos for e in tail):
                    violate(f"replica divergence on key {key}: one replica's "
                            f"apply order conflicts with the merged witness "
                            f"order on their overlap")
                    break
                witness[:0] = head            # p starts earlier: prepend head
                witness.extend(tail)
            # else: windows are disjoint — no shared history to cross-check
        last_put: Optional[Tuple[int, int]] = None
        max_invoke = -_INF
        seen_key = set()
        for (cid, seq, op) in witness:
            res.ops += 1
            if (cid, seq) in seen_key:
                violate(f"duplicate apply of op (client={cid}, seq={seq}) "
                        f"on key {key} — at-most-once violated")
            seen_key.add((cid, seq))
            h = hist.get((cid, seq))
            if h is not None and h.get("key") == key:
                resp = h["resp"] if (h.get("ok") and h["resp"] is not None) \
                    else _INF
                if resp < max_invoke:
                    violate(f"real-time order violated on key {key}: op "
                            f"(client={cid}, seq={seq}) completed at "
                            f"{resp:.6f} but follows an op invoked later "
                            f"in the witness order")
                if h["invoke"] > max_invoke:
                    max_invoke = h["invoke"]
                if op == "get" and h.get("ok"):
                    res.reads_checked += 1
                    if h.get("rtag") != last_put:
                        violate(f"stale/phantom read on key {key}: op "
                                f"(client={cid}, seq={seq}) returned "
                                f"{h.get('rtag')} but the witness says "
                                f"{last_put}")
            if op == "put":
                last_put = (cid, seq)

        # ---- check 6: non-logged (lease/quorum) reads on this key ----
        nls = nl_reads.get(key)
        if nls:
            put_pos: Dict[Tuple[int, int], int] = {}
            for i, (cid, seq, op) in enumerate(witness):
                if op == "put":
                    put_pos[(cid, seq)] = i
            # freshness floors by sweep: puts (and other non-logged reads)
            # that COMPLETED before a read's invoke lower-bound the witness
            # position the read must return
            puts_done = sorted(
                (hist[t]["resp"], i) for t, i in put_pos.items()
                if (ph := hist.get(t)) is not None and ph.get("ok")
                and ph["resp"] is not None)
            reads_done = sorted(
                (h["resp"], put_pos.get(h.get("rtag"), -1)) for h in nls)
            jp = jr = 0
            floor = rfloor = -1
            for h in sorted(nls, key=lambda h: h["invoke"]):
                inv = h["invoke"]
                while jp < len(puts_done) and puts_done[jp][0] < inv:
                    if puts_done[jp][1] > floor:
                        floor = puts_done[jp][1]
                    jp += 1
                while jr < len(reads_done) and reads_done[jr][0] < inv:
                    if reads_done[jr][1] > rfloor:
                        rfloor = reads_done[jr][1]
                    jr += 1
                rt = h.get("rtag")
                path = h.get("path")
                if rt is not None and rt not in put_pos:
                    violate(f"phantom read on key {key}: {path} read "
                            f"(client={h['cid']}, seq={h['seq']}) returned "
                            f"{rt}, which no replica ever applied")
                    continue
                res.reads_checked += 1
                rpos = put_pos[rt] if rt is not None else -1
                if rpos < floor:
                    violate(f"stale read on key {key}: {path} read "
                            f"(client={h['cid']}, seq={h['seq']}) returned "
                            f"witness position {rpos} ({rt}) but the put at "
                            f"position {floor} completed before the read "
                            f"was invoked")
                elif rpos < rfloor:
                    violate(f"stale read on key {key}: {path} read "
                            f"(client={h['cid']}, seq={h['seq']}) returned "
                            f"witness position {rpos} ({rt}) but an earlier "
                            f"completed read already saw position {rfloor} "
                            f"— read inversion")
                if rt is not None:
                    ph = hist.get(rt)
                    if (ph is not None and ph["invoke"] > h["resp"]):
                        violate(f"future read on key {key}: {path} read "
                                f"(client={h['cid']}, seq={h['seq']}) "
                                f"returned a value whose put was invoked "
                                f"after the read completed")

    # durability: every acknowledged op must survive on a replica that is
    # still a member at the end of the run
    idxs = range(len(logs)) if durable_logs is None else durable_logs
    durable_seen = set()
    for i in idxs:
        for (cid, seq, _op, _key) in logs[i]:
            durable_seen.add((cid, seq))
    where = "every replica's" if durable_logs is None \
        else "every final-membership replica's"
    for h in history:
        if h.get("path") in ("lease", "quorum"):
            continue   # non-logged read paths: durability does not apply
        if h.get("ok") and (h["cid"], h["seq"]) not in durable_seen:
            violate(f"acknowledged op (client={h['cid']}, seq={h['seq']}) "
                    f"on key {h['key']} is missing from {where} "
                    f"applied log — lost update")
    return res


def audit_cluster(cluster) -> AuditResult:
    """Audit one finished DES run (``Cluster(record_history=True)``).
    Clusters that track a time-varying membership restrict durability to the
    replicas in the final membership."""
    members = getattr(cluster, "members", None)
    durable = sorted(members) if members is not None else None
    return check_history(client_histories(cluster),
                         [applied_ops(nd) for nd in cluster.nodes],
                         durable_logs=durable)


def commit_apply_gap(cluster) -> int:
    """Committed-but-unapplied slots across the cluster after a run has
    settled (0 on a healthy drained run: every commit reaches the applied
    prefix).  Only meaningful for the (Pig)Paxos slot-log protocols."""
    gap = 0
    for nd in cluster.nodes:
        committed = getattr(nd, "committed", None)
        if committed is None:
            continue
        ci = nd.commit_index
        gap += sum(1 for s in committed if s > ci)
    return gap
