"""Critical-path attribution: decompose commit latency into segments.

Each finished trace is a set of closed spans inside the root op window
``[t0, t1]``.  :func:`decompose` sweeps the window's elementary intervals
and charges each to the highest-priority span category covering it —
``svc`` (CPU service) > ``ser`` (CPU serialize) > ``queue`` (CPU queue
wait) > ``relay`` (Pig aggregation wait) > ``net`` (wire latency) — with
the uncovered residual charged to ``wait`` (client-side or scheduling
slack the engines don't attribute).  Because the sweep partitions
``[t0, t1]`` exactly, the segments sum to the measured op latency by
construction (tested to float tolerance in ``tests/test_torch_obs.py``).

The priority order resolves overlap the way a bottleneck hunt wants it:
when a hop is simultaneously "on the wire" and "waiting in a relay
window", the relay window is the actionable cause; when CPU service
overlaps anything, the CPU is the scarce resource (the paper's Eq. 1-3
bottleneck terms are all CPU terms).
"""
from __future__ import annotations

from typing import Dict, List

# Highest priority first; "wait" is the implicit residual.
CAT_PRIORITY = ("svc", "ser", "queue", "relay", "net")
SEGMENTS = CAT_PRIORITY + ("wait",)

_RANK = {c: i for i, c in enumerate(CAT_PRIORITY)}
_NCAT = len(CAT_PRIORITY)


def decompose(spans: List[list]) -> Dict[str, float]:
    """Segment one trace's latency; ``spans`` is ``Tracer.trace_of(tid)``.

    Returns ``{cat: seconds}`` over :data:`SEGMENTS` plus ``"total"``;
    the segment values sum to ``total`` exactly (modulo float addition).
    Raises ``ValueError`` on an unfinished root."""
    root = spans[0]
    t0, t1 = root[4], root[5]
    if t1 is None:
        raise ValueError("cannot decompose an unfinished trace")
    out = {c: 0.0 for c in SEGMENTS}
    out["total"] = t1 - t0
    if t1 <= t0:
        return out

    # Sweep events: (time, +1/-1, rank), clipped to the op window.
    evs = []
    for sp in spans:
        cat = sp[2]
        r = _RANK.get(cat)
        if r is None or sp[5] is None:
            continue
        a = sp[4] if sp[4] > t0 else t0
        b = sp[5] if sp[5] < t1 else t1
        if b > a:
            evs.append((a, 1, r))
            evs.append((b, -1, r))
    if not evs:
        out["wait"] = t1 - t0
        return out
    evs.sort()

    active = [0] * _NCAT
    prev = t0
    k = 0
    n_ev = len(evs)
    while k < n_ev:
        t = evs[k][0]
        if t > prev:
            top = next((i for i in range(_NCAT) if active[i]), None)
            out[CAT_PRIORITY[top] if top is not None else "wait"] += t - prev
            prev = t
        # apply every event at this timestamp before charging further
        while k < n_ev and evs[k][0] == t:
            active[evs[k][2]] += evs[k][1]
            k += 1
    if t1 > prev:
        top = next((i for i in range(_NCAT) if active[i]), None)
        out[CAT_PRIORITY[top] if top is not None else "wait"] += t1 - prev
    return out


def critical_path(tracer) -> dict:
    """Aggregate decomposition over every finished trace.

    Returns per-op rows (trace id, latency, segments) and the mean
    seconds-per-op by segment — the repo's empirical counterpart to the
    paper's Eq. 1-3 analytical decomposition."""
    ops = []
    sums = {c: 0.0 for c in SEGMENTS}
    for tid in tracer.finished:
        segs = decompose(tracer.trace_of(tid))
        total = segs.pop("total")
        for c in SEGMENTS:
            sums[c] += segs[c]
        ops.append({"trace": tid, "latency_ms": total * 1e3,
                    "segments_ms": {c: segs[c] * 1e3 for c in SEGMENTS}})
    n = len(ops)
    return {
        "n_ops": n,
        "mean_ms": {c: (sums[c] / n * 1e3 if n else 0.0) for c in SEGMENTS},
        "ops": ops,
    }
