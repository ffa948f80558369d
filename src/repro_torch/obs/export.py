"""Exporters: Chrome/Perfetto trace-event JSON and artifact sections.

:func:`perfetto_events` flattens a :class:`~repro_torch.obs.trace.Tracer` into
the Chrome trace-event format (``"X"`` complete events, microsecond
``ts``/``dur``) that https://ui.perfetto.dev and ``chrome://tracing``
open directly.  Lanes: ``pid`` is the trace (op) id so each sampled op
gets its own process group, ``tid`` is the node id — so one op renders
as a waterfall of per-node rows, and the relay fan-in structure of
PigPaxos is visible at a glance.
"""
from __future__ import annotations

import json
from typing import List, Optional


def perfetto_events(tracer, limit: Optional[int] = None,
                    per_op_lanes: bool = True) -> List[dict]:
    """Closed spans as Chrome trace events, time-ordered.

    ``per_op_lanes=True`` groups rows per sampled op (pid = trace id);
    ``False`` collapses everything onto one timeline (pid = 0), which
    suits utilization views.  ``limit`` caps the event count for
    artifact embedding (earliest events win; the drop count is recorded
    on the caller's side via ``len`` before/after)."""
    evs = []
    for tid, spans in tracer.spans.items():
        pid = tid if per_op_lanes else 0
        for sid, parent, cat, node, t0, t1 in spans:
            if t1 is None:
                continue
            evs.append({
                "name": cat,
                "cat": cat,
                "ph": "X",
                "ts": round(t0 * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "pid": pid,
                "tid": int(node),
                "args": {"trace": tid, "span": sid, "parent": parent},
            })
    evs.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
    if limit is not None and len(evs) > limit:
        evs = evs[:limit]
    return evs


def write_perfetto(path: str, tracer, limit: Optional[int] = None) -> int:
    """Write a Perfetto-openable JSON file; returns the event count."""
    evs = perfetto_events(tracer, limit=limit)
    doc = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "otherData": tracer.summary(),
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(evs)


def obs_artifact_section(cluster, perfetto_limit: Optional[int] = None) -> dict:
    """The ``obs`` section of a ``repro-experiments/v1`` unit: tracer
    summary + critical-path means + timelines + per-node busy seconds.
    Safe to call on clusters without observability (returns {}).
    ``perfetto_limit`` defaults to the cluster's ``ObsConfig`` value."""
    tracer = getattr(cluster, "obs_tracer", None)
    tl = getattr(cluster, "obs_timelines", None)
    if tracer is None and tl is None:
        return {}
    if perfetto_limit is None:
        cfg = getattr(cluster, "obs_cfg", None)
        perfetto_limit = cfg.perfetto_limit if cfg is not None else 20_000
    out = {}
    if tracer is not None:
        from .critpath import critical_path
        cp = critical_path(tracer)
        out["trace"] = tracer.summary()
        out["critical_path"] = {"n_ops": cp["n_ops"], "mean_ms": cp["mean_ms"]}
        evs = perfetto_events(tracer, limit=perfetto_limit)
        out["perfetto"] = {"events": evs,
                           "truncated": tracer.n_spans > len(evs)}
    if tl is not None:
        out["timelines"] = tl.export()
    out["cpu_busy_s"] = {str(i): round(b, 9)
                         for i, b in cluster.net.cpu_busy.items()}
    return out
