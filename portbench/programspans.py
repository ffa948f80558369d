"""The port's own spans of the profiled grid, for the readers that name a
span of the program.

While ``torch.profiler`` is on, the port records each grid by itself
(``repro_torch.core.spans``): host spans on ``time.perf_counter``, the
clock ``profiling.profile_grid`` puts the traced grid's device events on,
and the CUDA-event intervals of its device spans, put on the same clock
from an origin event the port records at a known host time.  This module
finds that recording among the loaded modules, so nothing here imports
the port.
Against a port without it, or with a recording that is not the traced
grid's, it finds nothing, and every reader of it returns None.
"""
from __future__ import annotations

import sys

from . import yardstick

MODULE = "repro_torch.core.spans"


def traced_grid(ctx):
    """The profiled grid's spans, as (host, device): lists of (name, t0,
    t1) in seconds; None without a trace, or unless the port's last
    recording holds exactly one grid whose ``entry`` span is centred
    inside the traced window."""
    t = ctx.get("trace")
    last = getattr(sys.modules.get(MODULE), "last", None)
    rec = last() if t and callable(last) else None
    if rec is None:
        return None
    grids = {s.grid for s in rec.spans if s.name == "entry"
             and t["lo"] <= (s.t0 + s.t1) / 2 < t["hi"]}
    if len(grids) != 1:
        return None
    (g,) = grids
    return ([(s.name, s.t0, s.t1) for s in rec.spans if s.grid == g],
            [(name, t0, t1) for gd, name, t0, t1 in rec.device if gd == g])


def host_ms(ctx, name: str):
    """Milliseconds of the profiled grid's ``name`` host spans, summed;
    None without them."""
    found = traced_grid(ctx)
    if found is None:
        return None
    ivs = [(t0, t1) for n, t0, t1 in found[0] if n == name]
    return 1e3 * sum(t1 - t0 for t0, t1 in ivs) if ivs else None


def per_step(ctx, ms):
    """``ms`` over the profiled grid's scan steps; None without either."""
    steps = ctx["trace"]["scan_steps"] if ms is not None else 0
    return ms / steps if steps else None


def _union(intervals):
    """Disjoint sorted [start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_s(a, b) -> float:
    """Seconds two lists of disjoint sorted intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_busy_ms(ctx, name: str):
    """Milliseconds in which the device ran something inside the profiled
    grid's ``name`` device intervals: the trace's busy time under them,
    so the stream's idle gaps inside an interval are left out; None
    without such intervals (a run on the CPU records none)."""
    found = traced_grid(ctx)
    ivs = [(s, e) for n, s, e in found[1] if n == name] if found else []
    if not ivs:
        return None
    busy = _union((s, e) for _, s, e in ctx["trace"]["events"])
    return 1e3 * _overlap_s(busy, _union(ivs))


def idle_outside_pct(ctx):
    """Percent of the traced window in which the device is idle and no
    span of the program is open."""
    found = traced_grid(ctx)
    if found is None or ctx["trace"]["window_s"] <= 0:
        return None
    t = ctx["trace"]
    gaps = yardstick.idle_gaps([(s, e) for _, s, e in t["events"]],
                               t["lo"], t["hi"])
    cover = _union((s, e) for _, s, e in found[0])
    outside = sum(b - a for a, b in gaps) - _overlap_s(
        [list(g) for g in gaps], cover)
    return 100.0 * outside / t["window_s"]
