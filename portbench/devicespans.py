"""The device's busy time inside the port's device spans, for the EPaxos
cell's readers: the quantity ``programspans.device_busy_ms`` reads, found
by three unions of intervals (the busy time inside the spans is
|busy| + |spans| - |busy or spans|).  An EPaxos grid of the cell has ~1.5
million device events, on which this takes about a fifth of that
reader's time, and a traced run reads it three times."""
from __future__ import annotations

from . import programspans, yardstick


def busy_ms(ctx, name: str, first=None):
    """Milliseconds in which the device ran something inside the profiled
    grid's ``name`` device intervals, or inside the first ``first`` of
    them; None without them, or with fewer than ``first``."""
    found = programspans.traced_grid(ctx)
    ivs = sorted((s, e) for n, s, e in found[1] if n == name) if found else []
    ivs = ivs[:first]
    if not ivs or len(ivs) < (first or 0):
        return None
    busy = [(s, e) for _, s, e in ctx["trace"]["events"]]
    return 1e3 * (yardstick.interval_union_s(busy)
                  + yardstick.interval_union_s(ivs)
                  - yardstick.interval_union_s(busy + ivs))
