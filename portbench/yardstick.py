"""The benchmark's frozen arithmetic: the device's peaks, the bytes the
fan-in's work needs, the union of device intervals and the per-step
ratios.  Metric readers take their numbers from here, so that a change to
the program cannot move the yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit
HBM_BYTES_S = 3.35e12


def interval_union_s(intervals) -> float:
    """Seconds covered by the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(intervals, lo: float, hi: float):
    """The [start, end) gaps in [lo, hi) that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def per_step_ms(seconds: float, steps: int):
    """Milliseconds a scan step, or None without steps."""
    return 1e3 * seconds / steps if steps else None


def window_ms_per_step(ctx, key: str):
    """The window's grids' ``key`` seconds (``wall_s``, ``cpu_s``) over
    their scan steps, in milliseconds."""
    w = ctx["window"]
    return per_step_ms(sum(g[key] for g in w), sum(g["scan_steps"] for g in w))


def is_kernel(name: str) -> bool:
    """A device activity that is a kernel, not a copy or fill."""
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def kernels_per_step(ctx):
    """Kernels of the profiled grid over its scan steps."""
    t = ctx["trace"]
    if not t or not t["scan_steps"]:
        return None
    n = sum(1 for name, _, _ in t["events"] if is_kernel(name))
    return n / t["scan_steps"] if n else None


def idle_share_pct(ctx):
    """Percent of the profiled grid's window with nothing on the device."""
    t = ctx["trace"]
    if not t or not t["events"] or t["window_s"] <= 0:
        return None
    busy = interval_union_s([(s, e) for _, s, e in t["events"]])
    return 100.0 * (1.0 - busy / t["window_s"])


def fanin_share_pct(ctx, kernel: str, launches_a_step: int, launch_bytes):
    """A fan-in kernel's roofline share over the profiled grid's first
    pass (a retry runs fewer cells): its launches are the first
    ``launches_a_step`` x the fewest scan steps any grid of the run took;
    ``launch_bytes(shapes)`` is what one launch's work needs."""
    t = ctx["trace"]
    if not t:
        return None
    ev = sorted((s, e) for name, s, e in t["events"] if kernel in name)
    steps = min([g["scan_steps"] for g in ctx["window"]] + [t["scan_steps"]])
    n = min(len(ev), steps * launches_a_step)
    if n == 0:
        return None
    return roofline_share_pct(n * launch_bytes(ctx["shapes"]),
                              sum(e - s for s, e in ev[:n]))


def fanin_group_bytes(C: int, B: int, F: int, G: int) -> int:
    """Bytes one scan step's grouped fan-in needs, each read or written
    once: the R = C x B rows' F reply times (f32) and peer masks (one byte
    each), the G relay backlogs a row (f32), a row's anchor (f32), a
    cell's slot-to-group map (F int32), group starts and caps (2 G int32)
    and three scalars (f32); the output, G f32 a row."""
    R = C * B
    return (4 * R * F + R * F + 4 * R * G + 4 * C * F + 8 * C * G + 12 * C
            + 4 * R + 4 * R * G)


def fanin_epaxos_bytes(rows: int, F: int) -> int:
    """Bytes one EPaxos quorum fan-in needs: each row's F reply times
    (f32), its six scalars (backlog, the drain rate, the M/D/1 floor, the
    service time, the anchor, the cap) and its one output (f32)."""
    return 4 * (rows * F + 7 * rows)


def roofline_share_pct(nbytes: float, device_s: float):
    """The least time for ``nbytes`` at the HBM peak over the device time,
    in percent; None without device time."""
    if device_s <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_S) / device_s
