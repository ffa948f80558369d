"""One grid under ``torch.profiler`` with device activity only, and the
harness's own host spans around the entry's stages.

The device's clock is tied to the host's by two marker kernels, each
launched right after a ``synchronize`` at a known host time, one before
the grid and one after it.  Each idle gap of the device is then named by
the innermost host span that was open at its middle.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

from . import yardstick

OUTSIDE = "entry, outside the spans"


class Spans:
    """(label, start, end, depth) host intervals, perf_counter seconds."""

    def __init__(self):
        self.spans = []
        self.depth = 0

    def wrap(self, label, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
                self.spans.append((label, t0, time.perf_counter(),
                                   self.depth))
        return spanned

    def label_at(self, t):
        best = None
        for label, s, e, d in self.spans:
            if s <= t < e and (best is None or d > best[1]):
                best = (label, d)
        return best[0] if best else OUTSIDE


@contextlib.contextmanager
def spans_around(module, stages):
    """Wrap ``module``'s functions named in ``stages`` ({label: names})
    in spans for the duration of the block; names the module lacks are
    left out."""
    spans = Spans()
    saved = {}
    for label, names in stages.items():
        for name in names:
            if hasattr(module, name):
                saved[name] = getattr(module, name)
                setattr(module, name, spans.wrap(label, saved[name]))
    try:
        yield spans
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _marker(device):
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.ones(1, device=device)
    return t


def _device_events(prof):
    """(name, start_us, end_us) of every device activity of a finished
    profile."""
    out = []
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s = e.start_ns() / 1e3
                out.append((e.name(), s, s + e.duration_ns() / 1e3))
        return out
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def profile_grid(run, module, stages, device, log):
    """``run()`` (one whole grid) under the profiler.  Returns (run's
    result, trace dict): device events as (name, start_s, end_s) on the
    host's clock, the host spans, the traced window [lo, hi) and its
    length."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = _marker(device)
        with spans_around(module, stages) as spans:
            result = run()
        h1 = _marker(device)
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    events = sorted(_device_events(prof), key=lambda e: e[1])
    if len(events) < 2:
        raise RuntimeError("the profiler recorded no device activity")
    m0, m1 = events[0], events[-1]
    scale = (h1 - h0) / max((m1[1] - m0[1]) * 1e-6, 1e-12)

    def host(us):
        return h0 + (us - m0[1]) * 1e-6 * scale

    kernels = [(n, host(s), host(e)) for n, s, e in events[1:-1]]
    log(f"trace: {len(events)} device events read in "
        f"{time.perf_counter() - t0:.3f} s; device-to-host clock scale "
        f"{scale:.9f}")
    lo, hi = host(m0[2]), host(m1[1])
    return result, {"events": kernels, "spans": spans, "lo": lo, "hi": hi,
                    "window_s": hi - lo}


def breakdown(trace, top: int = 10):
    """The device operations that took most time, and the idle gaps: the
    idle seconds under each host span, then the longest single gaps."""
    by_name = {}
    for n, s, e in trace["events"]:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = yardstick.idle_gaps([(s, e) for _, s, e in trace["events"]],
                               trace["lo"], trace["hi"])
    spans = trace["spans"]
    labelled = [(spans.label_at((a + b) / 2), b - a) for a, b in gaps]
    per_label = {}
    for label, d in labelled:
        per_label[label] = per_label.get(label, 0.0) + d
    sums = sorted(per_label.items(), key=lambda kv: -kv[1])
    idle = [[f"{label}: all gaps", s] for label, s in sums]
    longest = sorted(labelled, key=lambda x: -x[1])
    idle += [[f"{label}: one gap", d]
             for label, d in longest[:max(0, top - len(idle))]]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": idle[:top]}
