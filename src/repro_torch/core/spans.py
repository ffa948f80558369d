"""Spans of the batch entry (``core/vectorsim.py``): where a grid's host
time goes, and the device time of the blocks that ask for it.

    with spans.recording() as rec:
        vectorsim.simulate_scenario(...)
    rec.spans     # Span(grid, name, parent, t0, t1), time.perf_counter s
    rec.device    # (grid, name, t0, t1): device spans' CUDA-event pairs

Recording is off by default.  ``span`` then returns one shared context
that does nothing: one module-global test a span, no allocation, no CUDA
event.  ``recording()`` turns it on for its block.  A grid that starts
while ``torch.profiler`` is on and no recording is open records itself,
and ``last()`` returns that recording once the grid has ended: its spans
lie on the host clock that a device trace is tied to, so each idle gap of
the trace falls under the span that was open.

``grid`` is one id a ``simulate_scenario`` call (its root span,
``entry``); ``parent`` is the index in ``rec.spans`` of the enclosing
span, None for a root.  A device span's CUDA events are put on the same
clock: before the first device span of a recording on a device, the
device is synchronized and an origin event recorded at a known host
time; an event's time is that host time plus its elapsed time from the
origin.  Such an interval is the
time the span's launches held the stream, idle gaps between them
included; the device's busy time inside it takes the device trace.
The names (what reads each):

* ``entry``: the whole call (``idle_outside_spans_share``);
* ``lowering``: ``build_config``; the configs' rows, once a grid, and
  each chunk's columns, their copies to the device and the gathers there
  (``lowering_ms_per_grid``);
* ``budget``: the padded shapes and the scan-step budget estimated from
  each distinct (config, clients) point (``budget_ms_per_grid``);
* ``step_loop``: ``_run_cells``, the kernel's set-up and its loop;
* ``fanin_setup``: the grouped fan-in's layout check, once a pass;
* ``draws``: each block of threefry draws, a host span and, on the card,
  a device interval (``draws_host_ms_per_step``,
  ``draws_device_ms_per_step``; ``draws_device_ms_per_step.epaxos`` in
  the EPaxos loop);
* ``keys``: the EPaxos loop's per-key conflict tracking, once a scan
  step, a host span and, on the card, a device interval
  (``keys_device_ms_per_step.epaxos``, ``keys_roofline.epaxos``);
* ``summary``: ``_summarize``;
* ``collect``: the results brought to the host (the wait for the device
  to drain, then the copies);
* ``retry``: one pass over a chunk's exhausted cells;
* ``units``: ``simulate_scenario``'s per-cell result dicts
  (``units_ms_per_grid``).

The metrics are ``portbench/metrics/<name>.py``; the trace command
(``experiments/trace.py``) prints every name's count, total and self
time.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

NAMES = ("entry", "lowering", "budget", "step_loop", "fanin_setup", "draws",
         "keys", "summary", "collect", "retry", "units")


class Span(NamedTuple):
    grid: int
    name: str
    parent: Optional[int]
    t0: float
    t1: float


class _Off:
    """The context every span is while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_rec: Optional["Recorder"] = None     # the open recording
_last: Optional["Recorder"] = None    # the last one closed


class _Open:
    """One span of an open recording, with a CUDA event pair around its
    launches when it names a CUDA device."""
    __slots__ = ("rec", "name", "device", "ev0")

    def __init__(self, rec, name, device):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self):
        if self.device is not None:
            self.rec._origin(self.device)
        self.rec._push(self.name)
        if self.device is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.device))

    def __exit__(self, *exc):
        rec = self.rec
        if self.device is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.device))
            rec._events.append((rec._grid, self.name, self.device,
                                self.ev0, ev1))
        rec._pop()
        return False


class Recorder:
    """The spans of one recording: host spans as they close, device
    intervals once the recording has ended."""

    def __init__(self):
        self.spans: list = []
        self.device: list = []
        self._events: list = []
        self._origins: dict = {}
        self._stack: list = []
        self._grid = -1
        self._grids = 0

    def _push(self, name):
        parent = self._stack[-1] if self._stack else None
        self._stack.append(len(self.spans))
        self.spans.append([self._grid, name, parent, time.perf_counter(),
                           None])

    def _pop(self):
        self.spans[self._stack.pop()][4] = time.perf_counter()

    def _origin(self, device):
        if device not in self._origins:
            torch.cuda.synchronize(device)
            ev = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            ev.record(torch.cuda.current_stream(device))
            self._origins[device] = (t, ev)

    @contextlib.contextmanager
    def grid(self):
        """A new grid id and its root span ``entry``."""
        outer, self._grid = self._grid, self._grids
        self._grids += 1
        try:
            with _Open(self, "entry", None):
                yield
        finally:
            self._grid = outer

    def table(self) -> list:
        """(name, count, total s, self s, device ms) a span name, in
        ``NAMES`` order: a span's self time is its duration less its
        children's; device ms sums the name's CUDA-event intervals (None
        where none was recorded)."""
        child = [0.0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None:
                child[s.parent] += s.t1 - s.t0
        rows: dict = {}
        for s, c in zip(self.spans, child):
            r = rows.setdefault(s.name, [0, 0.0, 0.0, None])
            r[0] += 1
            r[1] += s.t1 - s.t0
            r[2] += s.t1 - s.t0 - c
        for _, name, t0, t1 in self.device:
            rows[name][3] = (rows[name][3] or 0.0) + 1e3 * (t1 - t0)
        return [(n, *rows[n]) for n in NAMES if n in rows]

    def _close(self):
        # one synchronize a device, then every interval is read
        for dev in self._origins:
            torch.cuda.synchronize(dev)
        dev_s = []
        for g, name, dev, ev0, ev1 in self._events:
            t, origin = self._origins[dev]
            dev_s.append((g, name, t + 1e-3 * origin.elapsed_time(ev0),
                          t + 1e-3 * origin.elapsed_time(ev1)))
        self.device = dev_s
        self._events = []
        self._origins = {}
        self.spans = [Span(*s) for s in self.spans]


def span(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` while a recording is open; with a CUDA
    ``device``, also a CUDA-event interval around the block's launches on
    that device's current stream."""
    if _rec is None:
        return _OFF
    return _Open(_rec, name, device if device is not None
                 and device.type == "cuda" else None)


@contextlib.contextmanager
def recording():
    """Record every span of the block; yields the ``Recorder``.  On exit
    the device intervals are read (after a synchronize) and the recording
    becomes ``last()``."""
    global _rec, _last
    if _rec is not None:
        raise RuntimeError("spans: a recording is already open")
    rec = _rec = Recorder()
    try:
        yield rec
    finally:
        _rec = None
        rec._close()
        _last = rec


@contextlib.contextmanager
def grid():
    """The root span of one ``simulate_scenario`` call.  With no recording
    open while ``torch.profiler`` is on, the grid is recorded by itself."""
    if _rec is not None:
        with _rec.grid():
            yield
    elif torch._C._autograd._profiler_enabled():
        with recording() as rec, rec.grid():
            yield
    else:
        yield


def last() -> Optional[Recorder]:
    """The last recording that ended, or None."""
    return _last
