"""Time-series metrics: ring-buffer timelines sampled on a scheduler timer.

A :class:`Timelines` registry holds named :class:`Timeline` ring buffers
plus a :class:`LatencyGauge` (commit-latency EWMA + windowed p99).  The
sampler installed by :func:`install_sampler` reads cluster gauges every
``metrics_dt`` virtual seconds — per-node CPU busy fraction, leader queue
depth, in-flight slots, batch fill, shed count, commit-latency EWMA/p99 —
via ``Scheduler.every``.  ``Network.reset_stats`` calls
``Timelines.reset`` at the warmup boundary so warmup samples never
pollute the reported series.

The sampler timer adds K_CALL events (it never draws RNG and never
perturbs message order), so runs with ``metrics_dt > 0`` are not
event-count-identical to untraced runs; tracing alone (``sample_rate``)
stays fully event-neutral.
"""
from __future__ import annotations

_INF = float("inf")


class Timeline:
    """Fixed-capacity ring buffer of ``(t, value)`` samples."""

    __slots__ = ("cap", "_buf", "_i", "total")

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self._buf = []
        self._i = 0        # overwrite cursor once full
        self.total = 0     # samples ever added (including overwritten)

    def add(self, t: float, v: float) -> None:
        buf = self._buf
        if len(buf) < self.cap:
            buf.append((t, v))
        else:
            buf[self._i] = (t, v)
            self._i += 1
            if self._i == self.cap:
                self._i = 0
        self.total += 1

    def clear(self) -> None:
        self._buf.clear()
        self._i = 0

    def __len__(self) -> int:
        return len(self._buf)

    def items(self):
        """Samples in time order (oldest surviving first)."""
        buf = self._buf
        if len(buf) < self.cap:
            return list(buf)
        i = self._i
        return buf[i:] + buf[:i]

    def export(self) -> dict:
        pts = self.items()
        return {"t": [round(t, 9) for t, _ in pts],
                "v": [v for _, v in pts],
                "dropped": max(0, self.total - len(pts))}


class LatencyGauge:
    """Commit-latency EWMA plus a windowed p99 estimate.

    ``note`` is called per completed client op (cheap: one EWMA update
    and a ring write); ``p99_ms`` sorts the window on demand, so call it
    at sampler frequency, not per op."""

    __slots__ = ("alpha", "window", "_ring", "_i", "count", "ewma_s")

    def __init__(self, alpha: float = 0.1, window: int = 512):
        self.alpha = alpha
        self.window = window
        self._ring = []
        self._i = 0
        self.count = 0
        self.ewma_s = 0.0

    def note(self, lat_s: float) -> None:
        a = self.alpha
        self.ewma_s = lat_s if self.count == 0 else a * lat_s + (1 - a) * self.ewma_s
        ring = self._ring
        if len(ring) < self.window:
            ring.append(lat_s)
        else:
            ring[self._i] = lat_s
            self._i += 1
            if self._i == self.window:
                self._i = 0
        self.count += 1

    @property
    def ewma_ms(self) -> float:
        return self.ewma_s * 1e3

    def p99_ms(self) -> float:
        ring = self._ring
        if not ring:
            return 0.0
        s = sorted(ring)
        return s[min(len(s) - 1, int(0.99 * len(s)))] * 1e3

    def reset(self) -> None:
        self._ring.clear()
        self._i = 0
        self.count = 0
        self.ewma_s = 0.0


class Timelines:
    """Registry of named timelines + the shared latency gauge."""

    __slots__ = ("cap", "series", "latency", "counters")

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.series = {}               # name -> Timeline
        self.latency = LatencyGauge()
        self.counters = {}             # name -> running count

    def timeline(self, name: str) -> Timeline:
        tl = self.series.get(name)
        if tl is None:
            tl = self.series[name] = Timeline(self.cap)
        return tl

    def add(self, name: str, t: float, v: float) -> None:
        self.timeline(name).add(t, v)

    def bump(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def reset(self) -> None:
        """Called by ``Network.reset_stats`` at the warmup boundary."""
        for tl in self.series.values():
            tl.clear()
        self.latency.reset()
        self.counters.clear()

    def export(self) -> dict:
        return {
            "series": {k: tl.export() for k, tl in sorted(self.series.items())},
            "counters": dict(sorted(self.counters.items())),
            "latency": {"ewma_ms": self.latency.ewma_ms,
                        "p99_ms": self.latency.p99_ms(),
                        "count": self.latency.count},
        }


def _leader_gauges(nd):
    """(queue depth, in-flight, batch fill) at one node, protocol-agnostic.

    Mirrors ``runtime.policy._backlog`` but split into components so the
    timelines can show buffered vs in-flight work separately."""
    buf = len(getattr(nd, "_buf", ()))
    for b in getattr(nd, "_held", ()):
        buf += len(b)
    ns = getattr(nd, "next_slot", None)
    if ns is not None:
        inflight = max(0, ns - 1 - nd.commit_index)
    else:
        inflight = len(getattr(nd, "_pending_exec", ()))
    return buf + inflight, inflight, len(getattr(nd, "_buf", ()))


def install_sampler(cluster, tl: Timelines, dt: float,
                    stop_at: float = _INF) -> None:
    """Arm the timeline sampler on ``cluster``'s scheduler.

    Samples per-node CPU busy fraction (delta of ``Network._cpu_busy``
    over the period, robust to the warmup stats reset), leader queue
    depth / in-flight slots / batch fill, cumulative shed count (when an
    admission policy published its counters as ``cluster.admission_stats``),
    and the commit-latency EWMA/p99 gauges."""
    net = cluster.net
    sched = cluster.sched
    n = len(cluster.nodes)
    last_busy = [0.0] * n

    def _tick() -> None:
        t = sched.now
        busy = net._cpu_busy
        for i in range(n):
            d = busy[i] - last_busy[i]
            if d < 0.0:          # reset_stats zeroed the counters mid-window
                d = busy[i]
            last_busy[i] = busy[i]
            tl.add(f"busy_frac/{i}", t, d / dt)
        lid = cluster.leader_id
        if lid is not None and lid < len(cluster.nodes):
            nd = cluster.nodes[lid]
            qd, infl, fill = _leader_gauges(nd)
            tl.add("leader_qdepth", t, qd)
            tl.add("inflight_slots", t, infl)
            tl.add("batch_fill", t, fill)
        adm = getattr(cluster, "admission_stats", None)
        if adm:
            shed = sum(v for k, v in adm.items() if k.startswith("shed_"))
            tl.add("shed_total", t, shed)
        lat = tl.latency
        if lat.count:
            tl.add("commit_ewma_ms", t, lat.ewma_ms)
            tl.add("commit_p99_ms", t, lat.p99_ms())

    sched.every(dt, _tick, stop_at=stop_at)
