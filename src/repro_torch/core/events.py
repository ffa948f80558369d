"""Deterministic discrete-event scheduler — slab-backed fast engine.

The entire protocol evaluation (Figs 8-17, Tables 1-2 of the paper) runs on
this virtual-time scheduler.  Determinism: a single seeded RNG drives every
stochastic choice (latency jitter, relay selection, client keys), and ties in
the event heap are broken by a monotone sequence number.

A copy of ``repro.core.events`` (the reference's engine, without its
calendar-queue experiment, which the engine never runs): the slab, the
heap entries, the sequence counter and the RNG are the reference's, so a
run makes the same events in the same order with the same draws.

Engine design:

  * Heap entries are plain tuples ``(t, seq, kind, a, b, c, d)`` — no
    closures are allocated on the message hot path.  ``kind`` selects an
    inline branch in the fused run loop (message events live in
    ``network.Network._run``); ``K_CALL`` entries carry a callable for
    timers and harness hooks.
  * Timer cancellation uses generation counters in a slot slab instead of
    the seed's unbounded ``_cancelled`` set: ``cancel`` bumps the slot's
    generation so the stale heap entry is skipped (and its slot recycled)
    when popped.  Memory is bounded by the peak number of outstanding
    timers; cancelling an already-fired timer is a no-op.
  * When a :class:`repro_torch.core.network.Network` is attached, ``run`` degrades
    to the network's fused loop, which executes transmit/arrive/handle
    events without any per-event Python function call.

The reference holds this engine trace-identical to its seed engine:
identical event times, identical tie-break order (the seq counter
advances at exactly the same points), and identical RNG consumption
order.  The port's tests hold it to the reference's, event for event.
"""
from __future__ import annotations

import heapq
from typing import Callable, Optional

import numpy as np

# Event kinds.  K_CALL is generic; the message kinds are produced and
# consumed by network.Network (kept here so the encoding has one home).
K_CALL = 0       # (t, seq, K_CALL, slot, gen, fn, None)
K_TRANSMIT = 1   # (t, seq, K_TRANSMIT, src, dst, msg, cpu_cost)
K_ARRIVE = 2     # (t, seq, K_ARRIVE, src, dst, msg, cpu_cost, t_transmit)
K_HANDLE = 3     # (t, seq, K_HANDLE, dst, msg, None, None)
K_DELIVER = 4    # (t, seq, K_DELIVER, dst, msg, None, None)  fast-path hop

_INF = float("inf")


class Scheduler:
    __slots__ = ("now", "_heap", "_seq", "rng", "_gen", "_free", "_net",
                 "events")

    def __init__(self, seed: int = 0):
        self.now: float = 0.0
        self._heap: list = []
        self._seq: int = 0
        self.rng = np.random.default_rng(seed)
        self._gen: list[int] = []      # timer slot -> generation counter
        self._free: list[int] = []     # recycled timer slots
        self._net = None               # set by network.Network
        self.events: int = 0           # cumulative executed events

    # ------------------------------------------------------------- timers
    def at(self, t: float, fn: Callable[[], None]) -> int:
        """Schedule ``fn`` at absolute virtual time ``t``. Returns a timer id."""
        gens = self._gen
        free = self._free
        if free:
            slot = free.pop()
            gen = gens[slot]
        else:
            slot = len(gens)
            gens.append(0)
            gen = 0
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, K_CALL, slot, gen, fn, None))
        return (slot << 32) | gen

    def after(self, dt: float, fn: Callable[[], None]) -> int:
        return self.at(self.now + dt, fn)

    def every(self, dt: float, fn: Callable[[], None],
              stop_at: float = _INF) -> Callable[[], None]:
        """Repeating timer: run ``fn`` every ``dt`` seconds, starting at
        ``now + dt``, until past ``stop_at`` or until the returned cancel
        callable is invoked.  Built on :meth:`after`, so it composes with
        the fused network loop and slab cancellation like any timer.
        Used by the observability sampler (`repro.obs.metrics`) and
        latency-driven admission control (`repro.runtime.policy`)."""
        state = {"on": True, "tid": None}

        def _fire() -> None:
            if not state["on"]:
                return
            fn()
            if state["on"] and self.now + dt <= stop_at:
                state["tid"] = self.after(dt, _fire)

        def cancel() -> None:
            state["on"] = False
            if state["tid"] is not None:
                self.cancel(state["tid"])

        state["tid"] = self.after(dt, _fire)
        return cancel

    def cancel(self, timer_id: int) -> None:
        """O(1) cancellation: bump the slot generation so the heap entry is
        discarded when popped.  Cancelling a fired/cancelled timer is a no-op
        (the generation no longer matches)."""
        slot = timer_id >> 32
        gen = timer_id & 0xFFFFFFFF
        if self._gen[slot] == gen:
            self._gen[slot] = gen + 1

    # ------------------------------------------------------------- running
    def run(self, until: float = _INF, max_events: Optional[int] = None) -> int:
        """Run events until virtual time ``until``; returns #events executed."""
        if self._net is not None:
            return self._net._run(until, max_events)
        return self._run_generic(until, max_events)

    def _run_generic(self, until: float, max_events: Optional[int]) -> int:
        """Timer-only loop, used when no network is attached."""
        n = 0
        heap = self._heap
        pop = heapq.heappop
        gens = self._gen
        free = self._free
        while heap:
            ev = heap[0]
            t = ev[0]
            if t > until:
                break
            pop(heap)
            slot = ev[3]
            gen = ev[4]
            free.append(slot)
            if gens[slot] != gen:
                continue               # cancelled: skip, don't count
            gens[slot] = gen + 1
            self.now = t
            ev[5]()
            n += 1
            if max_events is not None and n >= max_events:
                break
        if self.now < until < _INF:
            self.now = until
        self.events += n
        return n

    def idle(self) -> bool:
        return not self._heap
