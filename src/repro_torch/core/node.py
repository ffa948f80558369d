"""Node runtime: mailbox dispatch, timers, crash/recover, KV state machine
(copied from ``repro.core.node``)."""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional

from .events import Scheduler
from .messages import Command, Msg
from .network import Network


class KVStore:
    """The in-memory key-value state machine (mirrors Paxi's internal store)."""

    __slots__ = ("data", "applied_ops")

    def __init__(self):
        self.data: Dict[int, bytes] = {}
        self.applied_ops = 0

    def apply(self, cmd: Command) -> Optional[bytes]:
        self.applied_ops += 1
        if cmd.op == "put":
            self.data[cmd.key] = cmd.value
            return None
        return self.data.get(cmd.key)


class Node:
    """Base class: protocol nodes subclass and add ``on_<MsgType>`` handlers.

    Handler dispatch is cached per message class in ``_dispatch`` — the fused
    engine loop (network.Network._run) calls the bound handler directly,
    skipping the per-message ``getattr("on_" + kind)`` of the seed engine.
    """

    def __init__(self, node_id: int, net: Network, sched: Scheduler):
        self.id = node_id
        self.net = net
        self.sched = sched
        self.crashed = False
        self.store = KVStore()
        self.applied_log: list = []   # sequence of (slot/inst, command) applied
        self._dispatch: dict = {}     # msg class -> bound on_* handler
        # bound fast path: self.send(dst, msg) == net.send(self.id, dst, msg)
        self.send = partial(net.send, node_id)
        net.register(node_id, self)

    # ------------------------------------------------------------ transport
    def _bind_handler(self, cls):
        name = getattr(cls, "_kind_name", None) or cls.__name__
        h = getattr(self, "on_" + name, None)
        if h is None:
            raise RuntimeError(f"{type(self).__name__} has no handler for {name}")
        self._dispatch[cls] = h
        return h

    def deliver(self, msg: Msg) -> None:
        """Seed-compatible entry point (used by tests); the
        fused loop inlines the crash check and dispatch instead."""
        if self.crashed:
            return
        cls = msg.__class__
        h = self._dispatch.get(cls)
        if h is None:
            h = self._bind_handler(cls)
        h(msg)

    # ------------------------------------------------------------ timers
    def set_timer(self, delay: float, fn) -> int:
        def _fire():
            if not self.crashed:
                fn()
        return self.sched.after(delay, _fire)

    def cancel_timer(self, timer_id: int) -> None:
        self.sched.cancel(timer_id)

    # ------------------------------------------------------------ failure
    def crash(self) -> None:
        self.crashed = True

    def recover(self) -> None:
        self.crashed = False
