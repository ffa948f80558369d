"""Failure detection + elastic scaling decisions for multi-pod training.

HeartbeatMonitor implements the paper's gray-list semantics (§4.2) at the
pod level: pods that miss heartbeats are suspects; persistent suspects are
proposed (through the PigPaxos coordination plane) for removal, and the mesh
is shrunk along the data-parallel axis.  Straggler mitigation follows the
same path with a latency threshold instead of a liveness one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .coordination import CoordinationService


@dataclass
class HeartbeatMonitor:
    timeout: float = 30.0                 # liveness (s)
    straggler_factor: float = 2.0         # step time > factor*median => gray
    last_beat: Dict[int, float] = field(default_factory=dict)
    step_times: Dict[int, List[float]] = field(default_factory=dict)
    gray: Dict[int, float] = field(default_factory=dict)

    def beat(self, pod: int, step_time: Optional[float] = None,
             now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.last_beat[pod] = now
        if step_time is not None:
            self.step_times.setdefault(pod, []).append(step_time)
            self.step_times[pod] = self.step_times[pod][-16:]

    def dead_pods(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [p for p, t in self.last_beat.items() if now - t > self.timeout]

    def stragglers(self) -> List[int]:
        meds = {p: sorted(v)[len(v) // 2] for p, v in self.step_times.items() if v}
        if len(meds) < 2:
            return []
        overall = sorted(meds.values())[len(meds) // 2]
        return [p for p, m in meds.items() if m > self.straggler_factor * overall]


class ElasticController:
    """Drives membership through the coordination plane and computes the
    post-failure mesh.  Recovery contract: on any membership change, restore
    from the last *committed* checkpoint manifest and re-shard."""

    def __init__(self, coord: CoordinationService, n_pods: int,
                 data: int, model: int):
        self.coord = coord
        self.n_pods = n_pods
        self.data = data
        self.model = model
        coord.put("membership", {"pods": list(range(n_pods)), "epoch": 0})

    def membership(self) -> dict:
        return self.coord.get("membership")

    def remove_pods(self, pods: List[int]) -> dict:
        m = self.membership()
        alive = [p for p in m["pods"] if p not in pods]
        new = {"pods": alive, "epoch": m["epoch"] + 1}
        self.coord.put("membership", new)     # consensus-committed
        return new

    def mesh_shape(self) -> tuple:
        """Current mesh: shrink the pod axis to the alive pods; keep
        (data, model) intact inside each pod."""
        alive = len(self.membership()["pods"])
        if alive == 0:
            raise RuntimeError("no pods alive")
        if alive == 1:
            return (self.data, self.model)
        return (alive, self.data, self.model)

    def effective_batch(self, global_batch: int) -> int:
        """Keep per-pod batch constant: global batch shrinks with pods
        (synchronous elastic scaling)."""
        alive = len(self.membership()["pods"])
        return global_batch * alive // self.n_pods
