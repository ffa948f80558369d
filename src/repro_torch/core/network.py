"""The latency model's topology (copied from ``repro.core.network``): a
LAN of one region with a base one-way latency and an exponential jitter,
or WAN regions with a one-way base matrix between them.  The simulated
transport (``Network``) belongs to the discrete-event engines and is not
ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Topology:
    """Latency model. ``region_of`` maps node id -> region index;
    ``region_latency[r1][r2]`` is the one-way base latency between
    regions."""
    n: int
    base_latency: float = 0.25e-3          # LAN one-way
    jitter: float = 0.05e-3
    region_of: Optional[list] = None
    region_latency: Optional[np.ndarray] = None   # one-way seconds


def wan_topology(nodes_per_region: list, oneway_ms: list) -> Topology:
    region_of = []
    for r, k in enumerate(nodes_per_region):
        region_of += [r] * k
    return Topology(
        n=len(region_of),
        jitter=0.05e-3,
        region_of=region_of,
        region_latency=np.asarray(oneway_ms) * 1e-3,
    )
