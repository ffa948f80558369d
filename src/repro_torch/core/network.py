"""The LAN part of the latency model (copied from
``repro.core.network.Topology``): one region, a base one-way latency and
an exponential jitter.  WAN region matrices are not ported yet."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Topology:
    n: int
    base_latency: float = 0.25e-3          # LAN one-way
    jitter: float = 0.05e-3
