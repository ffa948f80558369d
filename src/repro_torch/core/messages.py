"""Wire-size and CPU-cost constants of the batch model.

Copied from ``repro.core.messages`` (``HEADER_BYTES`` and the linear
``CostModel`` terms the batch lowering reads); the message classes
themselves belong to the discrete-event engines and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

HEADER_BYTES = 24  # type tag + ballot + slot + ids


@dataclass
class CostModel:
    """CPU seconds charged per message at each endpoint:
    ``cpu = base + per_byte * wire_size``."""
    base: float = 10e-6
    per_byte: float = 0.7e-9        # ~1.4 GB/s serialization bandwidth
