"""Quorum sizes (copied from ``repro.core.quorums``)."""
from __future__ import annotations


def majority(n: int) -> int:
    return n // 2 + 1


def fast_quorum(n: int) -> int:
    """EPaxos fast-path quorum size (paper §5.3 uses 3N/4)."""
    return (3 * n) // 4 + (1 if (3 * n) % 4 else 0)
