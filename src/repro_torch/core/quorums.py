"""Quorum systems: majority, flexible (FPaxos), and EPaxos fast quorums
(copied from ``repro.core.quorums``)."""
from __future__ import annotations


def majority(n: int) -> int:
    return n // 2 + 1


def fast_quorum(n: int) -> int:
    """EPaxos fast-path quorum size (paper §5.3 uses 3N/4)."""
    return (3 * n) // 4 + (1 if (3 * n) % 4 else 0)


class QuorumSystem:
    """Flexible quorums (§7.1): |Q1| + |Q2| > N guarantees intersection."""

    def __init__(self, n: int, q1: int | None = None, q2: int | None = None):
        self.n = n
        self.q1 = q1 if q1 is not None else majority(n)
        self.q2 = q2 if q2 is not None else majority(n)
        if self.q1 + self.q2 <= n:
            raise ValueError(f"Q1({self.q1}) + Q2({self.q2}) must exceed N({n})")

    def phase1_satisfied(self, acks: int) -> bool:
        return acks >= self.q1

    def phase2_satisfied(self, acks: int) -> bool:
        return acks >= self.q2
