"""The paper's closed-form message loads that the port reads (copied from
``repro.core.analytical``): EPaxos's per-node messages a request, which
``core.jaxsim`` prices its queueing model with."""
from __future__ import annotations

from .quorums import fast_quorum


def epaxos_messages(n: int) -> float:
    """Per-node messages/request on the EPaxos conflict-free fast path,
    client I/O included (all nodes symmetric, §5.3): PreAccept + reply with
    the fast quorum (each message counted at both endpoints), the commit
    broadcast to the other N-1 replicas, and the client request/reply pair
    at the command leader — averaged over the N replicas."""
    fq = fast_quorum(n)
    return (2.0 * (fq - 1) * 2 + (n - 1) * 2 + 2) / n
