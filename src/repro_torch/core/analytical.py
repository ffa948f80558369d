"""Analytical bottleneck model from §6.1 / §6.4 / §6.5 of the paper
(copied from ``repro.core.analytical``).

  M_l = 2R + 2                                  (Eq. 1)
  M_f = 2 (R/(N-1)) ((N-R-1)/R) + 2
      = 2 (N-R-1)/(N-1) + 2                     (Eq. 2-3)
  total messages per round = 2N - 1             (§6.4, R-independent)

R = N-1 degenerates to classical Multi-Paxos (M_l = 2N, but the paper's
Table 1 lists 2(N-1)+2 = 50 for N=25 — client messages included).
``core.jaxsim`` prices its queueing model with ``epaxos_messages``;
``experiments.report`` checks Tables 1-2 (``load_table``) against the
measured per-node loads and reads the Eq. 1 leader bound.
"""
from __future__ import annotations

from .quorums import fast_quorum


def leader_messages(r: int) -> float:
    """Messages handled by the leader per request, client I/O included."""
    return 2 * r + 2


def follower_messages(n: int, r: int) -> float:
    """Amortized messages per follower per request under relay rotation."""
    return 2 * (n - r - 1) / (n - 1) + 2


def relay_messages(n: int, r: int) -> float:
    """Messages at a node *while it serves as relay* (group size (N-1)/R):
    1 fanout in + 1 aggregate out + round trip with each group peer."""
    g = (n - 1) / r
    return 2 + 2 * (g - 1)


def epaxos_messages(n: int) -> float:
    """Per-node messages/request on the EPaxos conflict-free fast path,
    client I/O included (all nodes symmetric, §5.3): PreAccept + reply with
    the fast quorum (each message counted at both endpoints), the commit
    broadcast to the other N-1 replicas, and the client request/reply pair
    at the command leader — averaged over the N replicas."""
    fq = fast_quorum(n)
    return (2.0 * (fq - 1) * 2 + (n - 1) * 2 + 2) / n


def total_messages_per_round(n: int) -> int:
    """2N-1: R messages leader->relays + 1 client reply + per relay
    ((N-R-1)/R relays + 1 aggregate) + 1 message per plain follower (§6.4)."""
    return 2 * n - 1


def load_table(n: int, rs: list[int] | None = None) -> list[dict]:
    """Reproduces Table 1 (n=25) / Table 2 (n=5)."""
    if rs is None:
        rs = [1, 2, 3, 4, 5, 6, n - 1] if n > 9 else [1, 2, n - 1]
    rows = []
    for r in rs:
        ml = leader_messages(r)
        mf = follower_messages(n, r) if r < n - 1 else 2.0
        rows.append({
            "R": r,
            "M_l": ml,
            "M_f": round(mf, 2),
            "ratio": round(ml / mf, 3),
            "label": "Paxos" if r == n - 1 else "PigPaxos",
        })
    return rows


def static_relay_load(n: int, r: int) -> float:
    """Without rotation the relay pays the full group cost every round:
    M_relay = 2 + 2((N-1)/R - 1).  √N groups equalize leader & relay load
    for static relays (§5.2): 2R+2 = 2(N-1)/R  =>  R ≈ √(N-1)."""
    return relay_messages(n, r)


def best_r_static(n: int) -> int:
    """argmin over R of max(leader, static relay) message load."""
    rs = range(1, n)
    return min(rs, key=lambda r: max(leader_messages(r),
                                     static_relay_load(n, r)))


def best_r_rotating(n: int) -> int:
    """argmin over R of max(leader, amortized follower) load — always 1
    (§6.5)."""
    rs = range(1, n)
    return min(rs, key=lambda r: max(leader_messages(r),
                                     follower_messages(n, r)))


def saturation_throughput(n: int, r: int, cpu_per_msg: float,
                          rotating: bool = True) -> float:
    """Upper-bound throughput: the busiest node's CPU is the bottleneck.
    Maps message counts to req/s via the per-message CPU cost (§2.2)."""
    if rotating:
        hottest = max(leader_messages(r), follower_messages(n, r))
    else:
        hottest = max(leader_messages(r), static_relay_load(n, r))
    return 1.0 / (hottest * cpu_per_msg)
