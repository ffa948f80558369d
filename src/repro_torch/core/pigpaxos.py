"""PigPaxos (§3.2) = the unchanged Multi-Paxos core + the Pig communication
layer.  This module exists to make the paper's composition explicit: there
is intentionally no PigPaxos-specific consensus logic anywhere (§3.3 —
"required almost no changes to the core Paxos code").

Membership change composes the same way: the single-server reconfiguration
commands live entirely in the Paxos core (``PaxosNode.propose_reconfig`` /
``_apply_membership``), and the Pig overlay only reacts through
``PigComm.set_members`` — applied configuration changes invalidate the
cached ``pig.partition_followers`` relay partition, so the next round
fans out over groups derived from the membership now in force.  Rounds in
flight across a re-partition resolve through the leader's ordinary
timeout/retry path (§3.4), exactly like a relay crash.

Copied from ``repro.core.pigpaxos``; the port's tests hold it to the
reference's run, event for event.
"""
from __future__ import annotations

from typing import Optional

from .events import Scheduler
from .network import Network
from .paxos import BatchConfig, PaxosNode
from .pig import PigConfig
from .quorums import QuorumSystem


class PigPaxosNode(PaxosNode):
    """A Paxos node whose communication layer is always a Pig overlay."""

    def __init__(self, node_id: int, net: Network, sched: Scheduler,
                 peers: list[int], pig: Optional[PigConfig] = None,
                 leader_timeout: float = 50e-3,
                 quorums: Optional[QuorumSystem] = None,
                 batch: Optional[BatchConfig] = None,
                 pipeline_depth: int = 0):
        super().__init__(node_id, net, sched, peers,
                         pig=pig or PigConfig(),
                         leader_timeout=leader_timeout, quorums=quorums,
                         batch=batch, pipeline_depth=pipeline_depth)
