"""Core of the port: the discrete-event engines (scheduler, network,
Paxos, PigPaxos and EPaxos nodes, the cluster harness), the batch
backend's group kernel, and the framework-neutral pieces both lower
deployments from.  The public API is the reference's (``repro.core``)."""
from .analytical import (follower_messages, leader_messages,  # noqa: F401
                         total_messages_per_round)
from .cluster import (Client, Cluster, OpenLoopClient, Stats,  # noqa: F401
                      TaggedBytes, agreement_ok)
from .epaxos import EPaxosNode  # noqa: F401
from .events import Scheduler  # noqa: F401
from .messages import BatchCmd, Command, CostModel  # noqa: F401
from .network import Network, Topology, wan_topology  # noqa: F401
from .paxos import BatchConfig, PaxosNode  # noqa: F401
from .pig import DirectComm, PigComm, PigConfig  # noqa: F401
from .workload import WorkloadConfig, zipf_cdf  # noqa: F401
