"""The trainer's control plane: cluster metadata replicated with the actual
PigPaxos implementation from ``repro_torch.core``.

Checkpoint manifests, membership changes (elastic scaling), and gray lists
are *consensus operations*: a manifest is durable only once the PigPaxos
majority has committed it, exactly how production training services use
Paxos/Raft-backed stores (Chubby/etcd/ZooKeeper — paper §1) for run state.
The coordination cluster is simulated in-process on the DES, which makes the
whole failure matrix (leader crash, relay crash, partition) testable.

Copied from ``repro.runtime.coordination``, with one addition: a
``journal`` file.  The reference's service lives and dies with the process
that built it, so a trainer restarted with ``--resume`` finds no committed
checkpoint there.  With a journal, every committed put is appended to the
file, and a service built over an existing journal commits its last value
of each name again through its own PigPaxos majority before it answers:
the replicas' durable logs, modelled by one file.  Without a journal the
service is the reference's, event for event.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from ..core import Cluster, Command, PigConfig
from ..core.messages import ClientRequest


class _InlineClient:
    """Synchronous client that drives the DES until its op completes."""

    def __init__(self, cluster: Cluster, cid: int):
        self.cluster = cluster
        self.id = cid
        self.net_id = cluster.topo.n + cid
        self.crashed = False
        self.reply = None
        self.seq = 0
        cluster.net.register(self.net_id, self)

    def deliver(self, msg) -> None:
        if msg.seq == self.seq:
            self.reply = msg

    def call(self, op: str, key: int, value: Optional[bytes] = None,
             timeout: float = 5.0) -> Optional[bytes]:
        sched = self.cluster.sched
        deadline = sched.now + timeout
        while sched.now < deadline:
            self.seq += 1
            self.reply = None
            cmd = Command(client_id=self.id, seq=self.seq, op=op, key=key,
                          value=value)
            target = self.cluster.leader_id
            self.cluster.net.send(self.net_id, target, ClientRequest(cmd=cmd))
            # drive virtual time until the reply lands or a retry is due
            retry_at = sched.now + 0.25
            while self.reply is None and sched.now < retry_at:
                if sched.idle():
                    break
                sched.run(until=sched.now + 0.01, max_events=10_000)
            if self.reply is not None and self.reply.ok:
                return self.reply.value
            # leader may have failed: probe other nodes for leadership
            for nd in self.cluster.nodes:
                if getattr(nd, "is_leader", False) and not nd.crashed:
                    self.cluster.leader_id = nd.id
                    break
            else:
                # elect the lowest-id alive node
                alive = [nd for nd in self.cluster.nodes if not nd.crashed]
                if alive:
                    self.cluster.leader_id = alive[0].id
                    alive[0].start_phase1()
                    sched.run(until=sched.now + 0.2)
        raise TimeoutError(f"coordination op {op} key={key} did not commit")


class CoordinationService:
    """Dict-like strongly-consistent metadata store backed by PigPaxos."""

    def __init__(self, n_nodes: int = 5, n_groups: int = 2, seed: int = 0,
                 journal: Optional[str] = None):
        self.cluster = Cluster(
            "pigpaxos", n_nodes,
            pig=PigConfig(n_groups=n_groups, prc=1, use_gray_list=True),
            seed=seed)
        self.cluster.run(0.05)        # initial leader election
        self._client = _InlineClient(self.cluster, cid=900)
        self._keymap: Dict[str, int] = {}
        self.journal = journal
        if journal is not None and os.path.exists(journal):
            last: Dict[str, object] = {}
            with open(journal) as f:
                for line in f:
                    if line.strip():
                        name, obj = json.loads(line)
                        last[name] = obj
            for name, obj in last.items():
                self._commit(name, obj)

    def _key(self, name: str) -> int:
        if name not in self._keymap:
            self._keymap[name] = len(self._keymap) + 10_000
        return self._keymap[name]

    # ---------------------------------------------------------------- API
    def put(self, name: str, obj) -> None:
        self._commit(name, obj)
        if self.journal is not None:
            with open(self.journal, "a") as f:
                f.write(json.dumps([name, obj]) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def _commit(self, name: str, obj) -> None:
        payload = json.dumps(obj).encode()
        self._client.call("put", self._key(name), payload)

    def get(self, name: str):
        raw = self._client.call("get", self._key(name))
        return None if raw is None else json.loads(raw.decode())

    # -------------------------------------------------------- fault hooks
    def crash_node(self, node_id: int) -> None:
        self.cluster.nodes[node_id].crash()

    def recover_node(self, node_id: int) -> None:
        self.cluster.nodes[node_id].recover()

    @property
    def leader_gray_list(self) -> dict:
        ld = self.cluster.nodes[self.cluster.leader_id]
        return dict(getattr(ld.comm, "gray", {}))
