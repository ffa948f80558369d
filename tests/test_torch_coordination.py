"""The trainer's control plane on the port (``repro_torch.runtime``)
against the reference's (``repro.runtime``), on the CPU.

``CoordinationService`` (5 PigPaxos nodes, 2 relay groups, the gray list)
commits the same values in the same number of discrete events as the
reference's, through a follower crash and a leader crash with failover;
``ElasticController`` and ``HeartbeatMonitor`` decide as the reference's
do.  The port's journal (its one addition) makes the committed values
outlive the service.  ``python -m repro_torch.launch.train --device cpu``
commits each checkpoint through the service, and a second run with
``--resume`` restores the committed step: the steps after it and the
checkpoint they end in equal an uninterrupted run's, byte for byte."""
import os

import numpy as np
import pytest

from repro.runtime import CoordinationService as RefCoord
from repro.runtime import ElasticController as RefElastic
from repro.runtime import HeartbeatMonitor as RefHeartbeat
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as train_cli
from repro_torch.runtime import (CoordinationService, ElasticController,
                                 HeartbeatMonitor)


def _state(coord):
    s = coord.cluster.sched
    return (s.events, s._seq, s.now, coord.cluster.leader_id,
            [[(slot, c.client_id, c.seq, c.op, c.key)
              for slot, c in nd.applied_log] for nd in coord.cluster.nodes])


def _failures(C, **kw):
    coord = C(n_nodes=5, n_groups=2, **kw)
    seen = [_state(coord)]
    coord.put("ckpt/latest", {"step": 7, "dir": "step_7"})
    assert coord.get("ckpt/latest") == {"step": 7, "dir": "step_7"}
    coord.crash_node(3)                       # follower crash
    coord.put("ckpt/latest", {"step": 9, "dir": "step_9"})
    seen += [coord.get("ckpt/latest"), _state(coord)]
    coord.crash_node(0)                       # leader crash => failover
    coord.put("ckpt/latest", {"step": 11, "dir": "step_11"})
    seen += [coord.get("ckpt/latest"), _state(coord),
             coord.leader_gray_list]
    coord.recover_node(0)
    coord.put("membership", {"pods": [0], "epoch": 1})
    seen += [coord.get("membership"), _state(coord)]
    return seen


@pytest.mark.parametrize("seed", [0, 3])
def test_commits_survive_crashes_as_the_references(seed):
    got = _failures(CoordinationService, seed=seed)
    assert got == _failures(RefCoord, seed=seed)
    assert got[1] == {"step": 9, "dir": "step_9"}
    assert got[3] == {"step": 11, "dir": "step_11"}
    assert got[4][3] != 0 and got[4][0] > got[2][0] > got[0][0]


def test_elastic_remesh_and_batch():
    got = []
    for C, E in ((RefCoord, RefElastic),
                 (CoordinationService, ElasticController)):
        coord = C(n_nodes=5, n_groups=2, seed=3)
        ctl = E(coord, n_pods=2, data=16, model=16)
        out = [ctl.mesh_shape(), ctl.effective_batch(256)]
        out.append(ctl.remove_pods([1]))      # pod failure
        out += [ctl.mesh_shape(), ctl.effective_batch(256),
                ctl.membership(), coord.cluster.sched.events]
        got.append(out)
    assert got[0] == got[1]
    assert got[1][:2] == [(2, 16, 16), 256]
    assert got[1][3:6] == [(16, 16), 128, {"pods": [0], "epoch": 1}]


def test_heartbeat_straggler_detection():
    got = []
    for H in (RefHeartbeat, HeartbeatMonitor):
        hb = H(timeout=10.0)
        for t in range(8):
            hb.beat(0, step_time=1.0, now=float(t))
            hb.beat(1, step_time=1.05, now=float(t))
            hb.beat(2, step_time=3.5, now=float(t))   # straggler
        out = [hb.stragglers(), hb.dead_pods(now=7.0)]
        for t in range(8, 20):                        # pod 2 stops
            hb.beat(0, now=float(t))
            hb.beat(1, now=float(t))
        got.append(out + [hb.dead_pods(now=19.0)])
    assert got[0] == got[1] == [[2], [], [2]]


def test_journal_outlives_the_service(tmp_path):
    """Without a journal the service is the reference's, event for event;
    with one, a new service commits the journalled values again (the
    last of each name) before it answers."""
    path = str(tmp_path / "coord.journal")
    coord = CoordinationService(journal=path)
    ref = RefCoord()
    for step in (2, 4):
        coord.put("ckpt/latest", {"step": step, "dir": f"step_{step}"})
        ref.put("ckpt/latest", {"step": step, "dir": f"step_{step}"})
    assert _state(coord) == _state(ref)
    fresh = CoordinationService(seed=5)
    again = CoordinationService(journal=path, seed=5)
    # one commit a name (the last value), before any call: more events
    # than the fresh service's election alone
    assert again.cluster.sched.events > fresh.cluster.sched.events
    assert again.get("ckpt/latest") == {"step": 4, "dir": "step_4"}
    assert again._keymap == {"ckpt/latest": 10_000}
    assert CoordinationService().get("ckpt/latest") is None


def test_checkpoint_commits_through_the_service(tmp_path):
    """``CheckpointManager`` counts a step once ``ckpt/latest`` commits;
    a manifest written without the commit does not count."""
    from repro_torch import configs, train
    import torch
    cfg = configs.get_smoke_config("granite_8b")
    state = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    coord = CoordinationService(n_nodes=5, n_groups=2)
    mgr = CheckpointManager(str(tmp_path), coord=coord, async_save=True)
    mgr.save(2, state)
    mgr.wait()
    coord.crash_node(0)                     # the next commit fails over
    mgr.save(3, state)
    mgr.wait()
    assert coord.get("ckpt/latest") == {"step": 3, "dir": "step_3"}
    CheckpointManager(str(tmp_path), async_save=False).save(5, state)
    assert mgr.latest_step() == 3 and mgr.restore(state)[1] == 3


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_launch_train_commits_and_resumes_bit_for_bit(tmp_path, capsys):
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    first = train_cli.main(args + ["--ckpt-dir", a, "--steps", "2"])
    assert first["committed"] == {"step": 2, "dir": "step_2"}
    log = capsys.readouterr().out
    assert "last committed checkpoint: {'step': 2, 'dir': 'step_2'}" in log
    resumed = train_cli.main(args + ["--ckpt-dir", a, "--steps", "4",
                                     "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["start"] == 2 and resumed["latest"] == 4
    whole = train_cli.main(args + ["--ckpt-dir", b, "--steps", "4"])
    assert whole["start"] == 0 and whole["latest"] == 4
    assert resumed["losses"] == whole["losses"][2:]
    assert np.isfinite(whole["losses"]).all()
    assert _files(os.path.join(a, "step_4")) == \
        _files(os.path.join(b, "step_4"))
    assert _files(os.path.join(a, "step_2")) == \
        _files(os.path.join(b, "step_2"))
