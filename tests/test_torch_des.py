"""The port's discrete-event engines against the reference's, on the CPU,
bit for bit: the same Python and the same numpy draws, so no tolerance.

Each case builds the same deployment through both packages' public API
(``Cluster``, ``PigConfig``, ``WorkloadConfig``, ``BatchConfig``,
``wan_topology``), runs ``measure`` over a short window and compares every
client's latency list, the measured ``Stats`` (count, committed,
throughput, percentiles), the per-node message counts and the flight
matrix, every node's applied log, the scheduler's executed events and its
sequence counter, and ``agreement_ok``: Paxos, PigPaxos (rotating and
static relays, R 1-3, PRC 0-2, a WAN topology, the gray list), EPaxos
(conflict 0 and 0.1, zipfian keys) at N 5 and 25, on both engines, with
batching and pipelining, leases and read mixes, quorum reads and open-loop
clients."""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
import repro.faults as RF
import repro_torch.core as T
import repro_torch.faults as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WAN3_MS = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]
_WAN3_GROUPS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]


def _build(M, proto, n, pig=None, wl=None, topo=None, batch=None,
           window=(0.12, 0.05), clients=10, seed=3, **kw):
    """One measured run through package ``M`` (``repro.core`` or the
    port's); ``pig``, ``wl``, ``batch`` are kwargs dicts, built with
    ``M``'s own classes."""
    c = M.Cluster(proto, n,
                  pig=M.PigConfig(**pig) if pig is not None else None,
                  topo=M.wan_topology([5, 5, 5], _WAN3_MS) if topo else None,
                  batch=M.BatchConfig(**batch) if batch is not None else None,
                  seed=seed, **kw)
    st = c.measure(duration=window[0], warmup=window[1], clients=clients,
                   workload=M.WorkloadConfig(**wl) if wl is not None
                   else None)
    return c, st


def _same(c, a):
    """Package ``repro``'s run ``c`` and the port's ``a``, bit for bit."""
    rc, rs = c
    tc, ts = a
    for f in ("throughput", "mean_ms", "median_ms", "p25_ms", "p75_ms",
              "p99_ms"):
        x, y = getattr(rs, f), getattr(ts, f)
        assert x == y or (math.isnan(x) and math.isnan(y)), f
    assert (rs.count, rs.committed) == (ts.count, ts.committed)
    assert rs.count > 0
    for f in ("msg_in", "msg_out", "flight"):
        assert np.array_equal(getattr(rs, f), getattr(ts, f)), f
    assert rs.cpu_busy == ts.cpu_busy
    assert [cl.latencies for cl in rc.clients] == \
        [cl.latencies for cl in tc.clients]
    assert [RF.applied_ops(nd) for nd in rc.nodes] == \
        [TF.applied_ops(nd) for nd in tc.nodes]
    assert rc.sched.events == tc.sched.events > 0
    assert rc.sched._seq == tc.sched._seq
    # a total order for (Pig)Paxos; EPaxos orders interfering commands only
    assert R.agreement_ok(rc) == T.agreement_ok(tc)
    assert T.agreement_ok(tc) or tc.protocol == "epaxos"
    assert rc.read_write_split() == tc.read_write_split()


CASES = {
    "paxos/N=5": dict(proto="paxos", n=5),
    "paxos/N=25/fast": dict(proto="paxos", n=25, engine="fast"),
    "pig/N=25/R=1/sgm": dict(proto="pigpaxos", n=25, pig=dict(
        n_groups=1, single_group_majority=True)),
    "pig/N=25/R=2/PRC=2": dict(proto="pigpaxos", n=25, pig=dict(
        n_groups=2, prc=2)),
    "pig/N=25/R=3/PRC=1/gray": dict(proto="pigpaxos", n=25, pig=dict(
        n_groups=3, prc=1, use_gray_list=True)),
    "pig/N=25/R=3/static": dict(proto="pigpaxos", n=25, pig=dict(
        n_groups=3, rotate_relays=False), clients=20),
    "pig/N=25/R=3/PRC=0/fast": dict(proto="pigpaxos", n=25, pig=dict(
        n_groups=3), engine="fast"),
    "pig/N=5/R=2": dict(proto="pigpaxos", n=5, pig=dict(n_groups=2)),
    "pig/wan15": dict(proto="pigpaxos", n=15, topo=True, pig=dict(
        n_groups=3, groups=_WAN3_GROUPS, prc=1), leader_timeout=400e-3,
        window=(0.3, 0.2)),
    "epaxos/N=5": dict(proto="epaxos", n=5),
    "epaxos/N=25/c=0.1": dict(proto="epaxos", n=25, wl=dict(
        key_dist="conflict", conflict_rate=0.1), window=(0.08, 0.04)),
    "epaxos/N=25/c=0/fast": dict(proto="epaxos", n=25, wl=dict(
        key_dist="conflict", conflict_rate=0.0), engine="fast",
        window=(0.08, 0.04)),
    "epaxos/N=5/zipf": dict(proto="epaxos", n=5, wl=dict(
        key_dist="zipfian", zipf_theta=0.99)),
    "paxos/batch+pipeline": dict(proto="paxos", n=25, engine="fast",
                                 batch=dict(max_batch=4, max_delay_ms=1.0),
                                 pipeline_depth=2, clients=32),
    "pig/batch": dict(proto="pigpaxos", n=25, pig=dict(n_groups=3, prc=1),
                      batch=dict(max_batch=8, max_delay_ms=0.2),
                      clients=32),
    "epaxos/batch": dict(proto="epaxos", n=5,
                         batch=dict(max_batch=4, max_delay_ms=1.0),
                         clients=16),
    "paxos/lease/r=0.9": dict(proto="paxos", n=25, wl=dict(
        read_ratio=0.9, read_path="lease"), lease={"duration_ms": 200.0},
        record_history=True, clients=20),
    "pig/log/r=0.5": dict(proto="pigpaxos", n=25, pig=dict(n_groups=3),
                          wl=dict(read_ratio=0.5, read_path="log")),
    "pig/quorum/r=0.9": dict(proto="pigpaxos", n=15, topo=True, pig=dict(
        n_groups=3, groups=_WAN3_GROUPS, prc=1), leader_timeout=400e-3,
        wl=dict(read_ratio=0.9, read_path="quorum"), window=(0.3, 0.2)),
    "epaxos/quorum/r=0.9": dict(proto="epaxos", n=5, wl=dict(
        read_ratio=0.9, read_path="quorum")),
    "paxos/poisson": dict(proto="paxos", n=5, wl=dict(
        arrival="poisson", rate_hz=400.0)),
    "paxos/bursty+payloads": dict(proto="paxos", n=5, wl=dict(
        arrival="bursty", rate_hz=300.0, burst_period=0.05,
        reject_action="drop", payload_choices=(8, 256, 1024),
        payload_weights=(0.5, 0.3, 0.2))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_equals_reference_bit_for_bit(case):
    kw = CASES[case]
    _same(_build(R, **kw), _build(T, **kw))


def test_history_and_tagged_values_equal_reference():
    """``record_history``: every client's invoke/response records and the
    tagged put values, as the auditor reads them."""
    kw = dict(proto="pigpaxos", n=9, pig=dict(n_groups=2, prc=1),
              record_history=True, wl=dict(read_ratio=0.5),
              window=(0.1, 0.05))
    (rc, _), (tc, _) = _build(R, **kw), _build(T, **kw)
    rh = [cl.history for cl in rc.clients]
    th = [cl.history for cl in tc.clients]
    assert rh == th and sum(map(len, th)) > 0
    assert RF.audit_cluster(rc).summary() == TF.audit_cluster(tc).summary()


def test_membership_and_leader_change_equal_reference():
    """Cluster-level operations on both packages at the same times: a
    spare joins, a follower leaves, leadership moves."""
    def run(M):
        c = M.Cluster("pigpaxos", 9, pig=M.PigConfig(n_groups=2, prc=1),
                      seed=5, spare_nodes=1, record_history=True)
        c.sched.at(0.08, lambda: c.add_node(9))
        c.sched.at(0.12, lambda: c.remove_node(4))
        c.sched.at(0.16, lambda: c.replace_leader(2))
        st = c.measure(duration=0.2, warmup=0.05, clients=8,
                       workload=M.WorkloadConfig(request_timeout=25e-3))
        return c, st
    (rc, rs), (tc, ts) = run(R), run(T)
    _same((rc, rs), (tc, ts))
    assert rc.members == tc.members and rc.leader_id == tc.leader_id


def test_unported_engine_and_obs_raise_naming_item_13b():
    """Once refused, naming ROADMAP item 13b: ``engine="ref"`` (the seed
    stack) and ``obs=`` (tracing and timelines, with and without the
    sampler) now run and equal the reference's runs bit for bit; the
    seed stack's refusals are the reference's, word for word."""
    for kw in (dict(engine="ref"), dict(obs=True),
               dict(obs={"sample_rate": 0.1}),
               dict(obs={"sample_rate": 1.0, "metrics_dt": 0.01})):
        _same(_build(R, "pigpaxos", 5, pig=dict(n_groups=2), **kw),
              _build(T, "pigpaxos", 5, pig=dict(n_groups=2), **kw))
    for kw in (dict(obs=True), dict(spare_nodes=1),
               dict(batch=dict(max_batch=4)), dict(pipeline_depth=2),
               dict(lease={"duration_ms": 100.0})):
        msgs = []
        for M in (R, T):
            if "batch" in kw:
                kw = dict(batch=M.BatchConfig(max_batch=4))
            with pytest.raises(ValueError) as e:
                M.Cluster("paxos", 5, engine="ref", **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "verbatim seed stack" in msgs[1]
    with pytest.raises(ValueError, match="unknown engine"):
        T.Cluster("paxos", 5, engine="turbo")
    T.Cluster("paxos", 5, obs=False)        # the reference's "off"


def test_public_api_is_the_reference_api():
    """``repro_torch.core`` exports what ``repro.core`` does (the surface
    ``from repro_torch.core import Cluster, PigConfig, agreement_ok``)."""
    ref = {n for n in dir(R) if not n.startswith("_")}
    port = {n for n in dir(T) if not n.startswith("_")}
    missing = sorted(ref - port - {"refengine", "obs"})
    assert missing == [], missing
    for name in ("Cluster", "PigConfig", "agreement_ok", "WorkloadConfig",
                 "Scheduler", "Network", "BatchConfig", "EPaxosNode",
                 "PaxosNode", "DirectComm", "PigComm", "zipf_cdf"):
        assert getattr(T, name).__module__.startswith("repro_torch."), name


def test_engine_loads_no_torch():
    """The discrete-event engines, the fault plans and the audit are plain
    Python and numpy: importing them (and running a cluster) loads no
    torch."""
    code = ("import sys\n"
            "from repro_torch.core import Cluster, PigConfig, agreement_ok\n"
            "from repro_torch.faults import apply_plan, audit_cluster\n"
            "c = Cluster('pigpaxos', 5, pig=PigConfig(n_groups=2), seed=1)\n"
            "c.measure(duration=0.02, warmup=0.01, clients=2)\n"
            "assert agreement_ok(c)\n"
            "print('TORCH', 'torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "TORCH False" in r.stdout, r.stdout


def test_scheduler_and_costs_equal_reference():
    """The slab engine's timers (``at``, ``after``, ``every``, cancel) and
    the per-class cost cache, call for call."""
    out = []
    for M in (R, T):
        s = M.Scheduler(seed=4)
        got = []
        ids = [s.at(0.01 * i, lambda i=i: got.append((s.now, i)))
               for i in range(8)]
        s.cancel(ids[3])
        stop = s.every(0.015, lambda: got.append((s.now, "tick")),
                       stop_at=0.06)
        s.after(0.033, stop)
        s.run(until=0.1)
        out.append((got, s.events, s._seq, float(s.rng.random())))
    assert out[0] == out[1]
    from repro.core import messages as rm
    from repro_torch.core import messages as tm
    rc, tc = rm.CostModel(), tm.CostModel()
    for name in ("P1a", "P2b", "P3", "LeaseAck"):
        assert rc.cpu_cost(getattr(rm, name)()) == \
            tc.cpu_cost(getattr(tm, name)())
    big_r = rm.P2a(cmd=rm.Command(1, 2, "put", 3, b"x" * 300))
    big_t = tm.P2a(cmd=tm.Command(1, 2, "put", 3, b"x" * 300))
    assert rc.cpu_cost(big_r) == tc.cpu_cost(big_t)
    pre_r = rm.PreAccept(cmd=rm.Command(1, 2, "put", 3, b"x"), n_cluster=25)
    pre_t = tm.PreAccept(cmd=tm.Command(1, 2, "put", 3, b"x"), n_cluster=25)
    assert rc.cpu_cost(pre_r) == tc.cpu_cost(pre_t)
