"""Fault plans on the port's discrete-event engines and the port's
linearizability audit, against the reference's, on the CPU, bit for bit.

Each plan is built through both packages' builders, applied with
``apply_plan`` to the same deployment and run: the materialized events,
the audit's summary, every client's latency list and history, the applied
logs, the executed events and ``commit_apply_gap`` must be the reference's.
The audit's five corrupted fixtures (the reference's own, from its fault
tests) must be flagged with the reference's messages."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.faults as RF
import repro_torch.core as T
import repro_torch.faults as TF
from repro.faults import plan as rplan
from repro_torch.faults import plan as tplan

# (protocol, n, pig kwargs, spare nodes, plan builder over a faults module,
#  measure window (duration, warmup), clients)
PLANS = {
    "leader crash-recover": (
        "paxos", 5, None, 0,
        lambda F: F.crash_window(0, 0.1, 0.2), (0.3, 0.05), 8),
    "relay crash + gray relay": (
        "pigpaxos", 25, dict(n_groups=3, prc=1, use_gray_list=True), 0,
        lambda F: F.crash_window(1, 0.08, 0.16)
        + F.slow_window(2, extra_latency=2e-3), (0.2, 0.05), 10),
    "partition + one-way": (
        "pigpaxos", 7, dict(n_groups=2, prc=1, use_gray_list=True), 0,
        lambda F: F.partition_window(0, 3, 0.1, 0.2)
        + F.partition_window(2, 5, 0.12, 0.22, oneway=True), (0.3, 0.05), 6),
    "drop + slow factor": (
        "paxos", 5, None, 0,
        lambda F: F.drop_window(2, 0.06, 0.15, 0.3)
        + F.FaultPlan(events=(("slow", 3, 0.05, 0.2, 1e-3, 2.0),)),
        (0.25, 0.05), 6),
    "storm": (
        "pigpaxos", 25, dict(n_groups=3, prc=1, use_gray_list=True), 0,
        lambda F: F.storm(targets=tuple(range(1, 25)), rate_hz=20.0, t0=0.06,
                          t1=0.25, mean_downtime=0.05, seed=11,
                          max_concurrent=2), (0.25, 0.05), 10),
    "partition storm": (
        "paxos", 5, None, 0,
        lambda F: F.storm(targets=(1, 2, 3, 4), rate_hz=15.0, t0=0.05,
                          t1=0.25, seed=3, kind="partition"),
        (0.25, 0.05), 6),
    "rolling restart": (
        "pigpaxos", 9, dict(n_groups=2, prc=1, use_gray_list=True), 0,
        lambda F: F.rolling_restart(tuple(range(9)), t0=0.06, downtime=0.02,
                                    gap=0.03), (0.35, 0.05), 8),
    "periodic crash": (
        "paxos", 5, None, 0,
        lambda F: F.periodic_crash(0, period=0.1, downtime=0.03, t0=0.05,
                                   t1=0.3), (0.3, 0.05), 8),
    "add + remove + handoff": (
        "pigpaxos", 9, dict(n_groups=2, prc=1, use_gray_list=True), 1,
        lambda F: F.add_node(9, 0.08) + F.remove_node(3, 0.12)
        + F.replace_leader(2, 0.16), (0.25, 0.05), 8),
    "replace the leader": (
        "paxos", 5, None, 1,
        lambda F: F.remove_node(0, 0.07) + F.add_node(5, 0.12),
        (0.25, 0.05), 6),
    "epaxos coordinator crash (recovery)": (
        "epaxos", 5, None, 0,
        lambda F: F.crash_window(2, 0.06, 0.14), (0.25, 0.05), 8),
    "epaxos add + remove": (
        "epaxos", 5, None, 1,
        lambda F: F.add_node(5, 0.06) + F.remove_node(3, 0.12),
        (0.2, 0.05), 6),
}


def _run(M, F, case):
    proto, n, pig, spares, mk, (dur, warm), clients = PLANS[case]
    c = M.Cluster(proto, n, pig=M.PigConfig(**pig) if pig else None,
                  seed=7, record_history=True, spare_nodes=spares,
                  engine="exact")
    evs = F.apply_plan(c, mk(F), horizon=warm + dur + 0.5)
    st = c.measure(duration=dur, warmup=warm, clients=clients,
                   workload=M.WorkloadConfig(request_timeout=25e-3))
    return c, st, evs


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_run_and_audit_equal_reference(case):
    rc, rs, revs = _run(R, RF, case)
    tc, ts, tevs = _run(T, TF, case)
    assert tevs == revs and tevs
    assert TF.plan.jsonify_events(tevs) == RF.plan.jsonify_events(revs)
    assert (ts.count, ts.committed, ts.throughput) == \
        (rs.count, rs.committed, rs.throughput)
    assert np.array_equal(ts.flight, rs.flight)
    assert [cl.latencies for cl in tc.clients] == \
        [cl.latencies for cl in rc.clients]
    assert [cl.history for cl in tc.clients] == \
        [cl.history for cl in rc.clients]
    assert [cl.retries for cl in tc.clients] == \
        [cl.retries for cl in rc.clients]
    assert [TF.applied_ops(nd) for nd in tc.nodes] == \
        [RF.applied_ops(nd) for nd in rc.nodes]
    assert tc.sched.events == rc.sched.events
    assert tc.members == rc.members
    got, want = TF.audit_cluster(tc), RF.audit_cluster(rc)
    assert got.summary() == want.summary()
    assert got.ok, got.violations
    assert TF.commit_apply_gap(tc) == RF.commit_apply_gap(rc)


def test_plan_builders_and_checks_equal_reference():
    def build(F):
        return (F.crash_window(0, 0.8, 1.2) + F.partition_window(1, 3, 0.5)
                + F.drop_window(2, 0.1, 0.4, 0.2)
                + F.periodic_crash(4, 1.0, 0.1, t0=0.2, t1=2.5)
                + F.storm((1, 2, 3), 4.0, 0.3, 1.9, seed=2)
                + F.rolling_restart((5, 6), 0.4) + F.add_node(9, 1.0)
                + F.remove_node(8, 1.1) + F.replace_leader(3, 1.3))
    r, t = build(RF), build(TF)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for horizon in (1.0, 3.0):
        assert t.materialize(horizon) == r.materialize(horizon)
        assert t.mask_expressible(horizon) == r.mask_expressible(horizon)
    bad = [lambda p: p.FaultPlan(events=(("explode", 3, 0.1),)),
           lambda p: p.rolling_restart((1, 2), 0.1, downtime=0.2, gap=0.1),
           lambda p: (p.slow_window(2, 0.0, 1.0) + p.drop_window(
               2, 0.5, 0.8, 0.1)).materialize(2.0),
           lambda p: p.crash_window(30, 0.1).validate_targets(25, 1.0)]
    for mk in bad:
        with pytest.raises(ValueError) as want:
            mk(rplan)
        with pytest.raises(ValueError) as got:
            mk(tplan)
        assert str(got.value) == str(want.value)


def _h(cid, seq, op, key, invoke, resp, rtag=None):
    return {"cid": cid, "seq": seq, "op": op, "key": key, "invoke": invoke,
            "resp": resp, "ok": resp is not None, "rtag": rtag,
            "wtag": (cid, seq) if op == "put" else None}


# the reference's corrupted fixtures (its fault tests), each with the word
# its violation message must carry
FIXTURES = {
    "stale": ([_h(0, 1, "put", 7, 0.0, 0.1), _h(0, 2, "put", 7, 0.2, 0.3),
               _h(1, 1, "get", 7, 0.4, 0.5, rtag=(0, 1))],
              [[(0, 1, "put", 7), (0, 2, "put", 7), (1, 1, "get", 7)]]),
    "real-time": ([_h(0, 1, "put", 3, 0.5, 0.6),
                   _h(1, 1, "put", 3, 0.0, 0.1)],
                  [[(0, 1, "put", 3), (1, 1, "put", 3)]]),
    "at-most-once": ([_h(0, 1, "put", 3, 0.0, 0.1)],
                     [[(0, 1, "put", 3), (0, 1, "put", 3)]]),
    "lost update": ([_h(0, 1, "put", 3, 0.0, 0.1),
                     _h(0, 2, "put", 4, 0.2, 0.3)],
                    [[(0, 1, "put", 3)]]),
    "divergence": ([_h(0, 1, "put", 3, 0.0, 0.1),
                    _h(1, 1, "put", 3, 0.0, 0.1)],
                   [[(0, 1, "put", 3), (1, 1, "put", 3)],
                    [(1, 1, "put", 3), (0, 1, "put", 3)]]),
}


@pytest.mark.parametrize("word", list(FIXTURES))
def test_audit_flags_each_violation_as_the_reference_does(word):
    history, logs = FIXTURES[word]
    got = TF.check_history(history, logs)
    want = RF.check_history(history, logs)
    assert not got.ok and any(word in v for v in got.violations)
    assert got.violations == want.violations
    assert got.summary() == want.summary()


def test_audit_accepts_a_valid_history_with_non_logged_reads():
    history = [_h(0, 1, "put", 7, 0.0, 0.1),
               _h(1, 1, "get", 7, 0.2, 0.3, rtag=(0, 1)),
               _h(0, 2, "put", 7, 0.35, 0.5),
               _h(1, 2, "get", 7, 0.6, 0.7, rtag=(0, 2)),
               dict(_h(2, 1, "get", 7, 0.8, 0.9, rtag=(0, 2)),
                    path="lease")]
    log = [(0, 1, "put", 7), (1, 1, "get", 7), (0, 2, "put", 7),
           (1, 2, "get", 7)]
    got = TF.check_history(history, [log, log[:2]], durable_logs=[0])
    want = RF.check_history(history, [log, log[:2]], durable_logs=[0])
    assert got.ok and got.summary() == want.summary()
