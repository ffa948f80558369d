"""The port's seed stack (``Cluster(engine="ref")``,
``repro_torch/core/refengine.py``) against the reference's, and the port's
``exact`` engine against its own seed stack, on the CPU, bit for bit.

The reference's golden-trace cases (``tests/test_golden_trace.py``): the
three protocols and PigPaxos at R 1-3 (single-group majority, PRC with the
gray list), two seeds each (a 0.15 s window where the reference's takes
0.3 s: the equality does not depend on it), and the crash and
leader-failover case at the reference's window.  Each
run is compared on its executed events, the scheduler's sequence counter
and clock, every node's applied log, the committed count, the message
accounting, the flight matrix, every client's latencies and the stats.
The ``fast`` engine keeps the aggregates within the reference's stated
bounds, and the seed stack refuses what it has no surface for (membership
change, batching and pipelining, leases, observability) in the
reference's words."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T


def _applied(cluster):
    return [[(slot, c.client_id, c.seq, c.op, c.key)
             for slot, c in nd.applied_log] for nd in cluster.nodes]


def _fingerprint(c, st):
    return {"events": c.sched.events, "seq": c.sched._seq,
            "now": c.sched.now, "applied": _applied(c),
            "committed": st.committed, "count": st.count,
            "throughput": st.throughput, "median_ms": st.median_ms,
            "p99_ms": st.p99_ms, "msg_out": st.msg_out.tolist(),
            "msg_in": st.msg_in.tolist(), "flight": st.flight.tolist(),
            "latencies": [cl.latencies for cl in c.clients]}


def _run(M, proto, pig, engine, seed, crash=None, duration=0.15,
         clients=8):
    c = M.Cluster(proto, 5, pig=M.PigConfig(**pig) if pig else None,
                  seed=seed, engine=engine)
    if crash is not None:
        c.crash_at(*crash)
    st = c.measure(duration=duration, warmup=0.1, clients=clients)
    return _fingerprint(c, st)


CONFIGS = {
    "paxos": ("paxos", None),
    "pig_r2": ("pigpaxos", dict(n_groups=2)),
    "pig_r1maj": ("pigpaxos", dict(n_groups=1, single_group_majority=True)),
    "pig_prc_gray": ("pigpaxos", dict(n_groups=3, prc=1,
                                      use_gray_list=True)),
    "epaxos": ("epaxos", None),
}


@pytest.mark.parametrize("seed", [7, 23])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_seed_stack_equals_reference_and_exact_equals_it(case, seed):
    proto, pig = CONFIGS[case]
    ref = _run(R, proto, pig, "ref", seed)
    port_ref = _run(T, proto, pig, "ref", seed)
    assert port_ref == ref
    assert port_ref["events"] > 0 and port_ref["committed"] > 0
    assert _run(T, proto, pig, "exact", seed) == port_ref


def test_seed_stack_under_failures():
    """Crash + leader failover (node 3 at 0.12 s; the reference's case):
    the port's seed stack equals the reference's, and the port's exact
    engine equals it."""
    kw = dict(proto="pigpaxos", pig=dict(n_groups=2), seed=19,
              crash=(3, 0.12), duration=0.4, clients=6)
    ref = _run(R, engine="ref", **kw)
    port_ref = _run(T, engine="ref", **kw)
    assert port_ref == ref
    assert _run(T, engine="exact", **kw) == port_ref


def test_fast_engine_preserves_aggregates():
    """The flattened engine is not bit-identical (the reference documents
    it), but keeps the seed stack's aggregates within its bounds."""
    c_ref = T.Cluster("pigpaxos", 9, pig=T.PigConfig(n_groups=3), seed=11,
                      engine="ref")
    st_ref = c_ref.measure(duration=0.4, warmup=0.1, clients=10)
    c_fast = T.Cluster("pigpaxos", 9, pig=T.PigConfig(n_groups=3), seed=11,
                       engine="fast")
    st_fast = c_fast.measure(duration=0.4, warmup=0.1, clients=10)
    assert T.agreement_ok(c_fast)
    assert st_fast.committed == pytest.approx(st_ref.committed, rel=0.05)
    assert st_fast.throughput == pytest.approx(st_ref.throughput, rel=0.05)
    assert st_fast.median_ms == pytest.approx(st_ref.median_ms, rel=0.10)
    # the port's seed stack gives the reference's seed-stack numbers
    r = R.Cluster("pigpaxos", 9, pig=R.PigConfig(n_groups=3), seed=11,
                  engine="ref").measure(duration=0.4, warmup=0.1,
                                        clients=10)
    assert (r.committed, r.throughput, r.median_ms) == \
        (st_ref.committed, st_ref.throughput, st_ref.median_ms)


@pytest.mark.parametrize("kw", [
    dict(spare_nodes=1), dict(batch="m=4"), dict(pipeline_depth=2),
    dict(lease={"duration_ms": 100.0}), dict(obs={"sample_rate": 1.0})],
    ids=["spare_nodes", "batch", "pipeline", "lease", "obs"])
def test_seed_stack_refusals_are_the_references(kw):
    msgs = []
    for M in (R, T):
        args = ({"batch": M.BatchConfig(max_batch=4)}
                if kw.get("batch") == "m=4" else kw)
        with pytest.raises(ValueError) as e:
            M.Cluster("pigpaxos", 5, pig=M.PigConfig(n_groups=2),
                      engine="ref", **args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "verbatim seed stack (engine='ref')" in msgs[1]


def test_scenario_refusals_on_the_seed_stack_are_the_references():
    """The scenario layer's checks of ``engine="ref"``: batching or
    pipelining, observability, read mixes and leases, word for word."""
    from repro.experiments.scenario import Scenario as RS
    from repro_torch.experiments.scenario import Scenario as TS
    cases = [dict(batch={"max_batch": 4}), dict(pipeline_depth=2),
             dict(obs={"sample_rate": 1.0}),
             dict(workload="reads"), dict(lease={"duration_ms": 100.0})]
    for kw in cases:
        msgs = []
        for S, M in ((RS, R), (TS, T)):
            args = ({"workload": M.WorkloadConfig(read_ratio=0.5)}
                    if kw.get("workload") == "reads" else kw)
            with pytest.raises(ValueError) as e:
                S(name="x/ref", protocol="paxos", n=5, engine="ref",
                  backend="des", **args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    ok = TS(name="x/ref", protocol="paxos", n=5, engine="ref",
            backend="des")
    assert ok.spec_dict() == RS(name="x/ref", protocol="paxos", n=5,
                                engine="ref").spec_dict()


def test_seed_stack_scheduler_has_the_coordination_surface():
    """``_InlineClient`` drives ``sched.run(until=..., max_events=...)``
    and ``sched.idle()``; the seed stack's scheduler has both, as the
    reference's does."""
    from repro.core.refengine import RefScheduler as RRS
    from repro_torch.core.refengine import RefScheduler as TRS
    for S in (RRS, TRS):
        s = S(seed=1)
        hits = []
        for i in range(5):
            s.at(0.01 * i, lambda i=i: hits.append(i))
        assert not s.idle()
        s.run(until=1.0, max_events=3)
        assert hits == [0, 1, 2]
        s.run(until=1.0)
        assert hits == [0, 1, 2, 3, 4] and s.idle()
    assert np.array_equal(RRS(seed=5).rng.random(4), TRS(seed=5).rng.random(4))
