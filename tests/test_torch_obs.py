"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``), on the CPU, bit for bit.

The contracts of the reference's ``tests/test_obs.py``, each held against
the reference's own output for the same run:

1. bit-identity: a traced run (any sample rate, ``metrics_dt=0``) equals
   an untraced one, and the traced ``exact`` engine equals the seed
   stack; the port's traced run equals the reference's traced run;
2. well-formed span trees, and the whole span list of every trace equal
   to the reference's;
3. every-k-th sampling and a hop table that drains;
4. critical-path segments that sum to the op latency and equal the
   reference's segments; ``decompose`` refuses an unfinished trace;
5. rotating relays flatten the followers' busy time (with the fairness
   pair, ``test_torch_obs_scenarios.py``);
6. the latency admission policy's validation, shedding and timelines;
7. ``Stats.timelines`` and the warmup reset; Perfetto export and
   ``obs_artifact_section`` equal to the reference's JSON.

The ``obs`` family's scenarios: ``test_torch_obs_scenarios.py``."""
import functools
import json

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro import obs as RO
from repro.experiments.scenario import Scenario as RefScenario
from repro.runtime import policy as RP
from repro_torch import obs as TO
from repro_torch.experiments.scenario import Scenario
from repro_torch.runtime import policy as TP

CONFIGS = {"paxos": ("paxos", None), "pigpaxos": ("pigpaxos", 2),
           "epaxos": ("epaxos", None)}


def _applied(cluster):
    return [[(slot, c.client_id, c.seq, c.op, c.key)
             for slot, c in nd.applied_log] for nd in cluster.nodes]


def _run(M, proto, groups, engine, seed=7, obs=None):
    """One measured run (0.2 s where the reference's tests take 0.3 s);
    runs are read only afterwards, so each is made once a module."""
    key = None if obs is None else tuple(sorted(obs.items()))
    return _cached(M, proto, groups, engine, seed, key)


@functools.cache
def _cached(M, proto, groups, engine, seed, obs):
    pig = M.PigConfig(n_groups=groups) if groups else None
    c = M.Cluster(proto, 5, pig=pig, seed=seed, engine=engine,
                  obs=None if obs is None else dict(obs))
    st = c.measure(duration=0.2, warmup=0.1, clients=8)
    return c, st


def _fingerprint(c, st):
    return (c.sched.events, c.sched._seq, c.sched.now, _applied(c),
            st.committed, st.throughput, st.median_ms, st.msg_out.tolist(),
            st.msg_in.tolist())


def _traces(tr):
    return {tid: tr.trace_of(tid) for tid in tr.finished}


# ---------------------------------------------------------------- identity

@pytest.mark.parametrize("engine", ["exact", "fast"])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_tracing_is_bit_identical(case, engine):
    """Full-rate, sparse and zero-rate tracing and no obs at all give the
    same execution; each equals the reference's run with the same obs."""
    proto, groups = CONFIGS[case]
    base = _fingerprint(*_run(T, proto, groups, engine))
    for obs in ({"sample_rate": 1.0}, {"sample_rate": 0.1},
                {"sample_rate": 0.0}):
        c, st = _run(T, proto, groups, engine, obs=obs)
        assert _fingerprint(c, st) == base, f"obs={obs} perturbed the run"
    assert _traces(c.obs_tracer) == {}  # rate 0: installed, none sampled
    rc, rst = _run(R, proto, groups, engine, obs={"sample_rate": 1.0})
    assert _fingerprint(rc, rst) == base
    tc, _ = _run(T, proto, groups, engine, obs={"sample_rate": 1.0})
    assert _traces(tc.obs_tracer) == _traces(rc.obs_tracer)
    assert tc.obs_tracer.summary() == rc.obs_tracer.summary()


@pytest.mark.parametrize("case", list(CONFIGS))
def test_traced_exact_matches_seed_stack(case):
    proto, groups = CONFIGS[case]
    ref = _fingerprint(*_run(T, proto, groups, "ref"))
    new = _fingerprint(*_run(T, proto, groups, "exact",
                             obs={"sample_rate": 1.0}))
    assert new == ref


# ------------------------------------------------------------- span trees

def _traced(M, proto="pigpaxos", groups=2):
    c, st = _run(M, proto, groups, "exact", obs={"sample_rate": 1.0})
    tr = c.obs_tracer
    assert tr is not None and tr.finished, "no finished traces collected"
    return c, st, tr


@pytest.mark.parametrize("case", list(CONFIGS))
def test_span_trees_well_formed_and_equal_reference(case):
    proto, groups = CONFIGS[case]
    _, _, tr = _traced(T, proto, groups)
    _, _, rtr = _traced(R, proto, groups)
    assert tr.spans == rtr.spans and tr.meta == rtr.meta
    assert tr.finished == rtr.finished
    cats = set()
    for tid in tr.finished:
        spans = tr.trace_of(tid)
        roots = [sp for sp in spans if sp[1] == -1]
        assert len(roots) == 1 and roots[0] is spans[0]
        assert spans[0][2] == "op" and spans[0][5] is not None
        for sp in spans:
            sid, parent, cat, node, t0, t1 = sp
            cats.add(cat)
            assert sid == spans.index(sp)
            if parent != -1:
                assert 0 <= parent < sid
            assert t1 is not None and t1 >= t0
    assert {"op", "ser", "net", "queue", "svc"} <= cats
    if proto == "pigpaxos":
        assert "relay" in cats


def test_sampling_is_every_kth_op():
    _, _, tr = _traced(T)
    assert tr.sample_every == 1 and tr.n_ops == tr._next_tid
    c2, _ = _run(T, "pigpaxos", 2, "exact", obs={"sample_rate": 0.1})
    r2, _ = _run(R, "pigpaxos", 2, "exact", obs={"sample_rate": 0.1})
    tr2 = c2.obs_tracer
    assert tr2.sample_every == 10
    assert tr2._next_tid == tr2.n_ops // 10
    assert tr2.spans == r2.obs_tracer.spans
    c0, st0 = _run(T, "pigpaxos", 2, "exact", obs={"sample_rate": 0.0})
    assert c0.obs_tracer._next_tid == 0 and st0.committed > 0


def test_hop_table_drains():
    _, _, tr = _traced(T)
    assert len(tr._hop) == 0


# ---------------------------------------------------------- critical path

@pytest.mark.parametrize("case", list(CONFIGS))
def test_critical_path_segments_sum_and_equal_reference(case):
    proto, groups = CONFIGS[case]
    _, _, tr = _traced(T, proto, groups)
    _, _, rtr = _traced(R, proto, groups)
    for tid in tr.finished:
        segs = TO.decompose(tr.trace_of(tid))
        assert segs == RO.decompose(rtr.trace_of(tid))
        total = sum(segs[s] for s in TO.SEGMENTS)
        lat = tr.op_latency(tid)
        assert segs["total"] == pytest.approx(lat, abs=1e-12)
        assert total == pytest.approx(lat, abs=1e-9)
    cp = TO.critical_path(tr)
    assert cp == RO.critical_path(rtr)
    assert cp["n_ops"] == len(tr.finished)
    lats = [tr.op_latency(t) * 1e3 for t in tr.finished]
    assert sum(cp["mean_ms"].values()) == pytest.approx(np.mean(lats),
                                                        rel=1e-9)
    assert cp["mean_ms"]["net"] > 0.0 and cp["mean_ms"]["svc"] > 0.0
    assert TO.SEGMENTS == RO.SEGMENTS
    assert TO.CAT_PRIORITY == RO.CAT_PRIORITY


def test_decompose_refuses_unfinished():
    for mod in (RO, TO):
        with pytest.raises(ValueError):
            mod.decompose([[0, -1, "op", 0, 0.0, None]])


# ----------------------------------------------------------- relay fairness

# ------------------------------------------------- latency-driven admission

def test_latency_admission_policy_validation():
    for bad in ({"slo_ms": 0.0}, {"slo_ms": -1.0}, {"ewma_alpha": 0.0},
                {"ewma_alpha": 1.5}, {"check_interval": 0.0},
                {"resume_frac": 0.0}, {"resume_frac": 1.2}):
        msgs = []
        for P in (RP, TP):
            with pytest.raises(ValueError) as e:
                P.LatencyAdmissionPolicy(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("slo_ms", [0.5, 10_000.0])
def test_latency_admission_sheds_on_slo_breach(slo_ms):
    got = []
    for M, P in ((R, RP), (T, TP)):
        c = M.Cluster("paxos", 5, seed=2, engine="exact")
        stats = P.attach_latency_admission(
            c, P.LatencyAdmissionPolicy(slo_ms=slo_ms, check_interval=0.005),
            stop_at=0.4)
        st = c.measure(duration=0.3, warmup=0.1, clients=16)
        got.append((dict(stats), st.count, c.sched.events))
    assert got[0] == got[1]
    stats = got[1][0]
    if slo_ms < 1.0:
        assert stats["shed_latency"] > 0 and stats["p99_ewma_ms"] > 0.5
    else:
        assert stats["shed_latency"] == 0 and stats["admitted"] > 0


def test_latency_admission_records_timelines():
    got = []
    for M, P in ((R, RP), (T, TP)):
        c = M.Cluster("paxos", 5, seed=2, engine="exact",
                      obs={"sample_rate": 0.0, "metrics_dt": 0.01})
        P.attach_latency_admission(
            c, P.LatencyAdmissionPolicy(slo_ms=0.5, check_interval=0.005),
            stop_at=0.4)
        got.append(c.measure(duration=0.3, warmup=0.1, clients=16).timelines)
    assert got[0] == got[1]
    series = got[1]["series"]
    assert "adm_p99_ewma_ms" in series and "adm_shedding" in series
    assert max(series["adm_shedding"]["v"]) == 1.0


# ----------------------------------------------------- scenario validation

def test_scenario_obs_checks_are_the_references():
    """obs on the seed stack and on batch EPaxos are refused, the knob
    values checked, in the reference's words."""
    cases = [dict(protocol="paxos", engine="ref", backend="des",
                  obs={"sample_rate": 1.0}),
             dict(protocol="epaxos", backend="batch",
                  obs={"sample_rate": 0.0, "metrics_dt": 0.01}),
             dict(protocol="paxos", backend="des", obs={"sample_rate": 2.0}),
             dict(protocol="paxos", backend="des", obs={"metrics_dt": -0.1})]
    for kw in cases:
        msgs = []
        for S in (RefScenario, Scenario):
            with pytest.raises(ValueError) as e:
                S(name="x/obs", n=5, clients=(60,), **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    assert "observability" in msgs[0] or "sample_rate" in msgs[0] or \
        "metrics_dt" in msgs[0]


# -------------------------------------------------- timelines & stats plumb

def test_stats_carries_timelines_and_warmup_reset():
    warmup = 0.2
    got = []
    for M in (R, T):
        c = M.Cluster("pigpaxos", 5, pig=M.PigConfig(n_groups=2), seed=2,
                      engine="exact",
                      obs={"sample_rate": 0.0, "metrics_dt": 0.02})
        st = c.measure(duration=0.4, warmup=warmup, clients=8)
        got.append((st.timelines, st.count, c.sched.events))
    assert got[0] == got[1]
    tl, count, _ = got[1]
    series = tl["series"]
    for name in ("busy_frac/0", "leader_qdepth", "inflight_slots",
                 "commit_ewma_ms"):
        assert name in series, name
    for name, s in series.items():
        assert all(t >= warmup for t in s["t"]), name
    assert tl["latency"]["count"] >= count > 0
    _, st = _run(T, "paxos", None, "exact")
    assert st.timelines is None


# ---------------------------------------------------------------- exporters

def test_perfetto_export_and_artifact_section(tmp_path):
    c, _, tr = _traced(T)
    rc, _, rtr = _traced(R)
    n = TO.write_perfetto(str(tmp_path / "t.json"), tr)
    rn = RO.write_perfetto(str(tmp_path / "r.json"), rtr)
    assert n == rn > 0
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    evs = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert len(evs) == n
    for ev in evs[:50]:
        assert ev["ph"] == "X" and ev["dur"] >= 0
        assert {"name", "ts", "pid", "tid"} <= set(ev)
    assert TO.perfetto_events(tr, limit=100) == \
        RO.perfetto_events(rtr, limit=100)
    sec = TO.obs_artifact_section(c)
    assert json.dumps(sec) == json.dumps(RO.obs_artifact_section(rc))
    assert sec["trace"]["ops_finished"] > 0
    assert set(sec["critical_path"]["mean_ms"]) == set(TO.SEGMENTS)
    assert sec["perfetto"]["events"] and sec["cpu_busy_s"]["0"] > 0
    assert TO.obs_artifact_section(T.Cluster("paxos", 5)) == {}
