"""The port's failover and admission policies (``repro_torch.runtime.
policy``) against the reference's (``repro.runtime.policy``), on the CPU,
bit for bit.

Each policy attached to the same cluster in both packages: the failover
detector's promotions, the admission gates' counters and shed replies,
the latency gate's breaker, and the stats, event for event.  Then the
``failover`` and ``lease`` families' five exact-engine scenarios through
both packages' ``run_scenarios``, unit for unit (all but ``wall_s``): the
leader crashes at 0.8 s and never recovers, and the policy elects a
successor.  Their quick window (30 clients for 1.2 s) takes ~20 s a cell
and a package here, so both sides run the same ``dataclasses.replace``:
4 clients, 0.05 s of warmup and 1.05 s measured, which keeps the crash,
the detection (50-200 ms), the election and the recovery inside the
window; the equality does not depend on the window.  Their report rows
text for text, their SVG plots byte for byte, and the audit's verdict
(no stale read across the failover, ``consistency="ok"``)."""
import dataclasses
import json

import pytest

import repro.core as R
import repro_torch.core as T
from repro.experiments import plot as ref_plot
from repro.experiments import registry as ref_registry
from repro.experiments import report as ref_report
from repro.experiments import runner as ref_runner
from repro.runtime import policy as RP
from repro_torch.experiments import plot, registry, report, runner
from repro_torch.runtime import policy as TP

FAILOVER = ["failover/detect=50ms", "failover/detect=100ms",
            "failover/detect=200ms", "lease/expiry/d=50ms",
            "lease/expiry/d=400ms"]
SHORT = dict(clients=(4,), warmup=0.05, duration=1.05, quick_duration=1.05)


def _bare(art):
    art = json.loads(json.dumps(art))
    for k in ("wall_s", "processes"):
        art.pop(k)
    for sa in art["scenarios"]:
        sa.pop("run", None)
        sa["summary"].pop("wall_s")
        for u in sa["units"] + sa["replicates"]:
            u.pop("wall_s")
    return art


# ------------------------------------------------------------- the policies

def test_policy_validation_is_the_references():
    cases = [("FailoverPolicy", dict(successor="random")),
             ("FailoverPolicy", dict(detect_timeout=0.0)),
             ("FailoverPolicy", dict(check_interval=-1.0)),
             ("AdmissionPolicy", dict(max_queue=-1)),
             ("AdmissionPolicy", dict(rate_hz=-5.0)),
             ("AdmissionPolicy", dict(rate_hz=100.0, burst=0.5))]
    for cls, kw in cases:
        msgs = []
        for P in (RP, TP):
            try:
                getattr(P, cls)(**kw)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1], (cls, kw)
    for n in (3, 5, 9, 25, 49, 101):
        assert TP.ElasticityPolicy().groups_for(n) == \
            RP.ElasticityPolicy().groups_for(n)


def _failover_run(M, P, successor):
    c = M.Cluster("pigpaxos", 9, pig=M.PigConfig(n_groups=2, prc=1), seed=4,
                  engine="exact")
    c.crash_at(0, 0.2)
    evs = P.attach_failover(c, P.FailoverPolicy(
        detect_timeout=0.05, check_interval=0.01, successor=successor),
        stop_at=0.5)
    st = c.measure(duration=0.4, warmup=0.1, clients=6,
                   workload=M.WorkloadConfig(request_timeout=25e-3))
    return (evs, c.leader_id, st.count, st.committed, c.sched.events,
            [cl.latencies for cl in c.clients])


@pytest.mark.parametrize("successor", ["next", "lowest"])
def test_failover_policy_equals_reference(successor):
    got = _failover_run(T, TP, successor)
    assert got == _failover_run(R, RP, successor)
    evs, leader = got[0], got[1]
    assert evs and evs[0]["from"] == 0 and leader != 0
    assert evs[0]["to"] == 1           # both rules pick node 1 here


def _admission_run(M, P, kind):
    c = M.Cluster("paxos", 5, seed=2, engine="fast")
    wl = M.WorkloadConfig(arrival="poisson", rate_hz=800.0,
                          max_outstanding=16, reject_action="drop")
    if kind == "queue":
        stats = P.attach_admission(c, P.AdmissionPolicy(
            max_queue=8, rate_hz=3000.0, burst=16.0), stop_at=0.3)
    else:
        stats = P.attach_latency_admission(c, P.LatencyAdmissionPolicy(
            slo_ms=1.0, check_interval=0.005), stop_at=0.3)
    c.admission_stats = stats
    st = c.measure(duration=0.2, warmup=0.1, clients=20, workload=wl)
    return (dict(stats), st.count, st.committed, c.sched.events,
            sum(getattr(cl, "rejected", 0) for cl in c.clients))


@pytest.mark.parametrize("kind", ["queue", "latency"])
def test_admission_policies_equal_reference(kind):
    got = _admission_run(T, TP, kind)
    assert got == _admission_run(R, RP, kind)
    stats, rejected = got[0], got[4]
    assert stats["admitted"] > 0
    shed = sum(v for k, v in stats.items() if k.startswith("shed"))
    assert shed > 0 and rejected > 0


def test_admission_wrapper_is_read_at_each_delivery():
    """The policy writes its wrapper into ``node._dispatch[ClientRequest]``
    after the cluster is built; the fused loops read the table at each
    delivery, so the wrapper runs (a shed request is bounced)."""
    from repro_torch.core.messages import ClientRequest
    c = T.Cluster("paxos", 5, seed=2, engine="exact")
    stats = TP.attach_admission(c, TP.AdmissionPolicy(max_queue=1),
                                stop_at=0.3)
    wrapper = c.nodes[0]._dispatch[ClientRequest]
    assert wrapper.__qualname__.startswith("attach_admission.")
    c.measure(duration=0.15, warmup=0.05, clients=16)
    assert stats["admitted"] > 0 and stats["shed_queue"] > 0


# ---------------------------------------- the failover and lease scenarios

@pytest.fixture(scope="module")
def failover_arts():
    def pick(reg):
        return [dataclasses.replace(reg.get(n), **SHORT) for n in FAILOVER]
    port = runner.run_scenarios(pick(registry), quick=True,
                                ignore_quick_skip=True)
    ref = ref_runner.run_scenarios(pick(ref_registry), quick=True,
                                   ignore_quick_skip=True)
    return port, ref


def test_failover_and_lease_scenarios_equal_reference(failover_arts):
    port, ref = failover_arts
    assert _bare(port) == _bare(ref)
    arts = {sa["name"]: sa for sa in port["scenarios"]}
    assert list(arts) == FAILOVER
    for name, sa in arts.items():
        assert sa["backend"] == "des" and sa["run"]["device"] == "host"
        assert sa["consistency"] == "audited"
        (u,) = sa["units"]
        assert u["consistency"] == "ok", (name, u["audit"])
        ex = u["extras"]
        assert ex["failover_events"], name
        assert ex["failover_events"][0]["from"] == 0
        assert ex["unavail_ms"] > 0 and ex["timeline"]["counts"]
    unavail = {n: arts[n]["units"][0]["extras"]["unavail_ms"]
               for n in FAILOVER}
    # detection budget and lease duration both widen the window
    assert unavail["failover/detect=50ms"] < unavail["failover/detect=200ms"]
    assert unavail["lease/expiry/d=50ms"] < unavail["lease/expiry/d=400ms"]


def test_failover_rows_and_plots_equal_reference(failover_arts, tmp_path):
    port, _ = failover_arts
    rows = report.rows_for_artifact(port)
    assert rows == ref_report.rows_for_artifact(port)
    assert [r.split(",")[0] for r in rows] == sorted(FAILOVER[:3]) + [
        "failover/summary"] + sorted(FAILOVER[3:]) + [
        "lease/expiry/summary"]
    assert "as required" in rows[-1]
    got = plot.render_artifact(port, str(tmp_path / "port"))
    want = ref_plot.render_artifact(port, str(tmp_path / "ref"))
    assert [p.rsplit("/", 1)[1] for p in got] == \
        [p.rsplit("/", 1)[1] for p in want]
    assert got
    for a, b in zip(got, want):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), a
