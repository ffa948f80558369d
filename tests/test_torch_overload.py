"""The ``overload`` family on the port's discrete-event engines, with the
admission policies, against the reference's, on the CPU, bit for bit.

All ten ``overload/*`` scenarios (the eight with admission control, the
queue-length and token-bucket gate and the latency-driven one, batched,
on PigPaxos and audited, beside the two without) run at their quick
windows through both packages' ``run_scenarios``: every unit's fields and
extras (the overload metrics and the ``admission`` counters) equal, all
but ``wall_s``; the admission gate sheds at 80 clients; the audited cells
pass the linearizability audit; the unchanged regression gate holds the
overload goodput windows and the audited cells' throughput bounds; the
family's report rows text for text and its SVG plots byte for byte."""
import json

import pytest

from benchmarks import regression_gate
from repro.experiments import plot as ref_plot
from repro.experiments import registry as ref_registry
from repro.experiments import report as ref_report
from repro.experiments import runner as ref_runner
from repro_torch.experiments import plot, registry, report, runner

ADMISSION = ["overload/paxos/adm", "overload/paxos/adm+batch",
             "overload/paxos/bursty/adm", "overload/paxos/diurnal/adm",
             "overload/paxos/latadm", "overload/pigpaxos/adm",
             "overload/audit/adm", "overload/audit/adm+batch"]


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


@pytest.fixture(scope="module")
def arts():
    port = runner.run_scenarios(registry.select("overload"), quick=True,
                                ignore_quick_skip=True)
    ref = ref_runner.run_scenarios(ref_registry.select("overload"),
                                   quick=True, ignore_quick_skip=True)
    return port, ref


def test_overload_scenarios_equal_reference(arts):
    port, ref = arts
    assert _bare(port) == _bare(ref)
    got = {sa["name"]: sa for sa in port["scenarios"]}
    assert set(ADMISSION) < set(got) and len(got) == 10
    for name in ADMISSION:
        sa = got[name]
        assert sa["backend"] == "des" and sa["run"]["device"] == "host"
        for u in sa["units"]:
            adm = u["extras"]["admission"]
            assert adm["admitted"] > 0, name
            assert {"p999_ms", "goodput", "offered", "client_shed",
                    "client_rejected"} <= set(u["extras"])
    # the queue and token-bucket gate sheds at 4x the saturation load
    (u80,) = [u for u in got["overload/paxos/adm"]["units"]
              if u["clients"] == 80]
    adm = u80["extras"]["admission"]
    assert adm["shed_queue"] + adm["shed_rate"] > 0
    assert u80["extras"]["client_rejected"] > 0
    lat = [u for u in got["overload/paxos/latadm"]["units"]
           if u["clients"] == 80][0]["extras"]["admission"]
    assert lat["shed_latency"] > 0
    for name in ("overload/audit/adm", "overload/audit/adm+batch"):
        assert got[name]["consistency"] == "audited"
        assert all(u["consistency"] == "ok" for u in got[name]["units"])


def test_gate_holds_the_overload_windows(arts):
    port, _ = arts
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        bounds = json.load(f)
    fed = {"bounds": {n: v for n, v in bounds["bounds"].items()
                      if n.startswith("overload/")},
           "overload": bounds["overload"]}
    assert len(fed["bounds"]) == 2 and len(fed["overload"]) == 3
    seen = {sa["name"]: sa for sa in port["scenarios"]}
    failures, lines = regression_gate.evaluate(seen, fed)
    assert failures == [], failures
    assert sum(line.startswith("ok") for line in lines) == 5


def test_overload_rows_and_plots_equal_reference(arts, tmp_path):
    port, _ = arts
    rows = report.rows_for_artifact(port)
    assert rows == ref_report.rows_for_artifact(port)
    names = {r.split(",")[0] for r in rows}
    assert any("adm" in n for n in names) and len(rows) > 10
    got = plot.render_artifact(port, str(tmp_path / "port"))
    want = ref_plot.render_artifact(port, str(tmp_path / "ref"))
    assert [p.rsplit("/", 1)[1] for p in got] == \
        [p.rsplit("/", 1)[1] for p in want]
    assert "overload_throughput.svg" in {p.rsplit("/", 1)[1] for p in got}
    for a, b in zip(got, want):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), a
