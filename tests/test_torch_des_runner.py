"""The port's scenario layer on the discrete-event engines, against the
reference's, on the CPU: quick artifacts unit for unit (all but
``wall_s``), serial and pooled; ``backend_override="des"``; the registry
(the reference's names minus the 18 that need ROADMAP item 13b, which
raise naming it); the summarizers of the discrete-event families, row for
row on one artifact; and the unchanged regression gate on the port's
fidelity and speedup pairs (the batch halves on the CPU)."""
import dataclasses
import json

import pytest
import torch

import figures_parity  # noqa: F401  (one intra-op thread)
from benchmarks import regression_gate
from repro.experiments import registry as ref_registry
from repro.experiments import report as ref_report
from repro.experiments import runner as ref_runner
from repro_torch.core import PigConfig, WorkloadConfig
from repro_torch.experiments import registry, report, runner
from repro_torch.experiments.catalog import NOT_PORTED
from repro_torch.experiments.scenario import Scenario
from repro_torch.faults.plan import FaultPlan

QUICK = ["wan/N=25", "batching/paxos/m=1", "reads/paxos/log/r=0.9",
         "fig17/paxos"]


def _bare(art):
    """An artifact without its walls, the pool size and the port's
    ``run`` record."""
    art = json.loads(json.dumps(art))
    art.pop("wall_s")
    art.pop("processes")
    for sa in art["scenarios"]:
        sa.pop("run", None)
        sa["summary"].pop("wall_s")
        for u in sa["units"] + sa["replicates"]:
            u.pop("wall_s")
    return art


@pytest.fixture(scope="module")
def quick_arts():
    port = runner.run_scenarios(registry.select(",".join(QUICK)),
                                quick=True)
    ref = ref_runner.run_scenarios(ref_registry.select(",".join(QUICK)),
                                   quick=True)
    return port, ref


def test_quick_artifacts_equal_reference_unit_for_unit(quick_arts):
    port, ref = quick_arts
    assert _bare(port) == _bare(ref)
    arts = {sa["name"]: sa for sa in port["scenarios"]}
    assert sorted(arts) == sorted(QUICK)
    for sa in arts.values():
        run = sa["run"]
        assert run["device"] == "host" and run["cells"] == len(sa["units"])
        assert run["events"] > 0 and run["wall_s"] > 0
        assert sa["backend"] == "des"
    reads = arts["reads/paxos/log/r=0.9"]
    assert reads["consistency"] == "audited"
    assert all(u["consistency"] == "ok" for u in reads["units"])
    assert "rw" in reads["units"][0]["extras"]
    assert "flight_per_op" in arts["fig17/paxos"]["units"][0]["extras"]


def test_pooled_artifact_equals_serial(quick_arts):
    port, _ = quick_arts
    pooled = runner.run_scenarios(registry.select(",".join(QUICK)),
                                  quick=True, processes=2)
    assert pooled["processes"] == 2 and port["processes"] == 0
    assert _bare(pooled) == _bare(port)
    assert [sa["run"]["events"] for sa in pooled["scenarios"]] == \
        [sa["run"]["events"] for sa in port["scenarios"]]


def test_units_pool_longest_first():
    """The pool orders the units longest first by the reference's cost
    estimate."""
    sc = registry.get("fig9/paxos")
    rs = sc.resolve(True)
    payloads = [(sc, k, s, rs.duration, rs.warmup) for k, s in rs.units()]
    rsc = ref_registry.get("fig9/paxos")
    assert [runner._unit_cost_estimate(p) for p in payloads] == \
        [ref_runner._unit_cost_estimate((rsc,) + p[1:]) for p in payloads]


def test_des_suite_touches_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = runner.run_scenarios(registry.select("table2/validate/R=1"),
                               quick=True)
    assert art["scenarios"][0]["run"]["device"] == "host"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run_scenarios(registry.select(
            "table2/validate/R=1,megagrid/slice/N=9/R=2/PRC=1/lan"),
            quick=True)


def test_backend_override_des_equals_reference():
    name = "megagrid/slice/N=9/R=2/PRC=1/lan"
    port = runner.run_scenarios(registry.select(name), quick=True,
                                backend_override="des")
    ref = ref_runner.run_scenarios(ref_registry.select(name), quick=True,
                                   backend_override="des")
    assert _bare(port) == _bare(ref)
    (sa,) = port["scenarios"]
    assert sa["backend"] == sa["spec"]["backend"] == "des"
    assert sa["run"]["device"] == "host"


def _port_spec(ref_sc):
    """The reference's scenario rebuilt from the port's classes."""
    kw = {f.name: getattr(ref_sc, f.name)
          for f in dataclasses.fields(ref_sc)}
    if kw["pig"] is not None:
        kw["pig"] = PigConfig(**dataclasses.asdict(kw["pig"]))
    if kw["workload"] is not None:
        kw["workload"] = WorkloadConfig(**dataclasses.asdict(kw["workload"]))
    if kw["faults"] is not None:
        kw["faults"] = FaultPlan(**{f.name: getattr(kw["faults"], f.name)
                                    for f in dataclasses.fields(FaultPlan)})
    return kw


def test_registry_is_the_reference_minus_item_13b():
    ref = ref_registry.names()
    assert registry.names() == [n for n in ref if n not in NOT_PORTED]
    assert len(registry.names()) == len(ref) - 18 == 169
    fams = {}
    for n in NOT_PORTED:
        fams[n.split("/")[0]] = fams.get(n.split("/")[0], 0) + 1
    assert fams == {"failover": 3, "lease": 2, "overload": 8, "obs": 5}
    for name in NOT_PORTED:
        with pytest.raises(KeyError, match="ROADMAP item 13b"):
            registry.get(name)
        with pytest.raises(ValueError, match="ROADMAP item 13b"):
            Scenario(**_port_spec(ref_registry.get(name)))
    for fam in ("failover", "lease"):
        with pytest.raises(ValueError, match="ROADMAP item 13b"):
            registry.select(fam)
    # the rest rebuilt from the reference's objects equal the catalog's
    for name in registry.names():
        got = Scenario(**_port_spec(ref_registry.get(name)))
        assert got == registry.get(name), name


# every discrete-event family's summarizer, each on its scenarios at a
# short window (the rows read the artifact, not how long it ran)
DES_FAMILIES = ["fig9", "fig10", "fig11", "fig12", "fig13", "fig14",
                "fig15", "fig16", "fig17", "openloop", "storm", "reconfig",
                "rolling", "overload", "batching", "reads", "avail", "zipf",
                "conflict", "wan", "table1", "table2", "fig8"]


def _short(sc):
    return dataclasses.replace(
        sc, quick_clients=(sc.quick_clients or sc.clients)[:1],
        quick_seeds=(sc.quick_seeds or sc.seeds)[:1], quick_skip=False,
        quick_duration=0.03, quick_warmup=0.01)


@pytest.fixture(scope="module")
def family_art():
    scenarios = [_short(sc) for fam in DES_FAMILIES
                 for sc in registry.select(fam) if sc.backend == "des"
                 and (fam not in ("fig8", "conflict", "wan", "table1",
                                  "table2", "zipf") or sc.n <= 25)]
    return runner.run_scenarios(scenarios, quick=True)


@pytest.mark.parametrize("family", DES_FAMILIES)
def test_des_rows_equal_reference_rows(family, family_art, tmp_path,
                                       monkeypatch):
    monkeypatch.chdir(tmp_path)      # fig17 writes artifacts/ in the cwd
    art = dict(family_art, scenarios=[sa for sa in family_art["scenarios"]
                                      if sa["family"] == family])
    assert art["scenarios"], family
    got = report.rows_for_artifact(art)
    assert got and got == ref_report.rows_for_artifact(art), family
    assert report.family_rows([family], artifact=art) == got


def test_regression_gate_passes_the_ports_batching_pairs():
    """The unchanged gate on the port's quick artifact of the
    ``batching/paxos/m={1,8}`` fidelity pairs and the speedup floor: the
    DES halves on the host, the batch halves on the CPU."""
    names = ["batching/paxos/m=1", "batching/paxos/m=8",
             "batching/paxos/m=1/batch", "batching/paxos/m=8/batch"]
    art = runner.run_scenarios(registry.select(",".join(names)),
                               quick=True, device="cpu")
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        bounds = json.load(f)
    fed = {"bounds": {n: v for n, v in bounds["bounds"].items()
                      if n in names},
           "fidelity": {n: bounds["fidelity"][n] for n in names[:2]},
           "speedup": {names[1]: bounds["speedup"][names[1]]}}
    assert len(fed["bounds"]) == 2
    seen = {sa["name"]: sa for sa in art["scenarios"]}
    failures, lines = regression_gate.evaluate(seen, fed)
    assert failures == [], failures
    assert sum(line.startswith("ok") for line in lines) == 5
