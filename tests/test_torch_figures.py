"""The paper's Fig. 8 on the port, and the runner's backend override, on
the CPU against the JAX reference.

``run_scenarios(..., backend_override="batch")`` switches the 44
discrete-event scenarios marked ``batch_ok`` to the batch backend, as the
reference's runner does: the same switched spec, the same filtered
``collect``, ``backend="batch"`` and ``consistency="model"`` in the
artifact; ``backend_override="des"`` forces the batch scenarios onto the
port's discrete-event engines (an ``obs`` scenario among them, with its
traced ``obs`` extras), as the reference's does.

Parity per cell is held as ``figures_parity`` states; the Fig. 8 cells
here are the rotating and static relays at R=1 (a chaotic cell and a
saturated static relay), static R=5 and the N=49 sweep's R=7 (F=48 in
groups of 7 and 6).  The static relay's difference from the reference's
jit run is not the port's: run op by op the reference equals the port bit
for bit, step by step (``test_static_relay_steps_equal_reference_op_by_op``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from benchmarks import regression_gate
from figures_parity import check_cell, port_art, ref_art
from repro.core import PigConfig as RefPig
from repro.core import vectorsim as rvs
from repro.experiments import registry as ref_registry
from repro.experiments import runner as ref_runner
from repro.experiments.scenario import Scenario as RefScenario
from repro_torch.convert import cells_from_numpy
from repro_torch.core import vectorsim as tvs
from repro_torch.experiments import registry, runner
from repro_torch.experiments.scenario import Scenario

DES_OK = [n for n in ref_registry.names()
          if ref_registry.get(n).backend == "des"
          and ref_registry.get(n).batch_ok]


def test_the_44_batch_ok_scenarios_are_registered():
    assert len(DES_OK) == 44
    assert [n for n in registry.names()
            if registry.get(n).backend == "des"
            and registry.get(n).batch_ok] == DES_OK
    fams = {}
    for n in DES_OK:
        fams[n.split("/")[0]] = fams.get(n.split("/")[0], 0) + 1
    assert fams == {"table1": 2, "table2": 2, "fig8": 20, "zipf": 5,
                    "conflict": 8, "wan": 3, "avail": 4}


@pytest.mark.parametrize("name", ["table1/validate/R=1", "fig8/static/R=3",
                                  "avail/relay/N=49", "wan/N=101",
                                  "conflict/N=49/c=0.5"])
def test_override_switches_the_spec_as_the_reference_does(name):
    """The switched scenario (backend, filtered collect, the rest of the
    spec) equals the reference's, field for field."""
    (got,) = runner._override([registry.get(name)], "batch")
    ref = ref_registry.get(name)
    want = dataclasses.replace(ref, backend="batch", collect=tuple(
        c for c in ref.collect if c == "per_node_msgs"
        or (c == "timeline" and ref.fault_plan() is not None)))
    assert got.backend == "batch" and got.spec_dict() == want.spec_dict()
    assert got.collect == want.collect


def test_override_artifact_has_the_reference_schema():
    """One quick run on each side: the artifact's keys, the recorded spec
    (switched), backend, consistency and the units' fields, extras
    included."""
    name = "table2/validate/R=1"
    (ps,), (rs,) = (port_art(name)["scenarios"],
                    ref_art(name)["scenarios"])
    assert set(ps) == set(rs) | {"run"}
    assert ps["spec"] == rs["spec"] and ps["spec"]["backend"] == "batch"
    assert ps["spec"]["collect"] == ["per_node_msgs"]
    assert ps["backend"] == rs["backend"] == "batch"
    assert ps["consistency"] == rs["consistency"] == "model"
    assert [sorted(u) for u in ps["units"]] == [sorted(u) for u in rs["units"]]
    assert [sorted(u["extras"]) for u in ps["units"]] == \
        [sorted(u["extras"]) for u in rs["units"]]
    assert ps["run"]["device"] == "cpu" and ps["run"]["scan_steps"] > 0


def test_des_scenarios_raise_instead_of_skipping():
    sc = registry.get("fig8/rotating/R=1")
    # forced onto the DES, a batch scenario that needs the observability
    # layer runs there, as on the reference (a short window: the obs
    # extras are the point), and equals the reference's run
    short = dict(quick_duration=0.05, quick_warmup=0.02, quick_seeds=(2,))
    obs = dataclasses.replace(registry.get("obs/pigpaxos/backlog/batch"),
                              **short)
    ref = dataclasses.replace(
        ref_registry.get("obs/pigpaxos/backlog/batch"), **short)
    got = runner.run_scenarios([obs], quick=True, backend_override="des",
                               device="cpu")["scenarios"]
    want = ref_runner.run_scenarios([ref], quick=True,
                                    backend_override="des")["scenarios"]
    (ps,), (rs,) = got, want
    assert ps["backend"] == rs["backend"] == "des"
    assert ps["run"]["device"] == "host"
    for u, v in zip(ps["units"], rs["units"]):
        assert {**u, "wall_s": 0} == {**v, "wall_s": 0}
    assert ps["units"][0]["extras"]["obs"]["cpu_busy_s"]
    with pytest.raises(ValueError, match="unknown backend override"):
        runner.run_scenarios([sc], quick=True, backend_override="gpu",
                             device="cpu")
    # a quick_skip scenario is dropped before the check, as the
    # reference's runner drops it
    (r4,) = registry.select("fig8/rotating/R=4")
    assert runner.run_scenarios([r4], quick=True, device="cpu")[
        "scenarios"] == []


def test_a_des_scenario_that_is_not_batch_ok_is_refused():
    # the port runs every discrete-event scenario, those with obs,
    # failover, admission or engine="ref" among them, with the
    # reference's spec; only the batch backend refuses them
    sc = Scenario(name="fig9/paxos", protocol="paxos", n=25, backend="des")
    assert sc.spec_dict() == RefScenario(name="fig9/paxos", protocol="paxos",
                                         n=25).spec_dict()
    for kw in (dict(obs={"sample_rate": 0.1}),
               dict(failover={"detect_timeout": 0.05}),
               dict(admission={"max_queue": 32}), dict(engine="ref")):
        got = Scenario(name="fig9/paxos", protocol="paxos", n=25,
                       backend="des", **kw)
        assert got.spec_dict() == RefScenario(
            name="fig9/paxos", protocol="paxos", n=25, **kw).spec_dict()
        if "engine" in kw or "obs" in kw:     # the batch backend takes
            continue                           # these (obs: its backlog)
        msgs = []
        for S in (Scenario, RefScenario):
            with pytest.raises(ValueError) as e:
                S(name="fig9/paxos", protocol="paxos", n=25,
                  backend="batch", **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown backend"):
        Scenario(name="x", protocol="paxos", n=25, backend="sim")
    # the batch checks run again on the switched spec
    bad = Scenario(name="x", protocol="paxos", n=25, backend="des",
                   batch_ok=True, collect=("flight",))
    want = RefScenario(name="x", protocol="paxos", n=25, batch_ok=True,
                       collect=("flight",))
    with pytest.raises(ValueError) as got:
        dataclasses.replace(bad, backend="batch")
    with pytest.raises(ValueError) as ref:
        dataclasses.replace(want, backend="batch")
    assert str(got.value) == str(ref.value)


def test_select_by_families_subset_and_run_families(monkeypatch):
    for fams, flt in ((["fig8"], None), (["table1", "table2"], None),
                      (["fig8", "zipf"], "zipf/*,fig8/static/*"),
                      (None, "conflict")):
        want = [s.name for s in ref_registry.select(flt, fams)]
        assert [s.name for s in registry.select(flt, fams)] == want
    seen = {}

    def fake(scenarios, **kw):
        seen.update(kw, names=[s.name for s in scenarios])
        return {}
    monkeypatch.setattr(runner, "run_scenarios", fake)
    runner.run_families(["fig8"], quick=True, filter_expr="fig8/static/*",
                        backend_override="batch", device="cpu")
    assert seen == {"quick": True, "ignore_quick_skip": True,
                    "processes": 0,
                    "backend_override": "batch", "device": "cpu",
                    "names": [f"fig8/static/R={r}"
                              for r in (1, 2, 3, 4, 5, 6, 8)]}


FIG8_CELLS = ["fig8/rotating/R=1", "fig8/static/R=1", "fig8/static/R=5",
              "fig8/scale/N=49/R=7"]


@pytest.mark.parametrize("name", FIG8_CELLS)
def test_fig8_cell_matches_reference(name):
    """Quick grids.  Measured: rotating R=1 (chaotic) counts 9 of 6872,
    percentiles 1.8e-2; static R=1 counts equal, percentiles 4.58e-5;
    static R=5 equal; N=49 R=7 percentiles 2.1e-6."""
    worst, tol, kind = check_cell(name)
    assert kind == {"fig8/rotating/R=1": "chaotic"}.get(
        name, "static" if "/static/" in name else "damped")


def _capture(lat, t_fin, commit_t, active, ready, loadF, loadL, cell,
             nb=0):
    return {"lat": lat, "t_fin": t_fin, "commit": commit_t,
            "active": active, "ready": ready, "loadF": loadF,
            "loadL": loadL}


def test_static_relay_steps_equal_reference_op_by_op(monkeypatch):
    """``fig8/static/R=1`` at 120 clients: the reference's
    ``_group_cell`` run op by op against the port's, bit for bit, for 10
    scan steps (80 requests through the saturated relay; the reference's
    jit run parts from its op-by-op run in the first steps)."""
    cfg = rvs.build_config("pigpaxos", 25, pig=RefPig(
        n_groups=1, prc=1, rotate_relays=False))
    batch, kind, kmax = rvs._stack_cells([cfg], [(0, 120, 2)], 0.4, 0.25)
    monkeypatch.setattr(rvs, "_summarize", _capture)
    monkeypatch.setattr(tvs, "_summarize", _capture)
    with jax.disable_jit():
        want = rvs._group_cell({k: v[0] for k, v in batch.items()}, 10,
                               kmax, 8)
    got = tvs._run_cells(cells_from_numpy(batch, "cpu"), 10, kmax, 8)
    assert np.asarray(want["active"]).all()
    for k, v in want.items():
        assert np.array_equal(got[k][0].numpy(), np.asarray(v)), k


def test_fig8_rotating_r1_passes_the_gate():
    """The quick artifact through the unchanged gate, fed the bound entry
    that names it."""
    name = "fig8/rotating/R=1"
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        fed = {"bounds": {name: json.load(f)["bounds"][name]}}
    seen = {sa["name"]: sa for sa in port_art(name)["scenarios"]}
    failures, lines = regression_gate.evaluate(seen, fed)
    assert failures == [], failures
    assert any(name in line and line.startswith("ok") for line in lines)
