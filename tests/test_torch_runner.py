"""The port's scenario layer: the scale/batch family, the
repro-experiments/v1 artifact the unchanged regression gate reads, and the
CLI.  One quick R=3 grid (8 cells) runs on each side."""
import json

import jax  # noqa: F401  (the reference runner runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from benchmarks import regression_gate
from repro.experiments import registry as ref_registry
from repro.experiments import runner as ref_runner
from repro_torch.experiments import registry, run, runner

# the CPU step loop is bound by per-operation overhead, not arithmetic:
# one intra-op thread is faster here and leaves the other test
# workers their cores
torch.set_num_threads(1)

R3 = "scale/batch/replicates/R=3"
R3_BOUNDS = {"bounds": {R3: [9337.0, 15562.0]}}


@pytest.fixture(scope="module")
def arts():
    port = runner.run_scenarios(registry.select(R3), quick=True,
                                device="cpu")
    ref = ref_runner.run_scenarios(ref_registry.select(R3), quick=True)
    return port, ref


def test_catalog_is_the_scale_batch_family():
    """The port registers the reference's scenarios in the reference's
    order and with its specs: all 187 of them, the 18 that once needed
    ROADMAP item 13b among them (the failover and lease families, the
    overload scenarios with admission control, the traced obs
    scenarios).  Among them, the
    35 ``backend="batch"`` ones (the 9 ``scale/batch/*``, the 8 EPaxos
    ``conflict/*/batch``, the 4 ``megagrid/slice/*`` and the 14 of the
    wan, avail, batching, obs and reads families) and the 44
    discrete-event scenarios marked ``batch_ok`` (Fig. 8, Tables 1-2,
    zipf, conflict, wan and avail), which the backend override runs."""
    from repro_torch.experiments import catalog
    want = ref_registry.names()
    assert registry.names() == want and len(want) == 187
    assert len(set(want)) == 187 and not hasattr(catalog, "NOT_PORTED")
    for name in want:
        (p,) = registry.select(name)
        (r,) = ref_registry.select(name)
        assert p.spec_dict() == r.spec_dict(), name
        assert (p.quick_skip, p.leader_timeout) == (r.quick_skip,
                                                    r.leader_timeout)
    assert len(registry.select("scale")) == 9
    assert len([n for n in want if registry.get(n).backend == "batch"]) == 35
    assert len([n for n in want if registry.get(n).backend == "des"
                and registry.get(n).batch_ok]) == 44
    for fam, count in (("wan", 6), ("avail", 11), ("batching", 18),
                       ("obs", 6), ("reads", 15), ("conflict", 16),
                       ("megagrid", 4), ("fig8", 20), ("table1", 2),
                       ("table2", 2), ("zipf", 5), ("fig9", 3),
                       ("overload", 10), ("failover", 3), ("lease", 2)):
        assert len(registry.select(fam)) == count, fam
    with pytest.raises(ValueError, match="matched no scenario"):
        registry.select("fig99/*")


def test_artifact_has_the_reference_schema(arts):
    port, ref = arts
    assert port["schema"] == ref["schema"] == "repro-experiments/v1"
    assert sorted(port) == sorted(ref)
    (ps,), (rs,) = port["scenarios"], ref["scenarios"]
    assert set(ps) == set(rs) | {"run"}
    assert ps["run"]["device"] == "cpu" and ps["run"]["cells"] == 8
    assert ps["run"]["scan_steps"] > 0
    assert sorted(ps["summary"]) == sorted(rs["summary"])
    assert [sorted(u) for u in ps["units"]] == [sorted(u) for u in rs["units"]]
    for k in ("name", "family", "grid_mode", "quick", "backend",
              "consistency"):
        assert ps[k] == rs[k], k
    # the same cells: R=3 at 60 clients damps last-bit differences
    for a, b in zip(ps["units"], rs["units"]):
        assert (a["clients"], a["seed"]) == (b["clients"], b["seed"])
        assert abs(a["count"] - b["count"]) <= 1
        assert a["p99_ms"] == pytest.approx(b["p99_ms"], rel=1e-5)


def test_regression_gate_passes_the_port_artifact(arts):
    port, _ = arts
    seen = {sa["name"]: sa for sa in port["scenarios"]}
    failures, lines = regression_gate.evaluate(seen, R3_BOUNDS)
    assert failures == [], failures
    assert any(R3 in line and line.startswith("ok") for line in lines)


def test_cli_writes_the_same_artifact(arts, tmp_path, capsys):
    port, _ = arts
    path = tmp_path / "r3.json"
    assert run.main(["--filter", R3, "--device", "cpu",
                     "--json", str(path)]) == 0
    got = json.loads(path.read_text())
    assert R3 in capsys.readouterr().out

    def strip(a):
        a = json.loads(json.dumps(a))
        a.pop("wall_s")
        for sa in a["scenarios"]:
            sa["run"].pop("wall_s")
            sa["run"].pop("stack_s")
            sa["summary"].pop("wall_s")
            for u in sa["units"] + sa["replicates"]:
                u.pop("wall_s")
        return a
    assert strip(got) == strip(port)


def test_quick_skip_and_default_device(monkeypatch):
    (n1025,) = registry.select("scale/batch/N=1025/R=32")
    assert runner.run_scenarios([n1025], quick=True, device="cpu")[
        "scenarios"] == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run_scenarios(registry.select(R3), quick=True)


OBS = "obs/pigpaxos/backlog/batch"


def test_obs_artifact_passes_the_gate_and_matches_reference():
    """A quick artifact of a new family (the obs leader-backlog series)
    through the unchanged gate, fed the bound entries that name the port's
    scenarios, and its units against the reference's: the same schema,
    extras included."""
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        bounds = json.load(f)
    # every entry that names one of the branch families' batch-backend
    # scenarios (the scale family's R=3 window is fed to the gate above,
    # the conflict and megagrid windows below; the windows of the
    # backend override's scenarios, test_torch_figures.py and
    # test_torch_families.py)
    names = {n for n in registry.names()
             if registry.get(n).backend == "batch"
             and not n.startswith(("scale/", "conflict/", "megagrid/"))}
    fed = {sec: {k: v for k, v in entries.items() if k in names}
           for sec, entries in bounds.items()
           if sec in ("bounds", "speedup", "overload")}
    assert fed == {"bounds": {OBS: [6220, 10366]}, "speedup": {},
                   "overload": {}}
    port = runner.run_scenarios(registry.select(OBS), quick=True,
                                device="cpu")
    seen = {sa["name"]: sa for sa in port["scenarios"]}
    failures, lines = regression_gate.evaluate(seen, fed)
    assert failures == [], failures
    assert any(OBS in line and line.startswith("ok") for line in lines)
    ref = ref_runner.run_scenarios(ref_registry.select(OBS), quick=True)
    (ps,), (rs,) = port["scenarios"], ref["scenarios"]
    assert [sorted(u) for u in ps["units"]] == [sorted(u) for u in rs["units"]]
    for a, b in zip(ps["units"], rs["units"]):
        assert abs(a["count"] - b["count"]) <= 1
        assert a["p99_ms"] == pytest.approx(b["p99_ms"], rel=1e-5)
        pa, pb = a["extras"]["obs"], b["extras"]["obs"]
        assert pa["leader_backlog"]["n"] == pb["leader_backlog"]["n"]
        np.testing.assert_allclose(pa["leader_backlog"]["mean_ms"],
                                   pb["leader_backlog"]["mean_ms"],
                                   rtol=1e-5, atol=1e-6)


GATED = ("conflict/N=25/c=0.1/batch", "megagrid/slice/N=9/R=2/PRC=1/lan",
         "megagrid/slice/N=9/R=2/PRC=1/wan3")


def test_epaxos_and_megagrid_artifacts_pass_the_gate():
    """Quick artifacts of the EPaxos conflict grid and two megagrid slices
    (LAN and wan3) through the unchanged gate, fed the bound entries that
    name them; the run records count the scan steps (no fan-in kernel
    launches on the CPU)."""
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        bounds = json.load(f)["bounds"]
    fed = {"bounds": {n: bounds[n] for n in GATED}}
    port = runner.run_scenarios(
        [registry.select(n)[0] for n in GATED], quick=True, device="cpu")
    seen = {sa["name"]: sa for sa in port["scenarios"]}
    failures, lines = regression_gate.evaluate(seen, fed)
    assert failures == [], failures
    assert sum(line.startswith("ok") for line in lines) == 3
    for sa in port["scenarios"]:
        run = sa["run"]
        assert run["scan_steps"] > 0 and run["fanin_launches"] == 0
        assert not any(u["exhausted"] for u in sa["units"])
