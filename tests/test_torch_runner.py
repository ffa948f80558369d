"""The port's scenario layer: the scale/batch family, the
repro-experiments/v1 artifact the unchanged regression gate reads, and the
CLI.  One quick R=3 grid (8 cells) runs on each side."""
import json

import jax  # noqa: F401  (the reference runner runs on JAX's CPU backend)
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
    want = [n for n in ref_registry.names() if n.startswith("scale/batch/")]
    assert registry.names() == want
    for name in want:
        (p,) = registry.select(name)
        (r,) = ref_registry.select(name)
        pd, rd = p.spec_dict(), r.spec_dict()
        assert {k: rd[k] for k in pd} == pd, name
    assert len(registry.select("scale")) == 9
    with pytest.raises(ValueError, match="matched no scenario"):
        registry.select("fig8/*")


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
