"""The report layer of the port against the reference's, on the CPU: the
paper's analytical model (Eq. 1-3, Tables 1-2, the best-R rules) and the
report rows of the 12 families of the backend override, from the same
artifact through both packages' ``rows_for_artifact``, text for text (the
discrete-event families' rows: ``test_torch_des_runner.py``); the CLI's
``--backend``, ``--rows``, ``--plot`` and ``--trace``.

The artifacts are the port's own runs of every scenario of a family
through the backend override, at a short window (the rows depend on the
artifact, not on how long it ran), one seed and one client count;
``avail/leader/N=25`` keeps a window that spans its fault (crash at 0.8 s,
recovery at 1.2 s), so its row carries the dip depth.
"""
import dataclasses
import json

import pytest

import figures_parity  # noqa: F401  (one intra-op thread)
from repro.core import analytical as ref_analytical
from repro.experiments import report as ref_report
from repro_torch.core import analytical
from repro_torch.experiments import registry, report, run, runner

SPANS_FAULT = "avail/leader/N=25"
FAMILIES = ["table1", "table2", "fig8", "zipf", "conflict", "wan", "scale",
            "batching", "avail", "megagrid", "obs", "reads"]


@pytest.mark.parametrize("n", [5, 9, 25, 49, 101])
def test_analytical_equals_reference(n):
    for r in range(1, n):
        for f in ("follower_messages", "relay_messages",
                  "static_relay_load"):
            assert getattr(analytical, f)(n, r) == \
                getattr(ref_analytical, f)(n, r), (f, n, r)
        assert analytical.leader_messages(r) == \
            ref_analytical.leader_messages(r)
        for rot in (True, False):
            assert analytical.saturation_throughput(n, r, 1e-5, rot) == \
                ref_analytical.saturation_throughput(n, r, 1e-5, rot)
    for f in ("total_messages_per_round", "best_r_static",
              "best_r_rotating", "epaxos_messages", "load_table"):
        assert getattr(analytical, f)(n) == getattr(ref_analytical, f)(n), f
    rs = list(range(1, n))
    assert analytical.load_table(n, rs) == ref_analytical.load_table(n, rs)
    assert analytical.best_r_rotating(n) == 1


def _short(sc):
    """``sc`` at a short quick window, one seed and one client count."""
    if sc.name == SPANS_FAULT:
        kw = dict(quick_duration=0.95)
    else:
        kw = dict(quick_duration=0.03, quick_warmup=0.01)
    return dataclasses.replace(
        sc, quick_clients=(sc.quick_clients or sc.clients)[:1],
        quick_seeds=(sc.quick_seeds or sc.seeds)[:1], quick_skip=False, **kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_rows_equal_reference_rows(family):
    # the override's artifacts: the family's batch and batch_ok scenarios
    scenarios = [_short(sc) for sc in registry.select(family)
                 if sc.backend == "batch" or sc.batch_ok]
    art = runner.run_scenarios(scenarios, quick=True,
                               backend_override="batch", device="cpu")
    assert [sa["name"] for sa in art["scenarios"]] == \
        [sc.name for sc in scenarios]
    got = report.rows_for_artifact(art)
    assert got == ref_report.rows_for_artifact(art)
    names = {row.split(",")[0] for row in got}
    assert names, family
    if family == "fig8":
        assert "fig8/summary" in names
    if family in ("table1", "table2"):
        assert len(got) == len(analytical.load_table(
            25 if family == "table1" else 5))
    if family == "avail":
        assert [row.split(",")[0] for row in got if "dip=" in row] == \
            [SPANS_FAULT]
    assert report.family_rows([family], artifact=art) == got


def test_family_rows_runs_the_families(monkeypatch):
    seen = {}

    def fake(families, **kw):
        seen.update(kw, families=families)
        return {"quick": True, "scenarios": []}
    monkeypatch.setattr(runner, "run_families", fake)
    assert report.family_rows(["fig8"], filter_expr="fig8/static/*",
                              backend_override="batch", device="cpu") == []
    assert seen == {"families": ["fig8"], "quick": True,
                    "filter_expr": "fig8/static/*",
                    "backend_override": "batch", "device": "cpu"}
    # every family of the reference's, failover and lease (once ROADMAP
    # item 13b) among them
    assert list(report.SUMMARIZERS) == list(ref_report.SUMMARIZERS)
    assert set(FAMILIES) < set(report.SUMMARIZERS)


def test_cli_backend_and_rows(capsys, monkeypatch, tmp_path):
    name = "table2/validate/R=1"
    assert run.main(["--filter", name, "--backend", "batch", "--device",
                     "cpu", "--rows"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith(name) and out[1].endswith("cpu")
    assert [line.split(",")[0] for line in out[2:]] == \
        ["table2/R=1", "table2/R=2", "table2/R=4"]
    # without the override the scenario runs on the port's DES, on the host
    assert run.main(["--filter", name, "--device", "cpu", "--rows"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith(name) and " host events=" in out[1]
    assert [line.split(",")[0] for line in out[2:]] == \
        ["table2/R=1", "table2/R=2", "table2/R=4"]
    # an obs scenario forced onto the DES runs there (once it raised,
    # naming ROADMAP item 13b); its plots and trace land where asked
    sc = dataclasses.replace(registry.get("obs/paxos/traced"),
                             quick_duration=0.02, quick_warmup=0.01)
    monkeypatch.setattr(run.registry, "select", lambda flt: [sc])
    plots, trace = tmp_path / "plots", tmp_path / "trace.json"
    assert run.main(["--filter", "obs/paxos/traced", "--device", "cpu",
                     "--rows", "--plot", str(plots), "--trace",
                     str(trace)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("obs/paxos/traced") and " host " in out[1]
    assert out[2].split(",")[0] == "obs/paxos/traced"
    assert any(line.startswith("# wrote") and "plots" in line
               for line in out)
    assert sorted(p.name for p in plots.iterdir()) == [
        "obs_critpath.svg", "obs_latency_cdf.svg", "obs_util_heat.svg"]
    doc = json.loads(trace.read_text())
    assert doc["otherData"]["traced_units"] == 1 and doc["traceEvents"]
