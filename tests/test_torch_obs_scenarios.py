"""The ``obs`` family's five discrete-event scenarios on the port,
against the reference's, on the CPU, bit for bit.

Both packages' ``run_scenarios``, artifact for artifact (without walls):
the three traced cells (span tracing at rate 0.1, timelines every 10 ms,
Perfetto events, critical paths) at a shortened window, the same
``dataclasses.replace`` on both sides (their quick window takes ~5-10 s a
cell and a package here; the equality does not depend on it), and the
relay-fairness pair at its quick window.  The unchanged regression gate
holds the fairness pair (rotating relays' follower busy max/mean under
the static relays' and under 1.5), and the family's report rows are equal
text for text and its SVG plots byte for byte."""
import dataclasses
import json

import pytest

from benchmarks import regression_gate
from repro.experiments import plot as ref_plot
from repro.experiments import registry as ref_registry
from repro.experiments import report as ref_report
from repro.experiments import runner as ref_runner
from repro_torch.experiments import plot, registry, report, runner

TRACED = ["obs/pigpaxos/traced", "obs/paxos/traced", "obs/epaxos/traced"]
FAIRNESS = ["obs/fairness/rotating", "obs/fairness/static"]
# the traced cells at a shortened window, the same on both sides
SHORT = dict(warmup=0.1, duration=0.06, quick_duration=0.06)


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
def obs_arts():
    def pick(reg):
        return ([dataclasses.replace(reg.get(n), **SHORT) for n in TRACED]
                + [reg.get(n) for n in FAIRNESS])
    port = runner.run_scenarios(pick(registry), quick=True,
                                ignore_quick_skip=True)
    ref = ref_runner.run_scenarios(pick(ref_registry), quick=True,
                                   ignore_quick_skip=True)
    return port, ref


def test_obs_scenarios_equal_reference(obs_arts):
    port, ref = obs_arts
    assert _bare(port) == _bare(ref)
    arts = {sa["name"]: sa for sa in port["scenarios"]}
    assert list(arts) == TRACED + FAIRNESS
    for name, sa in arts.items():
        assert sa["backend"] == "des" and sa["run"]["device"] == "host"
        assert sa["run"]["events"] > 0
        ob = sa["units"][0]["extras"]["obs"]
        assert ob["cpu_busy_s"] and ob["timelines"]["series"]
        if name in TRACED:
            assert ob["trace"]["ops_finished"] > 0
            assert ob["perfetto"]["events"]
            assert len(ob["perfetto"]["events"]) <= 2000


def test_rotating_relays_flatten_follower_load(obs_arts):
    """Fig. 8's hotspot claim from the obs CPU attribution of the
    fairness pair (N=25, 5 relay groups, the fast engine), held by the
    unchanged gate's ``obs_fairness`` entry: rotating relays' follower
    busy max/mean under the static relays' and under 1.5; the busy
    seconds are the reference's."""
    port, ref = obs_arts
    for p, r in zip(port["scenarios"], ref["scenarios"]):
        assert p["units"][0]["extras"]["obs"]["cpu_busy_s"] == \
            r["units"][0]["extras"]["obs"]["cpu_busy_s"]
    with open(regression_gate.DEFAULT_BOUNDS) as f:
        spec = json.load(f)["obs_fairness"]
    seen = {sa["name"]: sa for sa in port["scenarios"]}
    failures, lines = regression_gate.evaluate_obs_fairness(seen, spec)
    assert failures == [] and lines[0].startswith("ok"), lines


def test_obs_rows_and_plots_equal_reference(obs_arts, tmp_path):
    port, _ = obs_arts
    rows = report.rows_for_artifact(port)
    assert rows == ref_report.rows_for_artifact(port)
    assert any("fairness" in r for r in rows)
    got = plot.render_artifact(port, str(tmp_path / "port"))
    want = ref_plot.render_artifact(port, str(tmp_path / "ref"))
    names = [p.rsplit("/", 1)[1] for p in got]
    assert names == [p.rsplit("/", 1)[1] for p in want]
    assert {"obs_util_heat.svg", "obs_critpath.svg"} <= set(names)
    for a, b in zip(got, want):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), a
