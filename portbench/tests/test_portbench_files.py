"""``BENCHMARK.json`` and the files its names lead to: every piece loads
by name, a new cell made only of new files is found, and a run's result
has the contract's keys."""
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec, traffic
from portbench.tests import tiny

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONTRACT = ("correct", "attempted", "failed", "metrics", "device")


def test_benchmark_has_the_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells of 14 runs each, with their allowances, fit in 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    reports = {e["name"]: set(e.get("workloads", cells))
               for e in BENCH["end_to_end"]}
    for w in cells:
        e2e = [e for e, cs in reports.items() if w in cs]
        assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["per_layer"]:
        # every cell that reports a per-layer metric reports what it moves
        assert set(m["workloads"]) <= reports[m["moves"]]
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(w["name"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_files_by_name(cell):
    w = spec.cell(BENCH, cell)
    dep = spec.config(BENCH, w["config"])
    assert dep["name"] == w["config"]
    assert spec.reference(dep).simulate
    mix = spec.traffic(w["traffic"])
    g = traffic.grid(mix, tiny.SEED, 0)
    assert len(g) == len(mix["clients"]) * mix["seeds_per_clients"]
    assert len(g) >= 4095
    assert max(g.seeds) * 1_000_003 < 2 ** 63
    limits = spec.limits(cell)
    assert set(limits) == {"worst_rel_gap", "exhausted_cells"}
    assert spec.metrics_for(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", sorted(
    p.stem for p in (spec.HERE / "metrics").glob("*.py")))
def test_every_metric_reader_loads_and_reads_nothing_without_a_trace(metric):
    read = spec.metric_reader(metric)
    ctx = {"window": [], "trace": None, "shapes": {}}
    if metric.startswith(("scan_step_ms.", "host_cpu_ms_per_step.")):
        assert read(ctx) is None
        ctx["window"] = [{"wall_s": 3.0, "cpu_s": 2.0, "scan_steps": 300}]
        assert read(ctx) == pytest.approx(10.0 if "scan" in metric else
                                          2e3 / 300)
    else:
        assert read(ctx) is None


def test_grids_of_one_run_differ_and_repeat_from_the_seed():
    mix = spec.traffic("montecarlo-c20-60-120")
    a, b = traffic.grid(mix, 7, 0), traffic.grid(mix, 7, 1)
    assert set(a.seeds).isdisjoint(b.seeds)
    assert traffic.grid(mix, 7, 0) == a
    assert traffic.grid(mix, 8, 0) != a
    assert a.clients == b.clients and len(a) == 3 * 8192


def _new_cell_tree(tmp_path):
    """A copy of BENCHMARK.json and portbench's data with one more cell:
    a new traffic mix, a new per-layer metric, new limits, nothing
    edited."""
    root = tiny.copy_tree(tmp_path / "checkout")
    pb = root / "portbench"
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "pig25.tiny", "config": "pigpaxos-n25-r3",
        "traffic": "tiny-c20-60", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({
        "name": "grids_per_window", "unit": "grids", "better": "higher",
        "source": "host_clock", "layer": "group step loop",
        "moves": "cells_per_s.tiny", "workloads": ["pig25.tiny"]})
    bench["end_to_end"].append({
        "name": "cells_per_s.tiny", "unit": "cells/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["pig25.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(tiny.MIXES["pig25.montecarlo"], clients=[20, 60])
    (pb / "traffic" / "tiny-c20-60.json").write_text(json.dumps(mix))
    (pb / "metrics" / "grids_per_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['window']))\n")
    shutil.copy(pb / "limits" / "pig25.montecarlo.json",
                pb / "limits" / "pig25.tiny.json")
    return root


def test_a_new_cell_made_only_of_new_files_is_found(tmp_path):
    import time
    from portbench import harness
    root = _new_cell_tree(tmp_path)
    bench = spec.load_benchmark(root)
    assert spec.cell(bench, "pig25.tiny")["traffic"] == "tiny-c20-60"
    names = [m["name"] for m in spec.metrics_for(bench, "pig25.tiny",
                                                  "per_layer")]
    assert names == ["grids_per_window"]
    read = spec.metric_reader("grids_per_window", root)
    assert read({"window": [1, 2, 3]}) == 3.0
    out = harness.run_cell("pig25.tiny", tiny.SEED, 0.0, False, "cpu",
                           time.perf_counter(), root=root)
    assert out["correct"] and out["attempted"] == 4
    assert set(out["metrics"]) == {"cells_per_s", "cells_per_s.tiny",
                                   "setup_s"}


def test_a_run_returns_the_contract_keys_then_its_checks():
    out = tiny.run("pig25.montecarlo")
    assert tuple(out)[:5] == CONTRACT and tuple(out)[-1] == "checks"
    assert set(out) == set(CONTRACT) | {"checks"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 6
    assert set(out["metrics"]) == {"cells_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
        assert m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"]["worst_rel_gap"]["value"] == 0.0
    json.dumps(out)


def test_without_a_card_the_command_prints_no_result():
    root = Path(spec.ROOT)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "pig25.montecarlo", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_in_a_directory_of_the_benchmark_alone_the_command_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "pig25.montecarlo", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
