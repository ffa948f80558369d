"""What a cell is made of, found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic mix and the per-layer metrics; each is a
file of its own under ``portbench/``:

* ``configs/<config>.json``   the deployment (the entry's ``file``);
* ``traffic/<traffic>.json``  the traffic mix;
* ``metrics/<metric>.py``     a reader with ``read(ctx) -> float | None``;
* ``limits/<cell>.json``      the limits of the numbers ``correct``
  compares, with the readings they were set from;
* ``reference/<module>.py``   the plain reference the deployment names.

A new cell, deployment, mix or metric is new files and new entries: no
file here changes for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have: {', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            dep = json.loads((Path(root) / c["file"]).read_text())
            if dep["name"] != name:
                raise ValueError(f"{c['file']} names {dep['name']!r}, "
                                 f"BENCHMARK.json {name!r}")
            return dep
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _bench_dir(root: Path) -> Path:
    return Path(root) / HERE.name


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((_bench_dir(root) / "traffic" / f"{name}.json")
                      .read_text())


def limits(cell_name: str, root: Path = ROOT) -> dict:
    return json.loads((_bench_dir(root) / "limits" / f"{cell_name}.json")
                      .read_text())["limits"]


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = _bench_dir(root) / "metrics" / f"{name}.py"
    return _load_file(path, f"portbench_metric_{name.replace('.', '_')}").read


def metrics_for(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    without a ``workloads`` key and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def reference(dep: dict):
    """The plain reference module the deployment names."""
    return importlib.import_module(f"{__package__}.reference."
                                   f"{dep['reference']}")
