"""Scenario runner for the port (batch backend only).

Every run emits the reference's artifact schema
(``repro.experiments.runner``, ``ARTIFACT_SCHEMA``), so the unchanged
``benchmarks/regression_gate.py`` gates the port's artifacts:

.. code-block:: python

    {"schema": "repro-experiments/v1", "quick": bool, "processes": 0,
     "wall_s": float,
     "scenarios": [
        {"name": ..., "family": ..., "grid_mode": ..., "quick": bool,
         "backend": "batch", "spec": {...}, "consistency": "model",
         "units": [...], "replicates": [...], "summary": {...},
         "run": {"device": name, "cells": C, "scan_steps": S,
                 "wall_s": w}},
        ...]}

``run`` is the port's addition: the device the grid ran on, and the scan
steps it took (one fan-in kernel launch each).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

from ..core import vectorsim
from .scenario import Scenario, build_topology

ARTIFACT_SCHEMA = "repro-experiments/v1"


def _f(x) -> Optional[float]:
    """JSON-safe float: NaN/inf -> None, else rounded."""
    x = float(x)
    if math.isnan(x) or math.isinf(x):
        return None
    return round(x, 6)


def _run_batch_scenario(sc: Scenario, rs, device=None,
                        info: Optional[dict] = None) -> List[dict]:
    """One scenario's whole clients x seeds grid on the batch backend.
    Returns unit dicts in (clients, seed) order with the reference's
    schema (wall_s is the amortized grid wall)."""
    t0 = time.time()
    raw = vectorsim.simulate_scenario(
        sc.protocol, sc.n, pig=sc.pig, topo=build_topology(sc.topo),
        workload=sc.workload, clients=rs.clients, seeds=rs.seeds,
        duration=rs.duration, warmup=rs.warmup,
        leader_timeout=sc.leader_timeout,
        batch_m=(sc.batch or {}).get("max_batch", 1),
        obs=sc.obs is not None, device=device, info=info)
    wall = time.time() - t0
    units = []
    for u in raw:
        unit = {
            "scenario": sc.name, "clients": u["clients"], "seed": u["seed"],
            "duration_s": rs.duration, "warmup_s": rs.warmup,
            "throughput": _f(u["throughput"]), "mean_ms": _f(u["mean_ms"]),
            "median_ms": _f(u["median_ms"]), "p25_ms": _f(u["p25_ms"]),
            "p75_ms": _f(u["p75_ms"]), "p99_ms": _f(u["p99_ms"]),
            "count": u["count"], "committed": u["committed"],
            "wall_s": round(wall / max(len(raw), 1), 4),
            "backend": "batch",
            "retry_risk": u["retry_risk"],
            "exhausted": u["exhausted"],
        }
        if "per_node_msgs" in sc.collect:
            unit["extras"] = {
                "leader_msgs_per_op": _f(u["leader_msgs_per_op"]),
                "follower_msgs_per_op": _f(u["follower_msgs_per_op"])}
        units.append(unit)
    return units


def _agg(values: Sequence[float]) -> dict:
    vals = [v for v in values if v is not None]
    if not vals:
        return {"mean": None, "std": None, "min": None, "max": None, "n": 0}
    mean = sum(vals) / len(vals)
    var = sum((v - mean) ** 2 for v in vals) / len(vals)
    return {"mean": _f(mean), "std": _f(math.sqrt(var)),
            "min": _f(min(vals)), "max": _f(max(vals)), "n": len(vals)}


def _scenario_artifact(sc: Scenario, units: List[dict], quick: bool) -> dict:
    art = {"name": sc.name, "family": sc.family, "grid_mode": sc.grid_mode,
           "quick": quick, "backend": sc.backend, "spec": sc.spec_dict(),
           # batch backend: commits by construction
           "consistency": "model",
           "units": units}
    # per-seed replicates: apply the grid policy within each seed
    by_seed: Dict[int, List[dict]] = {}
    for u in units:
        by_seed.setdefault(u["seed"], []).append(u)
    if sc.grid_mode == "max":
        reps = [max(us, key=lambda u: u["throughput"] or 0.0)
                for us in by_seed.values()]
    else:
        reps = units
    art["replicates"] = reps
    if sc.grid_mode == "curve":
        by_clients: Dict[int, List[dict]] = {}
        for u in units:
            by_clients.setdefault(u["clients"], []).append(u)
        art["points"] = [
            {"clients": k,
             "throughput": _agg([u["throughput"] for u in us]),
             "median_ms": _agg([u["median_ms"] for u in us]),
             "p99_ms": _agg([u["p99_ms"] for u in us])}
            for k, us in sorted(by_clients.items())]
    art["summary"] = {
        "throughput": _agg([u["throughput"] for u in reps]),
        "median_ms": _agg([u["median_ms"] for u in reps]),
        "p99_ms": _agg([u["p99_ms"] for u in reps]),
        "committed": sum(u["committed"] for u in units),
        "wall_s": round(sum(u["wall_s"] for u in units), 3),
    }
    return art


def run_scenarios(scenarios: Sequence[Scenario], quick: bool = True,
                  ignore_quick_skip: bool = False, device=None) -> dict:
    """Run a suite of scenarios on ``device`` (CUDA unless the caller
    passes "cpu"); return the suite artifact.  Each scenario's whole
    clients x seeds grid runs as one batch.

    ``ignore_quick_skip``: run ``quick_skip`` scenarios anyway — set when
    the caller selected scenarios explicitly (``--filter``)."""
    active = [sc for sc in scenarios
              if ignore_quick_skip or not (quick and sc.quick_skip)]
    t0 = time.time()
    arts = []
    for sc in active:
        info: dict = {}
        units = _run_batch_scenario(sc, sc.resolve(quick), device=device,
                                    info=info)
        art = _scenario_artifact(sc, units, quick)
        art["run"] = info
        arts.append(art)
    return {"schema": ARTIFACT_SCHEMA, "quick": quick, "processes": 0,
            "wall_s": round(time.time() - t0, 3), "scenarios": arts}
