"""Scenario runner for the port: the discrete-event engines and the batch
backend.

A ``backend="des"`` scenario's grid is ``len(clients) x len(seeds)``
independent discrete-event runs (single-threaded Python and numpy on the
host), farmed out to a ``multiprocessing`` pool (``processes > 1``,
longest first, the results put back in order so the artifact equals a
serial run's) or run inline.  A ``backend="batch"`` scenario's whole grid
runs as one batch on ``device`` (CUDA unless the caller passes "cpu").

Every run emits the reference's artifact schema
(``repro.experiments.runner``, ``ARTIFACT_SCHEMA``), so the unchanged
``benchmarks/regression_gate.py`` gates the port's artifacts:

.. code-block:: python

    {"schema": "repro-experiments/v1", "quick": bool, "processes": int,
     "wall_s": float,
     "scenarios": [
        {"name": ..., "family": ..., "grid_mode": ..., "quick": bool,
         "backend": "des" | "batch", "spec": {...},
         "consistency": "audited" | "model" | "unchecked",
         "units": [...], "replicates": [...], "summary": {...},
         "points": [...],                  # curve mode
         "faults": [...],                  # fault-plan scenarios only
         "run": {...}},
        ...]}

A unit's fields and ``extras`` are the reference's, unit for unit:
per-node message loads, the flight matrix, the completion ``timeline``,
the overload metrics, the admission counters, the read/write split, the
availability metrics of a fault plan, the failover policy's promotions,
the ``obs`` section of a traced unit and, for an audited unit, the
linearizability verdict.

``backend_override="batch"`` switches every ``batch_ok`` scenario to the
batch backend and ``"des"`` forces every batch scenario onto the DES, as
the reference's does.

``run`` is the port's addition.  For a batch scenario: the device the grid
ran on, the scan steps it took and the fan-in kernel launches they made
(one a scan step for the group kernel, two for EPaxos; none on the CPU).
For a DES scenario: ``device="host"``, its units (``cells``), the events
the schedulers executed and the units' summed wall.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import vectorsim
from ..core.cluster import Cluster
from ..core.paxos import BatchConfig
from ..faults import apply_plan, audit_cluster
from ..faults.plan import jsonify_events
from ..obs import obs_artifact_section
from ..runtime.policy import (AdmissionPolicy, FailoverPolicy,
                              LatencyAdmissionPolicy, attach_admission,
                              attach_failover, attach_latency_admission)
from .scenario import Scenario, build_topology

ARTIFACT_SCHEMA = "repro-experiments/v1"
TIMELINE_BUCKET_S = 0.05
# goodput SLO for the overload family: a completion counts toward goodput
# only if its client-observed latency (first send -> reply, including any
# shed/bounce/retry loops) is within this budget
OVERLOAD_SLO_MS = 50.0


def _f(x) -> Optional[float]:
    """JSON-safe float: NaN/inf -> None, else rounded."""
    x = float(x)
    if math.isnan(x) or math.isinf(x):
        return None
    return round(x, 6)


def _run_unit(payload) -> Tuple[dict, int, float]:
    """One independent DES run.  Top-level so it pickles for pool workers.
    Returns the reference's unit dict, the events the scheduler executed
    and the unit's wall in seconds."""
    sc, clients, seed, duration, warmup = payload
    t0 = time.time()
    bc = BatchConfig(**sc.batch) if sc.batch is not None else None
    c = Cluster(sc.protocol, sc.n, pig=sc.pig, seed=seed,
                topo=build_topology(sc.topo),
                leader_timeout=sc.leader_timeout, engine=sc.engine,
                record_history=sc.audit, spare_nodes=sc.spare_nodes,
                batch=bc, pipeline_depth=sc.pipeline_depth,
                obs=(dict(sc.obs) if sc.obs is not None else None),
                lease=(dict(sc.lease) if sc.lease is not None else None))
    plan = sc.fault_plan()
    evs = []
    if plan is not None:
        evs = apply_plan(c, plan, horizon=warmup + duration + 0.5)
    fo_events = None
    if sc.failover is not None:
        fo_events = attach_failover(c, FailoverPolicy(**sc.failover),
                                    stop_at=warmup + duration)
    adm_stats = None
    if sc.admission is not None:
        if "slo_ms" in sc.admission:
            adm_stats = attach_latency_admission(
                c, LatencyAdmissionPolicy(**sc.admission),
                stop_at=warmup + duration)
        else:
            adm_stats = attach_admission(c, AdmissionPolicy(**sc.admission),
                                         stop_at=warmup + duration)
        # the metrics sampler's shed_total gauge reads these counters
        c.admission_stats = adm_stats
    st = c.measure(duration=duration, warmup=warmup, clients=clients,
                   workload=sc.workload)
    unit = {
        "scenario": sc.name, "clients": clients, "seed": seed,
        "duration_s": duration, "warmup_s": warmup,
        "throughput": _f(st.throughput), "mean_ms": _f(st.mean_ms),
        "median_ms": _f(st.median_ms), "p25_ms": _f(st.p25_ms),
        "p75_ms": _f(st.p75_ms), "p99_ms": _f(st.p99_ms),
        "count": st.count, "committed": st.committed,
        "wall_s": round(time.time() - t0, 3),
    }
    extras = {}
    if "per_node_msgs" in sc.collect:
        extras["leader_msgs_per_op"] = _f(st.messages_per_op(0))
        extras["follower_msgs_per_op"] = _f(
            sum(st.messages_per_op(i) for i in range(1, sc.n)) / (sc.n - 1))
    if "flight" in sc.collect:
        m = st.flight.astype(float) / max(st.committed, 1)
        extras["flight_per_op"] = [[_f(v) for v in r] for r in m.tolist()]
    if "timeline" in sc.collect:
        # completion counts per fixed virtual-time bucket (from t=0), for
        # throughput-over-time views (e.g. fig16's failure transient)
        end = warmup + duration
        counts = [0] * (int(end / TIMELINE_BUCKET_S) + 1)
        for cl in c.clients:
            for (t, _lat) in cl.latencies:
                b = int(t / TIMELINE_BUCKET_S)
                if b < len(counts):
                    counts[b] += 1
        extras["timeline"] = {"bucket_s": TIMELINE_BUCKET_S, "counts": counts}
    if "overload" in sc.collect:
        # overload-study metrics: tail beyond p99, goodput under an SLO,
        # offered rate, and every shed/bounce counter in the loop
        stop = warmup + duration
        lats = sorted(l for cl in c.clients
                      for (t, l) in cl.latencies if warmup <= t <= stop)
        extras["p999_ms"] = (_f(lats[min(len(lats) - 1,
                                         int(0.999 * len(lats)))] * 1e3)
                             if lats else None)
        extras["slo_ms"] = OVERLOAD_SLO_MS
        extras["goodput"] = _f(sum(1 for l in lats
                                   if l * 1e3 <= OVERLOAD_SLO_MS) / duration)
        wl = sc.workload
        extras["offered"] = (_f(wl.rate_hz * clients)
                             if wl is not None and wl.arrival != "closed"
                             else None)
        extras["client_shed"] = sum(getattr(cl, "shed", 0)
                                    for cl in c.clients)
        extras["client_rejected"] = sum(getattr(cl, "rejected", 0)
                                        for cl in c.clients)
    if adm_stats is not None:
        extras["admission"] = dict(adm_stats)
    rw = (c.read_write_split()
          if sc.workload is not None and sc.workload.read_ratio is not None
          else None)
    if rw is not None:
        extras["rw"] = {k: (_f(v) if isinstance(v, float) else v)
                        for k, v in rw.items()}
    if plan is not None:
        # availability metrics: the longest client-visible completion gap
        # inside the measurement window, and the timeout re-send count
        stop = warmup + duration
        times = sorted(t for cl in c.clients for (t, _l) in cl.latencies
                       if warmup <= t <= stop)
        edges = [warmup] + times + [stop]
        extras["unavail_ms"] = _f(max(
            (b - a) for a, b in zip(edges, edges[1:])) * 1e3)
        extras["client_retries"] = sum(cl.retries for cl in c.clients)
        # per-outage unavailability: for every crash/recover pair in the
        # materialized plan, the longest completion gap inside the outage
        # window (+0.25s tail for the recovery transient) — the per-restart
        # metric rolling-upgrade scenarios report
        open_crash = {}
        per_fault = []
        for ev in evs:
            if ev[0] == "crash":
                open_crash[ev[1]] = float(ev[2])
            elif ev[0] == "recover" and ev[1] in open_crash:
                ft0 = open_crash.pop(ev[1])
                ft1 = float(ev[2])
                lo, hi = max(ft0, warmup), min(ft1 + 0.25, stop)
                if lo >= hi:
                    continue
                w = [lo] + [t for t in times if lo <= t <= hi] + [hi]
                per_fault.append({
                    "node": ev[1], "t0": _f(ft0), "t1": _f(ft1),
                    "unavail_ms": _f(max(b - a for a, b in
                                         zip(w, w[1:])) * 1e3)})
        if per_fault:
            extras["per_fault_unavail_ms"] = per_fault
    if fo_events is not None:
        extras["failover_events"] = [
            {"t": _f(e["t"]), "from": e["from"], "to": e["to"]}
            for e in fo_events]
    if sc.obs is not None:
        extras["obs"] = obs_artifact_section(c)
    if sc.audit:
        res = audit_cluster(c)
        unit["consistency"] = "ok" if res.ok else "violation"
        unit["audit"] = res.summary()
    if extras:
        unit["extras"] = extras
    return unit, c.sched.events, time.time() - t0


def _run_batch_scenario(sc: Scenario, rs, device=None,
                        info: Optional[dict] = None) -> List[dict]:
    """One scenario's whole clients x seeds grid on the batch backend.
    Returns unit dicts in (clients, seed) order with the reference's
    schema (wall_s is the amortized grid wall).  A fault plan runs as
    availability masks over the resolved window plus the drain."""
    t0 = time.time()
    plan = sc.fault_plan()
    masks = (plan.to_masks(sc.n, rs.warmup + rs.duration + 0.5)
             if plan is not None else None)
    raw = vectorsim.simulate_scenario(
        sc.protocol, sc.n, pig=sc.pig, topo=build_topology(sc.topo),
        workload=sc.workload, clients=rs.clients, seeds=rs.seeds,
        duration=rs.duration, warmup=rs.warmup,
        leader_timeout=sc.leader_timeout, masks=masks,
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
        extras = {}
        if "per_node_msgs" in sc.collect:
            extras["leader_msgs_per_op"] = _f(u["leader_msgs_per_op"])
            extras["follower_msgs_per_op"] = _f(u["follower_msgs_per_op"])
        if "timeline" in u:
            extras["timeline"] = u["timeline"]
        if "obs" in u:
            extras["obs"] = u["obs"]
        if "rw" in u:
            extras["rw"] = {k: (_f(v) if isinstance(v, float) else v)
                            for k, v in u["rw"].items()}
        if plan is not None:
            unit["consistency"] = "model"
        if extras:
            unit["extras"] = extras
        units.append(unit)
    return units


def _unit_cost_estimate(payload) -> float:
    sc, clients, _seed, duration, warmup = payload
    # epaxos dependency graphs make its events much heavier than (pig)paxos
    proto_w = 4.0 if sc.protocol == "epaxos" else 1.0
    return (warmup + duration) * sc.n * clients * proto_w


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
           # consistency provenance: "audited" = every DES unit ran the
           # linearizability auditor (per-unit verdicts in units[].
           # consistency); "model" = batch backend (commits by
           # construction); "unchecked" = plain perf run
           "consistency": ("audited" if sc.audit and sc.backend == "des"
                           else "model" if sc.backend == "batch"
                           else "unchecked"),
           "units": units}
    plan = sc.fault_plan()
    if plan is not None:
        # the materialized fault timeline over the RESOLVED horizon: the
        # events this run applied
        rs = sc.resolve(quick)
        art["faults"] = jsonify_events(
            plan.materialize(rs.warmup + rs.duration + 0.5))
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


def _override(active: List[Scenario],
              backend_override: Optional[str]) -> List[Scenario]:
    """The reference's backend override: ``"batch"`` switches every
    ``batch_ok`` scenario to the batch backend, keeping ``per_node_msgs``
    always and ``timeline`` when a fault plan rides along; ``"des"``
    forces every batch scenario onto the DES."""
    if backend_override == "batch":
        return [dataclasses.replace(sc, backend="batch", collect=tuple(
            c for c in sc.collect
            if c == "per_node_msgs"
            or (c == "timeline" and sc.fault_plan() is not None)))
            if sc.batch_ok else sc for sc in active]
    if backend_override == "des":
        return [dataclasses.replace(sc, backend="des")
                if sc.backend == "batch" else sc for sc in active]
    if backend_override is not None:
        raise ValueError(f"unknown backend override {backend_override!r}")
    return active


def run_scenarios(scenarios: Sequence[Scenario], quick: bool = True,
                  processes: int = 0,
                  ignore_quick_skip: bool = False,
                  backend_override: Optional[str] = None,
                  device=None) -> dict:
    """Run a suite of scenarios; return the suite artifact.

    ``processes``: 0/1 -> the DES units run inline; N > 1 -> a pool of N
    workers over all DES units of all scenarios at once, the costliest
    first, so a wide scenario cannot serialize the tail of the suite.
    Batch scenarios never enter the pool: each one's whole clients x
    seeds grid runs as one batch on ``device`` (CUDA unless the caller
    passes "cpu"); a suite of DES scenarios alone touches no device.

    ``ignore_quick_skip``: run ``quick_skip`` scenarios anyway — set when
    the caller selected scenarios explicitly (``--filter``).

    ``backend_override="batch"`` switches every ``batch_ok`` scenario to
    the batch backend (the reference's DES <-> batch cross-checks on
    identical grids), ``"des"`` forces everything onto the DES; the
    artifact records the switched spec."""
    active = [sc for sc in scenarios
              if ignore_quick_skip or not (quick and sc.quick_skip)]
    active = _override(active, backend_override)
    t0 = time.time()     # suite wall includes the batch-backend runs
    payloads = []
    batch: Dict[str, Tuple[List[dict], dict]] = {}
    for sc in active:
        rs = sc.resolve(quick)
        if sc.backend == "batch":
            info: dict = {}
            batch[sc.name] = (_run_batch_scenario(sc, rs, device=device,
                                                  info=info), info)
            continue
        for (k, s) in rs.units():
            payloads.append((sc, k, s, rs.duration, rs.warmup))
    if processes and processes > 1 and len(payloads) > 1:
        # longest-processing-time-first: schedule the expensive units early
        # so the pool tail is short (simulated work ~ duration x n x load);
        # results are un-sorted afterwards so the artifact is identical to
        # a serial run
        order = sorted(range(len(payloads)), reverse=True,
                       key=lambda i: _unit_cost_estimate(payloads[i]))
        with multiprocessing.get_context().Pool(processes) as pool:
            res = pool.map(_run_unit, [payloads[i] for i in order],
                           chunksize=1)
        results = [None] * len(payloads)
        for i, r in zip(order, res):
            results[i] = r
    else:
        results = [_run_unit(p) for p in payloads]
    des: Dict[str, List[tuple]] = {}
    for r in results:
        des.setdefault(r[0]["scenario"], []).append(r)
    arts = []
    for sc in active:
        if sc.backend == "batch":
            units, info = batch[sc.name]
        else:
            got = des.get(sc.name, [])
            units = [u for u, _, _ in got]
            info = {"device": "host", "cells": len(got),
                    "events": sum(e for _, e, _ in got),
                    "wall_s": sum(w for _, _, w in got)}
        art = _scenario_artifact(sc, units, quick)
        art["run"] = info
        arts.append(art)
    return {"schema": ARTIFACT_SCHEMA, "quick": quick,
            "processes": int(processes or 0),
            "wall_s": round(time.time() - t0, 3), "scenarios": arts}


def run_families(families: Sequence[str], quick: bool = True,
                 processes: int = 0, filter_expr: Optional[str] = None,
                 backend_override: Optional[str] = None,
                 device=None) -> dict:
    """``run_scenarios`` over the registry's scenarios of ``families``
    (narrowed by ``filter_expr``, which also runs ``quick_skip`` ones)."""
    from . import registry
    return run_scenarios(registry.select(filter_expr,
                                         families_subset=families),
                         quick=quick, processes=processes,
                         ignore_quick_skip=bool(filter_expr),
                         backend_override=backend_override, device=device)
