"""One run of one cell: set-up, the measured window, an optional traced
grid, the comparison with the plain reference, and the result line.

    python3 portbench/run.py --workload pig25.montecarlo --seed 7 \\
        --seconds 10 --trace 0

The window issues whole grids of the cell back to back, each with fresh
cell seeds from ``--seed``, until ``--seconds`` have passed; the last
grid that started before then runs to its end.  ``cells_per_s`` is the
cells of every grid over the wall time from the window's start to the end
of its last grid; each grid ends with its results on the host.

With ``--trace 1`` the window is measured the same way for the per-layer
metrics that read walls and host CPU time, and one more grid runs under
the profiler for those that read the device trace.
"""
from __future__ import annotations

import sys
import time

from . import compare, spec, system, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _grid_once(dep, grid, device):
    info = {}
    t0, c0 = time.perf_counter(), time.thread_time()
    units = system.simulate(dep, grid, device, info)
    _sync(device)
    t1, c1 = time.perf_counter(), time.thread_time()
    return units, {"cells": len(grid), "wall_s": t1 - t0, "cpu_s": c1 - c0,
                   "scan_steps": int(info["scan_steps"]),
                   "fanin_launches": int(info["fanin_launches"]),
                   "start": t0, "end": t1}


def shapes(dep: dict, mix: dict) -> dict:
    """The fan-in's shapes a scan step: cells C, burst rows B, slots F,
    groups G (the group kernel), or rows and F = n (EPaxos)."""
    C = len(mix["clients"]) * int(mix["seeds_per_clients"])
    n = int(dep["n"])
    if dep["protocol"] == "epaxos":
        return {"C": C, "B": 1, "F": n, "G": 1}
    return {"C": C, "B": min(8, max(mix["clients"])), "F": n - 1,
            "G": min(int(dep["relay_groups"]), n - 1)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, root=spec.ROOT, mix_override=None) -> dict:
    """Everything but the look for a chip: returns the result dict (the
    contract's keys, then ``checks``)."""
    import torch

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, name)
    dep = spec.config(bench, cell["config"], root)
    mix = mix_override or spec.traffic(cell["traffic"], root)
    limits = spec.limits(name, root)
    cuda = torch.device(device).type == "cuda"

    # set-up: the port, the device, the library and every shape of the
    # cell (one short grid)
    marks = [("start", t_process), ("imports", time.perf_counter())]
    system.port()
    marks.append(("the port's import", time.perf_counter()))
    torch.zeros(1, device=device)
    marks.append(("device start", time.perf_counter()))
    _grid_once(dep, traffic.setup_grid(mix, seed), device)
    t_window = time.perf_counter()
    marks.append(("set-up grid", t_window))
    setup_s = t_window - t_process
    log(f"{name}: set-up {setup_s:.6f} s: " + ", ".join(
        f"{k} {b - a:.3f} s" for (_, a), (k, b) in zip(marks, marks[1:])))

    window, all_units = [], []
    while True:
        units, rec = _grid_once(dep, traffic.grid(mix, seed, len(window)),
                                device)
        window.append(rec)
        all_units.extend(units)
        log(f"grid {len(window) - 1}: {rec['cells']} cells, "
            f"{rec['scan_steps']} scan steps, {rec['wall_s']:.6f} s wall, "
            f"{rec['cpu_s']:.6f} s host CPU")
        if rec["end"] - t_window >= seconds:
            break
    t_end = window[-1]["end"]
    cells = sum(r["cells"] for r in window)
    result_metrics = {}
    traced = None
    if trace:
        from . import profiling
        module, stages = system.step_functions()
        g = traffic.grid(mix, seed, len(window))
        _sync(device)
        (units, rec), traced = profiling.profile_grid(
            lambda: _grid_once(dep, g, device), module, stages, device, log)
        all_units.extend(units)
        traced.update(rec)
        cells += rec["cells"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    ctx = {"name": name, "config": dep, "mix": mix, "window": window,
           "trace": traced, "shapes": shapes(dep, mix)}
    if trace:
        for m in spec.metrics_for(bench, name, "per_layer"):
            v = spec.metric_reader(m["name"], root)(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"cells_per_s": cells / (t_end - t_window),
               "setup_s": setup_s}
        # a metric split by kind of cell (``cells_per_s.group``) takes
        # the quantity its name begins with
        for m in spec.metrics_for(bench, name, "end_to_end"):
            result_metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                         "unit": m["unit"]}

    # the comparison, once the window is closed and its peak read
    n_exh = sum(bool(u["exhausted"]) for u in all_units)
    idx = compare.sample(len(all_units), seed)
    picked = [all_units[i] for i in idx]
    grid_clients = tuple(int(k) for k in mix["clients"])
    t_ref = time.perf_counter()
    ref_units = spec.reference(dep).simulate(
        dep, [(u["clients"], u["seed"]) for u in picked], grid_clients,
        float(mix["warmup_s"]), float(mix["duration_s"]), device)
    log(f"reference: {len(picked)} cells in "
        f"{time.perf_counter() - t_ref:.3f} s")
    ok, bad, checks = compare.judge(picked, ref_units, n_exh, limits)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": ok, "attempted": cells, "failed": n_exh + bad,
           "metrics": result_metrics, "device": dev}
    if traced is not None:
        from . import profiling, yardstick
        busy = yardstick.interval_union_s(
            [(s, e) for _, s, e in traced["events"]])
        dev["busy_s"] = busy
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = profiling.breakdown(traced)
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    return out
