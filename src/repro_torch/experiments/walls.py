"""Walls of the batch grids, for holding two checkouts of the port against
each other on one card.

    python -m repro_torch.experiments.walls --tag change [--trace]
    # the same file against another checkout, from that checkout's root
    # (-P keeps this file's directory, which holds a trace.py, off the path):
    PYTHONPATH=src python -P /path/to/walls.py --tag parent [--trace]

Runs a quick R=3 grid to warm up, then each selected scenario (the three
``scale/batch`` grids unless ``--filter`` names other registered ones) once
in full mode, and prints one JSON line a run: the wall, the main thread's CPU
seconds (the step loop is host-bound, and a shared host's other work shows
in the wall, not in this thread's time), both a scan step, and cells/s.
``--trace`` adds a quick run of the scenario the filter names first under
``torch.profiler`` (``trace.trace_scenario``): the device kernels a scan
step, set-up included.  Run it as ``parent, change, change, parent`` in one call to
compare two trees.  Imports are absolute, so that the file runs against
any checkout's package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.experiments import registry, runner, trace

GRIDS = "scale/batch/N=1025/R=32,scale/batch/N=257/R=16," \
    "scale/batch/replicates/R=3"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.walls",
        description=__doc__.splitlines()[0])
    ap.add_argument("--tag", required=True,
                    help="names the tree in the output")
    ap.add_argument("--filter", default=GRIDS)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    (warm,) = registry.select("scale/batch/replicates/R=3")
    runner.run_scenarios([warm], quick=True, device=dev)
    sync()
    scenarios = registry.select(args.filter)
    for sc in scenarios:
        t0, c0 = time.perf_counter(), time.thread_time()
        art = runner.run_scenarios([sc], quick=False, device=dev)
        sync()
        wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
        run = art["scenarios"][0]["run"]
        steps = run["scan_steps"]
        print(json.dumps({
            "tree": args.tag, "name": sc.name, "device": run["device"],
            "cells": run["cells"], "scan_steps": steps, "wall_s": wall,
            "host_cpu_s": cpu, "ms_per_step": 1e3 * wall / steps,
            "host_cpu_ms_per_step": 1e3 * cpu / steps,
            "cells_per_s": run["cells"] / wall,
            "tput_mean": art["scenarios"][0]["summary"]["throughput"]["mean"]
        }), flush=True)
    if args.trace:
        (first,) = registry.select(args.filter.split(",")[0])[:1]
        r = trace.trace_scenario(first, True, dev)
        print(json.dumps({
            "tree": args.tag, "name": first.name, "mode": "quick trace",
            "scan_steps": r["scan_steps"], "kernels": r["kernel_launches"],
            "kernels_per_step": (None if r["kernel_launches"] is None else
                                 r["kernel_launches"] / r["scan_steps"]),
            "device_idle_share": r["device_idle_share"],
            "ms_per_step": r["ms_per_step"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
