"""Where a batch scenario's time goes on the device.

    python -m repro_torch.experiments.trace --filter 'scale/batch/N=257/R=16' \\
        [--full] [--device cpu]

Runs each selected scenario once untraced (the wall-clock reference), then
once under ``torch.profiler``, and prints per scenario: wall seconds and
ms per scan step, the device's busy time (the union of its kernel
intervals) and idle share over the traced window, and the kernels that
took the most device time.  The traced run pays the profiler's own
overhead, so its wall is reported beside the untraced one.  Collecting
the events of a full grid (several hundred thousand kernels) takes the
profiler minutes after the run; quick mode keeps that short.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..device import resolve_device
from . import registry, runner


def _busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals, microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


TOP = 12    # kernels listed per scenario


def trace_scenario(sc, quick: bool, device) -> dict:
    """Untraced and traced runs of one scenario; returns the breakdown."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def once():
        t0 = time.perf_counter()
        art = runner.run_scenarios([sc], quick=quick, ignore_quick_skip=True,
                                   device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        return art["scenarios"][0]["run"], time.perf_counter() - t0

    run, wall = once()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        _, traced_wall = once()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    by_name: dict = {}
    for e in kernels:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"name": sc.name, "device": run["device"], "cells": run["cells"],
            "scan_steps": run["scan_steps"], "wall_s": wall,
            "ms_per_step": 1e3 * wall / run["scan_steps"],
            "traced_wall_s": traced_wall,
            # device metrics exist only for a device run
            "device_busy_s": busy * 1e-6 if cuda else None,
            "device_idle_share": (1.0 - busy * 1e-6 / traced_wall
                                  if cuda else None),
            "kernel_launches": len(kernels) if cuda else None,
            "top_kernels": [(n, c, t * 1e-3) for n, (c, t) in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.trace",
        description=__doc__.splitlines()[0])
    ap.add_argument("--filter", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    for sc in registry.select(args.filter):
        r = trace_scenario(sc, not args.full, args.device)
        dev = ("device metrics not measured (no device run)"
               if r["device_busy_s"] is None else
               f"device_busy={r['device_busy_s']:.6f}s "
               f"idle_share={r['device_idle_share']:.6f} "
               f"kernel_launches={r['kernel_launches']}")
        print(f"{r['name']} on {r['device']}: cells={r['cells']} "
              f"scan_steps={r['scan_steps']} wall={r['wall_s']:.6f}s "
              f"ms/step={r['ms_per_step']:.6f} "
              f"traced_wall={r['traced_wall_s']:.6f}s {dev}")
        for name, count, ms in r["top_kernels"]:
            print(f"    {ms:10.3f} ms {count:7d}x  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
