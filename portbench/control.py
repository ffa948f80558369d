"""The readings the limits of ``correct`` are set from, at a cell's own
size, in one process on the card:

    python3 portbench/control.py --workload pig25.montecarlo \\
        --seeds 1,2,3,... --control-seeds 101,102,103 [--grids 1]

* the program: for each of ``--seeds``, ``--grids`` whole grids through
  the entry, the run's sample of their cells simulated again by the
  reference, and the numbers ``correct`` compares;
* the control: for each of ``--control-seeds``, the reference computed in
  bfloat16 (the precision below the deployments' float32) put in the
  program's place on the same sample, and held to the float32 reference
  the same way;
* the reference's own one-ulp envelope: the float32 reference with the
  link jitter one float32 ulp up and down, against itself.

Prints one JSON line a reading.  Set a limit above every program reading
and below every control reading (``limits/<cell>.json``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from portbench import compare, harness, spec, system, traffic  # noqa: E402

CONTROL_DTYPE = "bfloat16"


def _cells(mix, seed, grids):
    cells = []
    for g in range(grids):
        cells += traffic.grid(mix, seed, g).cells
    idx = compare.sample(len(cells), seed)
    return [cells[i] for i in idx]


def _ref(dep, mix, cells, device, dtype=None, max_steps=None):
    import torch
    kw = {}
    if dtype is not None:
        kw["dtype"] = getattr(torch, dtype)
    if max_steps is not None:
        kw["max_steps"] = max_steps
    return spec.reference(dep).simulate(
        dep, cells, tuple(int(k) for k in mix["clients"]),
        float(mix["warmup_s"]), float(mix["duration_s"]), device, **kw)


def _cell(name, mix, root):
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, name)
    return (spec.config(bench, cell["config"], root),
            mix or spec.traffic(cell["traffic"], root))


def program_reading(name, seed, device, grids=1, mix=None, root=spec.ROOT):
    """The numbers ``correct`` compares for ``grids`` grids of the program
    through the entry, as a run compares them."""
    dep, mix = _cell(name, mix, root)
    units = []
    for g in range(grids):
        units += system.simulate(dep, traffic.grid(mix, seed, g), device, {})
    n_exh = sum(bool(u["exhausted"]) for u in units)
    picked = [units[i] for i in compare.sample(len(units), seed)]
    ref = _ref(dep, mix, [(u["clients"], u["seed"]) for u in picked], device)
    return compare.judge(picked, ref, n_exh, spec.limits(name, root))


def control_reading(name, seed, device, grids=1, mix=None,
                    dtype=CONTROL_DTYPE, root=spec.ROOT):
    """The same numbers with the reference in ``dtype`` in the program's
    place.  Its step budget stops at twice the first pass: a time that
    no longer advances in the lower precision leaves cells exhausted,
    and an exhausted cell is an answer that differs."""
    from portbench.reference.lowering import budget, lower
    dep, mix = _cell(name, mix, root)
    cells = _cells(mix, seed, grids)
    steps = budget(lower(dep), mix["clients"], mix["warmup_s"],
                   mix["duration_s"])[0]
    low = _ref(dep, mix, cells, device, dtype, max_steps=2 * steps)
    ref = _ref(dep, mix, cells, device)
    n_exh = sum(bool(u["exhausted"]) for u in low)
    return compare.judge(low, ref, n_exh, spec.limits(name, root))


def envelope_reading(name, seed, device, grids=1, root=spec.ROOT):
    """The float32 reference against itself with the jitter one ulp up
    and down: the largest gap."""
    dep, mix = _cell(name, None, root)
    cells = _cells(mix, seed, grids)
    ref = _ref(dep, mix, cells, device)
    worst = 0.0
    j = np.float32(dep["network"]["jitter_s"])
    for to in (np.float32(np.inf), np.float32(0)):
        d2 = copy.deepcopy(dep)
        d2["network"]["jitter_s"] = float(np.nextafter(j, to))
        moved = _ref(d2, mix, cells, device)
        worst = max(worst, max(compare.cell_gap(a, b)
                               for a, b in zip(moved, ref)))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--envelope-seeds", default="")
    ap.add_argument("--grids", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for kind, fn, ss in (("program", program_reading, seeds(args.seeds)),
                         ("control", control_reading,
                          seeds(args.control_seeds))):
        for s in ss:
            t0 = time.perf_counter()
            ok, bad, checks = fn(args.workload, s, dev, args.grids)
            print(json.dumps({"workload": args.workload, "reading": kind,
                              "seed": s, "correct": ok, "failed": bad,
                              "checks": checks,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    for s in seeds(args.envelope_seeds):
        print(json.dumps({"workload": args.workload, "reading": "envelope",
                          "seed": s, "worst_rel_gap": envelope_reading(
                              args.workload, s, dev, args.grids)}),
              flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
