"""Command line for the port's scenarios.

    python -m repro_torch.experiments.run --filter 'scale/batch/*' \\
        [--full] [--device cpu] --json PATH

Runs the selected scenarios on the batch backend (CUDA by default) and
writes the ``repro-experiments/v1`` artifact, which
``benchmarks/regression_gate.py`` reads as it reads the reference's.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import registry, runner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--filter", default=None,
                    help="comma-separated fnmatch globs over scenario names "
                         "(a bare family name selects the family)")
    ap.add_argument("--full", action="store_true",
                    help="full-mode grids and windows (default: quick)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--json", default=None, help="write the artifact here")
    args = ap.parse_args(argv)
    art = runner.run_scenarios(registry.select(args.filter),
                               quick=not args.full,
                               ignore_quick_skip=bool(args.filter),
                               device=args.device)
    print(f"{'scenario':36s} {'cells':>5s} {'tput_mean':>10s} "
          f"{'median_ms':>9s} {'p99_ms':>8s} {'wall_s':>7s} device")
    for sa in art["scenarios"]:
        s, run = sa["summary"], sa["run"]
        print(f"{sa['name']:36s} {run['cells']:5d} "
              f"{s['throughput']['mean']:10.1f} {s['median_ms']['mean']:9.4f} "
              f"{s['p99_ms']['mean']:8.4f} {run['wall_s']:7.2f} "
              f"{run['device']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
