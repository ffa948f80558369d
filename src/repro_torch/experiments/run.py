"""Command line for the port's scenarios.

    python -m repro_torch.experiments.run --filter 'scale/batch/*' \\
        [--full] [--device cpu] [--backend batch|des] [--processes N] \\
        [--rows] --json PATH

Runs the selected scenarios, the discrete-event ones on the host (in
``--processes`` workers) and the batch ones on the card (CUDA by default),
and writes the ``repro-experiments/v1`` artifact, which
``benchmarks/regression_gate.py`` reads as it reads the reference's.
``--backend batch`` switches the ``batch_ok`` discrete-event scenarios to
the batch backend (the paper's Fig. 8 and Tables 1-2 among them),
``--backend des`` the batch ones to the discrete-event engines;
``--rows`` prints the report's ``name,us_per_call,derived`` rows after the
table, e.g.

    python -m repro_torch.experiments.run --filter fig9 --processes 4 --rows
    python -m repro_torch.experiments.run --filter fig8,table1,table2 \\
        --backend batch --full --rows
"""
from __future__ import annotations

import argparse
import json
import sys

from . import registry, report, runner


def _num(x, width, digits) -> str:
    """A summary number, or "-" where the window had no completions."""
    return f"{x:{width}.{digits}f}" if x is not None else f"{'-':>{width}s}"


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
    ap.add_argument("--backend", default=None,
                    help="backend override: 'batch' runs the batch_ok "
                         "discrete-event scenarios on the batch backend, "
                         "'des' the batch scenarios on the DES")
    ap.add_argument("--processes", type=int, default=0,
                    help="worker processes for the discrete-event units "
                         "(0: inline)")
    ap.add_argument("--rows", action="store_true",
                    help="print the report rows of the artifact")
    ap.add_argument("--json", default=None, help="write the artifact here")
    args = ap.parse_args(argv)
    art = runner.run_scenarios(registry.select(args.filter),
                               quick=not args.full,
                               processes=args.processes,
                               ignore_quick_skip=bool(args.filter),
                               backend_override=args.backend,
                               device=args.device)
    print(f"{'scenario':36s} {'cells':>5s} {'tput_mean':>10s} "
          f"{'median_ms':>9s} {'p99_ms':>8s} {'wall_s':>7s} device")
    for sa in art["scenarios"]:
        s, run = sa["summary"], sa["run"]
        print(f"{sa['name']:36s} {run['cells']:5d} "
              f"{_num(s['throughput']['mean'], 10, 1)} "
              f"{_num(s['median_ms']['mean'], 9, 4)} "
              f"{_num(s['p99_ms']['mean'], 8, 4)} {run['wall_s']:7.2f} "
              f"{run['device']}"
              + (f" events={run['events']}" if "events" in run else ""))
    if args.rows:
        for row in report.rows_for_artifact(art):
            print(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
