"""Rebuild dry-run JSON artifacts from their stored op records without
tracing again: for when the accounting itself is iterated on.  The port
of ``repro.launch.reanalyze``; it reads ``<cell>.ops.json.gz`` (the op
record ``launch.dryrun`` writes) where the reference reads HLO.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze \\
      --dir artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import report
from .hlotop import load


def reanalyze(json_path: str) -> bool:
    record_path = json_path.replace(".json", ".ops.json.gz")
    if not os.path.exists(record_path):
        return False
    with open(json_path) as f:
        d = json.load(f)
    if "skipped" in d or "error" in d:
        return False
    d.update(report(d["arch"], d["shape"], d["mesh"], d["chips"],
                    d["model_flops"], load(record_path), d["pod_size"]))
    with open(json_path, "w") as f:
        json.dump(d, f, indent=1)
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    n = 0
    for p in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if reanalyze(p):
            n += 1
            print("reanalyzed", p)
    print(f"done: {n} artifacts")


if __name__ == "__main__":
    main()
