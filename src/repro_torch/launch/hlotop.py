"""Inspect a dry-run cell's op record: the top collectives, matrix-product
outputs and traffic operations by bytes (per device).  The port of
``repro.launch.hlotop``, named after it so the counterpart is easy to
find; it reads the op record that ``launch.dryrun`` writes
(``<cell>.ops.json.gz``), not HLO.  Identical operations (same op, same
shapes) are grouped: ``xN`` is how often the step dispatched them.

  PYTHONPATH=src python -m repro_torch.launch.hlotop \\
      artifacts/dryrun_torch/<cell>.ops.json.gz
"""
from __future__ import annotations

import argparse
import gzip
import json
from collections import defaultdict


def _shape(entry) -> str:
    return ",".join(f"{dt}{s}" for s, dt in entry["out"])[:60]


def top_ops(record: list, k: int = 15):
    """(collectives, matrix-product outputs, traffic), each a list of
    (bytes, kind, shape, count, tag), largest first.  ``tag`` names the
    group a collective spans (its first ranks)."""
    groups = {"coll": defaultdict(lambda: [0.0, 0]),
              "dot": defaultdict(lambda: [0.0, 0]),
              "traffic": defaultdict(lambda: [0.0, 0])}

    def add(which, key, b):
        g = groups[which][key]
        g[0] += b
        g[1] += 1

    for e in record:
        shape = _shape(e)
        if "coll" in e:
            tag = "ranks " + ",".join(map(str, e["ranks"][:4]))
            add("coll", (e["coll"], shape, tag), e["coll_bytes"])
        if "flops" in e:
            out = sum(_bytes(s, dt) for s, dt in e["out"])
            add("dot", (e["op"], shape, ""), out)
        if e.get("bytes"):
            add("traffic", (e["op"], shape, ""), e["bytes"])

    def ranked(which):
        rows = [(b, kind, shape, n, tag)
                for (kind, shape, tag), (b, n) in groups[which].items()]
        return sorted(rows, reverse=True)[:k]

    return ranked("coll"), ranked("dot"), ranked("traffic")


_SIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
         "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
         "bool": 1}


def _bytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * _SIZE.get(dtype, 4)


def load(path: str) -> list:
    with gzip.open(path, "rt") as f:
        return json.load(f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("-k", type=int, default=15)
    args = ap.parse_args(argv)
    colls, dots, traffic = top_ops(load(args.path), args.k)
    print("== top collectives (bytes/device) ==")
    for b, kind, shape, n, tag in colls:
        print(f"  {b/1e9:9.3f}GB x{n:5d} {kind:20s} {shape:40s} {tag}")
    print("== top matrix-product outputs ==")
    for b, kind, shape, n, tag in dots:
        print(f"  {b/1e9:9.3f}GB x{n:5d} {kind:20s} {shape:40s} {tag}")
    print("== top traffic ops ==")
    for b, kind, shape, n, tag in traffic:
        print(f"  {b/1e9:9.3f}GB x{n:5d} {kind:20s} {shape:40s} {tag}")


if __name__ == "__main__":
    main()
