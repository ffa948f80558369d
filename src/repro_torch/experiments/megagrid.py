"""The ``megagrid`` study on the port (``repro.experiments.megagrid``): the
full N x R x PRC x conflict x WAN cross-product as one million-cell
batch-backend run.

The paper's analytical claim — throughput is maximized at one rotating
relay and the bottleneck shifts predictably with N, R and PRC (§6,
Eq. 1-3) — is only fully testable over the cross-product of all those
axes.  This module enumerates it, as the reference does:

* **group kernel** — Paxos plus rotating PigPaxos at every valid
  (N, R, PRC) combination of the ``group_n`` x ``r`` x ``prc`` axes;
* **epaxos kernel** — the conflict axis (hot-key rates) at ``epaxos_n``;
* **WAN** — every point twice: LAN and the fig10 three-region topology
  scaled to N (``wan3``);
* **clients x seeds** — the cell grid within each point (seeds are the
  replicate axis and the knob that scales the run to a target cell count).

Points are bucketed by padded-shape signature (kernel kind, follower-axis
size class, client class, topology class), and each bucket streams through
``vectorsim.simulate_grid_sharded`` chunk by chunk (device memory bounded
by one chunk).  Results aggregate into ONE ``repro-experiments/v1``
artifact: per-point curve entries under the ``megagrid`` family plus a
``megagrid`` section with per-bucket and per-chunk walls, cells/s, the
device, the fan-in, the host seconds spent stacking cells and a roofline
note against the device's measured ceilings.

CLI:  ``python -m repro_torch.experiments.megagrid --cells 1000000 --out
FILE`` on the CUDA device (``--preset smoke --device cpu`` is the CPU
slice).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import vectorsim as vs
from ..core.pig import PigConfig
from ..core.workload import WorkloadConfig
from ..device import resolve_device
from .runner import ARTIFACT_SCHEMA, _agg
from .scenario import build_topology

# the reference's committed 384-cell fig8-grid baseline (its
# BENCH_vectorsim.json: 31.3 s cold / 384 cells under JAX on one CPU
# core): kept as the artifact's yardstick, a CPU number
BASELINE_PER_CELL_MS = 31.3e3 / 384

_WAN3_MS = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]   # fig10

FULL_AXES = {
    "group_n": (5, 9, 17, 25),
    "r": (1, 2, 4, 8),
    "prc": (0, 1, 2),
    "epaxos_n": (5, 9, 17),
    "conflict": (0.0, 0.1, 0.5),
    "wan": ("lan", "wan3"),
    "clients": (2, 4, 8, 16),
}

# the CI slice: same code path (both kernels, both topology classes,
# chunked dispatch) at ~1/500 the cell count
SMOKE_AXES = {
    "group_n": (5, 9),
    "r": (1, 2),
    "prc": (0, 1),
    "epaxos_n": (5,),
    "conflict": (0.0, 0.5),
    "wan": ("lan", "wan3"),
    "clients": (4,),
}

_TIMEOUT = {"lan": 50e-3, "wan3": 400e-3}   # retry_risk classification


def _topo_spec(wan: str, n: int) -> Optional[dict]:
    if wan == "lan":
        return None
    per = [n - 2 * (n // 3), n // 3, n // 3]
    return {"kind": "wan", "nodes_per_region": per, "oneway_ms": _WAN3_MS}


def build_points(axes: Dict = FULL_AXES) -> List[dict]:
    """One entry per config point of the cross-product: {name, kind, axes,
    cfg, weight} — clients x seeds fill the cell grid within each point.
    ``weight`` down-scales the seed allocation of expensive kinds."""
    pts = []
    for wan in axes["wan"]:
        for n in axes["group_n"]:
            topo = build_topology(_topo_spec(wan, n))
            pts.append(dict(
                name=f"paxos/N={n}/{wan}", kind="group", weight=1.0,
                axes=dict(protocol="paxos", n=n, wan=wan),
                cfg=vs.build_config("paxos", n, topo=topo,
                                    label=f"paxos/N={n}/{wan}")))
            for r in axes["r"]:
                if r > n - 1:
                    continue
                for prc in axes["prc"]:
                    pts.append(dict(
                        name=f"pig/N={n}/R={r}/PRC={prc}/{wan}",
                        kind="group", weight=1.0,
                        axes=dict(protocol="pigpaxos", n=n, r=r, prc=prc,
                                  wan=wan),
                        cfg=vs.build_config(
                            "pigpaxos", n, pig=PigConfig(n_groups=r, prc=prc),
                            topo=topo,
                            label=f"pig/N={n}/R={r}/PRC={prc}/{wan}")))
        for n in axes["epaxos_n"]:
            topo = build_topology(_topo_spec(wan, n))
            for c in axes["conflict"]:
                wl = (WorkloadConfig(key_dist="conflict", conflict_rate=c)
                      if c > 0 else WorkloadConfig())
                # epaxos pops one request per scan step (no burst batching)
                # -> ~8x the per-cell cost; give it 1/8 the seed budget
                pts.append(dict(
                    name=f"epaxos/N={n}/c={c}/{wan}", kind="epaxos",
                    weight=0.125,
                    axes=dict(protocol="epaxos", n=n, conflict=c, wan=wan),
                    cfg=vs.build_config(
                        "epaxos", n, topo=topo, workload=wl,
                        label=f"epaxos/N={n}/c={c}/{wan}")))
    return pts


def _bucket_key(pt: dict, k: int) -> tuple:
    """Padded-shape bucket: kind + follower-axis size class + client class
    + topology class.  Everything inside one bucket shares padded shapes
    and a step budget."""
    n = pt["cfg"].n
    wan = pt["axes"]["wan"]
    kcls = 4 if k <= 4 else 16
    if pt["kind"] == "epaxos":
        return ("epaxos", n, kcls, wan)
    fcls = 8 if n <= 9 else 16 if n <= 17 else 24
    return ("group", fcls, kcls, wan)


def plan(cells: int, axes: Dict = FULL_AXES):
    """The study's points (each with its ``seeds``) and buckets in run
    order: [(bucket key, [(point index, clients), ...]), ...]."""
    pts = build_points(axes)
    kaxis = list(axes["clients"])
    wsum = sum(p["weight"] for p in pts) * len(kaxis)
    seeds = max(1, int(np.ceil(cells / wsum)))
    for p in pts:
        p["seeds"] = max(1, int(round(seeds * p["weight"])))
    buckets: Dict[tuple, List] = {}
    for pi, p in enumerate(pts):
        for k in kaxis:
            buckets.setdefault(_bucket_key(p, k), []).append((pi, k))
    return pts, [(b, buckets[b]) for b in sorted(buckets, key=str)]


# ------------------------------------------------------------------ roofline
def measure_ceilings(device=None) -> Dict[str, float]:
    """The device's own ceilings the roofline note is drawn against: an
    f32 GEMM's rate with TF32 off (compute) and a streaming add's bytes/s
    (memory; 2 reads + 1 write of 128 MiB each).  Measured, not
    quoted; a yardstick, not a kernel of the port."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    reps = 8

    def timed(fn):
        fn()
        if cuda:
            torch.cuda.synchronize(dev)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize(dev)
            return t0.elapsed_time(t1) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps

    m = 4096 if cuda else 1024
    a = torch.ones(m, m, dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gemm_s = timed(lambda: a @ a)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    x = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    y = torch.ones_like(x)        # two inputs: x + x would read x once
    add_s = timed(lambda: x + y)
    return {
        "peak_flops": 2.0 * m ** 3 / gemm_s,            # f32 FMA ceiling
        "peak_bytes_per_s": 3.0 * x.numel() * 4 / add_s,
    }


def _cell_step_ops(kind: str, F: int, G: int, B: int) -> float:
    """Model op count of one scan step of one cell (element-ops, counted
    from the kernel body: ~70 (B,F)-shaped passes + ~30 (B,G) + threefry
    RNG at ~40 ops/draw + the O(F log^2 F) sort network).  An estimate for
    the roofline NOTE, not a profile."""
    if kind == "epaxos":
        n = F            # callers pass n as F for the epaxos kernel
        return 40.0 * (2 * n + 4) + 60.0 * n
    logf = max(np.log2(max(F, 2)), 1.0)
    return (40.0 * B * (2 + 2 * G + 2 * F)      # threefry jitter draws
            + 70.0 * B * F + 30.0 * B * G       # elementwise pipeline
            + 2.0 * B * F * logf * logf)        # lexicographic sort


def roofline_note(buckets: List[dict], ceilings: Dict[str, float]) -> dict:
    """How far from the hardware limit the batch backend lands: achieved
    element-ops/s (model count / measured wall) against the measured GEMM
    ceiling, and the implied bytes/s (4 B per element-op, ~1.5 access
    amplification) against the streaming ceiling."""
    ops = sum(b["est_ops"] for b in buckets)
    wall = sum(b["wall_s"] for b in buckets)
    achieved = ops / max(wall, 1e-9)
    bytes_ps = achieved * 4.0 * 1.5
    f_c = achieved / ceilings["peak_flops"]
    f_m = bytes_ps / ceilings["peak_bytes_per_s"]
    return {
        "est_element_ops": ops,
        "achieved_gops": round(achieved / 1e9, 3),
        "peak_gflops": round(ceilings["peak_flops"] / 1e9, 1),
        "peak_stream_gbps": round(ceilings["peak_bytes_per_s"] / 1e9, 1),
        "frac_of_compute_roof": round(f_c, 4),
        "frac_of_memory_roof": round(f_m, 4),
        "bound": "memory" if f_m >= f_c else "compute",
    }


# ------------------------------------------------------------------ the run
def run_megagrid(cells: int = 1_000_000, *, axes: Dict = FULL_AXES,
                 chunk: int = 4096, kernel: str = "auto",
                 duration: float = 0.1, warmup: float = 0.05,
                 progress=print, device=None) -> dict:
    """Run the cross-product study at >= ``cells`` total grid cells on
    ``device`` (CUDA unless the caller passes "cpu") and return the
    ``repro-experiments/v1`` artifact (see the module docstring).

    Device memory is bounded by ``chunk``; ``kernel`` passes through to
    ``simulate_grid_sharded``."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    pts, buckets = plan(cells, axes)
    kaxis = list(axes["clients"])
    acc: Dict[int, Dict[int, dict]] = {pi: {} for pi in range(len(pts))}
    bmeta, all_chunks = [], []
    total_cells = 0
    sharding = None
    for bkey, pairs in buckets:
        pis = sorted({pi for pi, _ in pairs})
        cfgs = [pts[pi]["cfg"] for pi in pis]
        grid, spans = [], []
        for pi, k in pairs:
            s0 = len(grid)
            grid += [(pis.index(pi), k, s) for s in range(pts[pi]["seeds"])]
            spans.append((pi, k, s0, len(grid)))
        t0 = time.perf_counter()
        out = vs.simulate_grid_sharded(cfgs, grid, duration, warmup,
                                       chunk=chunk, kernel=kernel,
                                       device=dev)
        wall = time.perf_counter() - t0
        sharding = out["sharding"]
        for pi, k, lo, hi in spans:
            tput = out["throughput"][lo:hi]
            med = out["median_s"][lo:hi] * 1e3
            p99 = out["p99_s"][lo:hi] * 1e3
            to = _TIMEOUT[pts[pi]["axes"]["wan"]]
            acc[pi][k] = {
                "throughput": _agg([float(v) for v in tput]),
                "median_ms": _agg([float(v) for v in med]),
                "p99_ms": _agg([float(v) for v in p99]),
                "committed": int(out["committed"][lo:hi].sum()),
                "retry_risk_frac": float(
                    (out["p99_s"][lo:hi] >= to).mean()),
                "exhausted": int(out["exhausted"][lo:hi].sum()),
            }
        ncell = len(grid)
        total_cells += ncell
        kind = "epaxos" if bkey[0] == "epaxos" else "group"
        if kind == "group":
            F, B = bkey[1], min(8, bkey[2])
            G = max(c.rmax for c in cfgs)
        else:
            F, G, B = bkey[1], 1, 1
        chunks = out["sharding"]["chunks"]
        steps = float(np.mean([m["steps"] for m in chunks]))
        breq = min(8, bkey[2]) if kind == "group" else 1
        est = ncell * (steps / breq) * _cell_step_ops(kind, F, G, B)
        bmeta.append({"bucket": list(map(str, bkey)), "cells": ncell,
                      "wall_s": round(wall, 2), "est_ops": est,
                      "steps": int(steps),
                      "scan_steps": int(out["scan_steps"]),
                      "stack_s": round(sum(m["stack_s"] for m in chunks), 4),
                      "retries": sum(m["retries"] for m in chunks),
                      "exhausted": int(out["exhausted"].sum()),
                      "chunks": len(chunks)})
        all_chunks += [{"bucket": str(bkey), **m} for m in chunks]
        if progress:
            progress(f"[megagrid] {bkey}: {ncell} cells, "
                     f"{out['scan_steps']} scan steps in {wall:.1f}s "
                     f"({ncell / max(wall, 1e-9):.0f} cells/s)")

    wall_total = time.perf_counter() - t_start
    ceilings = measure_ceilings(dev)
    per_cell_ms = wall_total / max(total_cells, 1) * 1e3
    scenarios = []
    for pi, p in enumerate(pts):
        per_k = acc[pi]
        alln = [per_k[k]["throughput"] for k in per_k]
        scenarios.append({
            "name": f"megagrid/{p['name']}", "family": "megagrid",
            "grid_mode": "curve", "backend": "batch", "quick": False,
            "consistency": "model",
            "spec": {**p["axes"], "clients": kaxis, "seeds": p["seeds"],
                     "duration": duration, "warmup": warmup},
            "units": [],          # 10^6 raw units stay out of the artifact
            "replicates": [],
            "points": [{"clients": k, **per_k[k]}
                       for k in sorted(per_k)],
            "summary": {
                "throughput": _agg([a["mean"] for a in alln
                                    if a["mean"] is not None]),
                "median_ms": _agg(
                    [per_k[k]["median_ms"]["mean"] for k in per_k
                     if per_k[k]["median_ms"]["mean"] is not None]),
                "p99_ms": _agg(
                    [per_k[k]["p99_ms"]["mean"] for k in per_k
                     if per_k[k]["p99_ms"]["mean"] is not None]),
                "committed": sum(per_k[k]["committed"] for k in per_k),
                "cells": sum(a["n"] for a in alln),
            },
        })
    return {
        "schema": ARTIFACT_SCHEMA, "quick": False, "processes": 1,
        "scenarios": scenarios,
        "megagrid": {
            "cells": total_cells,
            "points": len(pts),
            "wall_s": round(wall_total, 1),
            "cells_per_s": round(total_cells / max(wall_total, 1e-9), 1),
            "per_cell_ms": round(per_cell_ms, 4),
            "baseline_per_cell_ms": round(BASELINE_PER_CELL_MS, 2),
            "speedup_per_cell": round(BASELINE_PER_CELL_MS / per_cell_ms, 1),
            "device_count": sharding["devices"],
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "backend": dev.type,
            "kernel": sharding["kernel"],
            "impl": sharding["impl"],
            "chunk": chunk,
            "duration_s": duration, "warmup_s": warmup,
            "stack_s": round(sum(b["stack_s"] for b in bmeta), 4),
            "scan_steps": sum(b["scan_steps"] for b in bmeta),
            "exhausted": sum(b["exhausted"] for b in bmeta),
            "buckets": bmeta,
            "chunk_walls": all_chunks,
            "roofline": roofline_note(bmeta, ceilings),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=1_000_000)
    ap.add_argument("--preset", choices=("full", "smoke"), default="full")
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--kernel", default="auto", choices=vs.KERNELS)
    ap.add_argument("--duration", type=float, default=0.1)
    ap.add_argument("--warmup", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default="megagrid.json")
    args = ap.parse_args(argv)
    axes = SMOKE_AXES if args.preset == "smoke" else FULL_AXES
    art = run_megagrid(args.cells, axes=axes, chunk=args.chunk,
                       kernel=args.kernel, duration=args.duration,
                       warmup=args.warmup, device=args.device)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
    mg = art["megagrid"]
    print(f"[megagrid] {mg['cells']} cells in {mg['wall_s']}s "
          f"({mg['cells_per_s']} cells/s, {mg['per_cell_ms']} ms/cell) on "
          f"{mg['device']} through {mg['kernel']}; host stacking "
          f"{mg['stack_s']} s, exhausted {mg['exhausted']} -> {args.out}")
    print(f"[megagrid] roofline: {mg['roofline']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
