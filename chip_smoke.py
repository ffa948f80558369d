#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  - require CUDA; print the card's name and power limit;
2. build   - build the seg_fanin kernel from ``src/repro_torch/kernels/csrc``;
3. kernel  - hold the kernel against its plain PyTorch version on the card
             at the batch shapes (F = 24, 256, 1024 slots, rows = cells x 8)
             plus ragged layouts, ties, masked slots and a fully masked
             segment: bit equality;
4. timing  - the kernel at the N=1025 shape (384 rows x 1024 slots) beside
             its bound and the plain version;
5. main    - ``scale/batch/N=1025/R=32``, ``N=257/R=16`` and
             ``replicates/R=3`` at their full grids through
             ``repro_torch.experiments.runner.run_scenarios`` on cuda; every
             scan step launches the kernel once, and R=3's mean throughput
             must sit inside its ``benchmarks/reference_bounds.json`` window;
6. check   - R=3 in quick mode: kernel run == plain-version run on the card
             (bit-identical), a rerun is bit-identical, and the card agrees
             with the CPU within the parity tolerance.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_S = 67e12          # H100 SXM f32 peak outside the tensor cores
MAIN = ("scale/batch/N=1025/R=32", "scale/batch/N=257/R=16",
        "scale/batch/replicates/R=3")
CHECK = "scale/batch/replicates/R=3"
# the CPU parity tolerance for damped cells (tests/test_torch_vectorsim.py):
# counts within one request at the window edges, latency percentiles to
# rel 1e-5, message loads to abs 1e-6
COUNT_SLACK, LAT_REL, MSG_ABS = 1, 1e-5, 1e-6


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------- phase 3
def layouts(F):
    """(name, segment sizes) for F slots: the main path's relay groups and
    a ragged layout of the same width."""
    from repro_torch.core.pig import partition_followers
    r = {24: 3, 256: 16, 1024: 32}[F]
    sizes = [len(g) for g in partition_followers(list(range(1, F + 1)), r)]
    ragged, left, k = [], F, 0
    while left:
        s = min(left, 1 + (7 * k + 3) % 37)
        ragged.append(s)
        left -= s
        k += 1
    return [(f"R={r}", sizes), ("ragged", ragged)]


def fanin_case(sizes, cells, B, device, seed):
    """Inputs of one fan-in call in the kernel's row layout, with ties
    (values on a 2**-8 grid), ~10% masked slots and the last segment fully
    masked."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    F, G = sum(sizes), len(sizes)
    seg = torch.repeat_interleave(torch.arange(G), torch.tensor(sizes))
    R = cells * B
    vals = 1.0 + torch.floor(torch.rand(R, F, generator=g) * 256) / 256
    vals[torch.rand(R, F, generator=g) < 0.1] = math.inf
    vals[:, seg == G - 1] = math.inf
    coef = (torch.rand(R, G, generator=g) * 1e-3)[:, seg]
    kcap = torch.floor(torch.rand(cells, G, generator=g)
                       * torch.tensor(sizes, dtype=torch.float32))[:, seg]
    scal = torch.stack([-0.05 - 0.9 * torch.rand(R, generator=g),
                        3e-4 * torch.rand(R, generator=g),
                        2e-5 * torch.ones(R),
                        torch.ones(R)], dim=1)
    to = dict(device=device)
    return (vals.to(**to).contiguous(), coef.to(**to).contiguous(),
            seg.to(torch.int32).expand(cells, F).contiguous().to(**to),
            kcap.to(torch.int32).contiguous().to(**to),
            scal.to(**to).contiguous(), B)


def max_abs_err(a, b):
    import torch
    same_inf = torch.equal(torch.isinf(a), torch.isinf(b)) and torch.equal(
        a[torch.isinf(a)], b[torch.isinf(b)])
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
    return err if same_inf else math.inf


def check_kernel(device):
    import torch
    from repro_torch.kernels import segfanin
    from repro_torch.kernels.ref import seg_fanin_rows_ref
    worst = 0.0
    for F, cells in ((24, 192), (256, 256), (1024, 48)):
        for name, sizes in layouts(F):
            args = fanin_case(sizes, cells, 8, device, seed=F + len(sizes))
            before = segfanin.launches
            got = segfanin.seg_fanin_rows(*args)
            launched = segfanin.launches - before
            want = seg_fanin_rows_ref(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            ok = torch.equal(got, want) and launched == 1
            log(f"kernel   F={F:5d} {name:7s} rows={cells * 8:5d} "
                f"segments={len(sizes):3d} launches={launched} "
                f"equal={ok} (tolerance: bit equality) max_abs_err={err}")
            if not ok:
                raise SystemExit(f"seg_fanin kernel != plain version at "
                                 f"F={F} ({name})")
    return worst


# --------------------------------------------------------------- phase 4
def time_ms(fn, iters, warmup=10):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_kernel(device):
    from repro_torch.kernels import segfanin
    from repro_torch.kernels.ref import seg_fanin_rows_ref
    sizes = layouts(1024)[0][1]
    args = list(fanin_case(sizes, 48, 8, device, seed=7))
    args[0][:] = args[0].clamp(max=3.0)          # no masked slots
    R, F = args[0].shape
    C = args[2].shape[0]
    ms = time_ms(lambda: segfanin.seg_fanin_rows(*args), 200)
    plain_ms = time_ms(lambda: seg_fanin_rows_ref(*args), 20, warmup=3)
    nbytes = 4 * (3 * R * F + 2 * C * F + 4 * R)   # read each input once,
    # write the output once
    ops = R * (2 * sum(s * s for s in sizes) + 9 * F)   # compares + y
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / F32_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"timing   seg_fanin rows={R} F={F}: kernel {ms:.6f} ms, plain "
        f"version {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
        f"({nbytes} bytes at 3.35 TB/s = {bytes_ms:.6f} ms; {ops} ops at "
        f"67 TFLOP/s = {ops_ms:.6f} ms), no single PyTorch call computes it")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# --------------------------------------------------------------- phase 5
def run_main_path(device):
    import torch
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import segfanin
    with open(os.path.join(ROOT, "benchmarks", "reference_bounds.json")) as f:
        bounds = json.load(f)["bounds"]
    total = 0
    for name in MAIN:
        (sc,) = registry.select(name)
        segfanin.launches = 0
        t0 = time.perf_counter()
        art = runner.run_scenarios([sc], quick=False, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segfanin.launches
        sa = art["scenarios"][0]
        run, units = sa["run"], sa["units"]
        bad = [u for u in units if u["exhausted"] or not all(
            u[k] is not None and u[k] > 0 for k in
            ("throughput", "mean_ms", "median_ms", "p25_ms", "p75_ms",
             "p99_ms"))]
        if bad:
            raise SystemExit(f"{name}: {len(bad)} cells exhausted or with "
                             f"non-finite/zero results, e.g. {bad[0]}")
        if launches != run["scan_steps"]:
            raise SystemExit(f"{name}: {launches} kernel launches for "
                             f"{run['scan_steps']} scan steps")
        tput = sa["summary"]["throughput"]["mean"]
        log(f"main     {name:28s} cells={run['cells']:4d} "
            f"scan_steps={run['scan_steps']:5d} launches={launches:5d} "
            f"wall={wall:.3f}s cells/s={run['cells'] / wall:.2f} "
            f"ms/step={1e3 * run['wall_s'] / run['scan_steps']:.4f} "
            f"tput_mean={tput} device={run['device']}")
        if name in bounds:
            lo, hi = bounds[name]
            if not lo <= tput <= hi:
                raise SystemExit(f"{name}: mean throughput {tput} outside "
                                 f"[{lo}, {hi}]")
            log(f"main     {name} mean throughput {tput} inside "
                f"[{lo}, {hi}]")
        total += launches
    return total


# --------------------------------------------------------------- phase 6
def cross_check(device):
    from repro_torch.core import vectorsim
    from repro_torch.experiments import registry
    (sc,) = registry.select(CHECK)
    rs = sc.resolve(True)
    kw = dict(pig=sc.pig, clients=rs.clients, seeds=rs.seeds,
              duration=rs.duration, warmup=rs.warmup,
              leader_timeout=sc.leader_timeout)

    def run(dev, kernel="auto"):
        return vectorsim.simulate_scenario(sc.protocol, sc.n, kernel=kernel,
                                           device=dev, **kw)
    a, b, p = run(device), run(device), run(device, "torch")
    if a != b:
        raise SystemExit(f"{CHECK}: two runs on the card differ")
    if a != p:
        raise SystemExit(f"{CHECK}: kernel run != plain-version run on the "
                         f"card")
    c = run("cpu")
    worst = {"count": 0, "committed": 0, "lat_rel": 0.0, "msg_abs": 0.0}
    for x, y in zip(a, c):
        for k in ("count", "committed"):
            worst[k] = max(worst[k], abs(x[k] - y[k]))
        for k in ("median_ms", "p25_ms", "p75_ms", "p99_ms"):
            worst["lat_rel"] = max(worst["lat_rel"],
                                   abs(x[k] - y[k]) / abs(y[k]))
        for k in ("leader_msgs_per_op", "follower_msgs_per_op"):
            worst["msg_abs"] = max(worst["msg_abs"], abs(x[k] - y[k]))
    log(f"check    {CHECK} quick ({len(a)} cells): cuda == cuda rerun, "
        f"kernel == plain version; cuda vs cpu worst {worst}")
    if (worst["count"] > COUNT_SLACK or worst["committed"] > COUNT_SLACK
            or worst["lat_rel"] > LAT_REL or worst["msg_abs"] > MSG_ABS):
        raise SystemExit(f"{CHECK}: cuda and cpu disagree beyond the parity "
                         f"tolerance: {worst}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device   {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib = build.build("seg_fanin")
    log(f"build    {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"build    ptxas: {line.strip()}")

    err = check_kernel(device)
    timing = time_kernel(device)
    launches = run_main_path(device)
    cross_check(device)

    record = {"name": "seg_fanin", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/seg_fanin.cu",
              "replaces": "src/repro/kernels/segfanin.py:46",
              "launches": launches, "max_abs_err": err, **timing,
              "library_ms": None}
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
