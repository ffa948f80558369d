"""Small traffic mixes with the cells' client counts, for runs on the CPU
(two seeds a client count, a short simulated window), and the entries
that put ``epaxos25.montecarlo`` back into a copy of ``BENCHMARK.json``:
its deployment, traffic, limits, reference and readers are files under
``portbench/``, but the cell is not measured (PERF.md §7)."""
import json
import shutil
import time

from portbench import spec

MIXES = {
    "pig25.montecarlo": {"clients": [20, 60, 120], "seeds_per_clients": 2,
                         "warmup_s": 0.02, "duration_s": 0.03,
                         "setup_warmup_s": 0.01, "setup_duration_s": 0.02},
    "epaxos25.montecarlo": {"clients": [10, 20, 40], "seeds_per_clients": 2,
                            "warmup_s": 0.02, "duration_s": 0.03,
                            "setup_warmup_s": 0.01,
                            "setup_duration_s": 0.02},
}
CELLS = tuple(MIXES)
CONFIGS = {"pig25.montecarlo": "pigpaxos-n25-r3",
           "epaxos25.montecarlo": "epaxos-n25"}


def config(cell):
    """The deployment file of ``cell``, read directly."""
    return json.loads((spec.HERE / "configs" / f"{CONFIGS[cell]}.json")
                      .read_text())
SEED = 3_000_000_017      # more than 32 bits, as a run's seed may be

EPAXOS = {
    "configs": [{
        "name": "epaxos-n25",
        "source": "https://arxiv.org/abs/2003.07760 (Fig. 9, EPaxos at N = "
                  "25 on one LAN); 2% conflicts from Moraru et al., SOSP "
                  "2013 (EPaxos)",
        "file": "portbench/configs/epaxos-n25.json", "reduced": [],
        "why": "the leaderless comparison at N = 25: fast and slow quorums "
               "through the per-slot fan-in, hot-key conflicts"}],
    "workloads": [{
        "name": "epaxos25.montecarlo", "config": "epaxos-n25",
        "traffic": "montecarlo-c10-20-40", "chips": 1,
        "why": "the Monte-Carlo sweep on EPaxos (10/20/40 clients x 1,365 "
               "seeds, 2% conflicts): the EPaxos step loop and per-slot "
               "fan-in"}],
    "per_layer": [
        {"name": m, "unit": u, "better": b, "source": src, "layer": layer,
         "moves": "cells_per_s", "workloads": ["epaxos25.montecarlo"]}
        for m, u, b, src, layer in (
            ("scan_step_ms.epaxos", "ms", "lower", "host_clock",
             "EPaxos step loop"),
            ("host_cpu_ms_per_step.epaxos", "ms", "lower", "host_clock",
             "host dispatch"),
            ("kernels_per_step.epaxos", "kernels", "lower", "device_trace",
             "device launches"),
            ("device_idle_share.epaxos", "%", "lower", "device_trace",
             "device"),
            ("fanin_rows_roofline", "%", "higher", "device_trace",
             "fan-in kernel"))],
}


def copy_tree(dst):
    """BENCHMARK.json and portbench's data files under ``dst``."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(spec.HERE / sub, dst / "portbench" / sub)
    shutil.copy(spec.ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def root_with_epaxos(dst):
    """A copy of the benchmark with ``epaxos25.montecarlo`` added by
    entries alone."""
    copy_tree(dst)
    bench = spec.load_benchmark(dst)
    for key, entries in EPAXOS.items():
        bench[key] += entries
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run(cell, root=spec.ROOT, seed=SEED):
    """One run of ``cell`` on the CPU through everything but the look for
    a chip."""
    from portbench import harness
    return harness.run_cell(cell, seed, 0.0, False, "cpu",
                            time.perf_counter(), root=root,
                            mix_override=MIXES[cell])
