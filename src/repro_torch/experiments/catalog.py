"""The port's scenario catalog: the reference's (``repro.experiments.
catalog``) 79 scenarios that the batch backend runs, copied with its specs
and in its registration order: the 35 ``backend="batch"`` scenarios and
the 44 discrete-event scenarios marked ``batch_ok``, which
``runner.run_scenarios(..., backend_override="batch")`` switches to the
batch backend (the reference's DES <-> batch cross-checks on identical
grids): Tables 1-2, Fig. 8, ``zipf``, ``conflict``, ``wan``, ``scale``,
``avail``, ``batching``, ``obs``, the ``megagrid`` slices and ``reads``.
Importing this module populates the registry."""
from __future__ import annotations

import math

from ..core.pig import PigConfig
from ..core.workload import WorkloadConfig
from ..faults.plan import crash_window, slow_window
from .registry import register
from .scenario import Scenario

# --------------------------------------------------------------- tables 1/2
# Analytical message-load tables, validated against the measured per-node
# message counts at representative R (the asserts live in report.py).
for r in (1, 3):
    register(Scenario(
        name=f"table1/validate/R={r}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=r), clients=(20,), seeds=(7,),
        duration=1.0, warmup=0.2, quick_duration=0.4, backend="des",
        batch_ok=True, collect=("per_node_msgs",)))

for r in (1, 2):
    register(Scenario(
        name=f"table2/validate/R={r}", protocol="pigpaxos", n=5,
        pig=PigConfig(n_groups=r), clients=(20,), seeds=(7,),
        duration=1.0, warmup=0.2, quick_duration=0.4, backend="des",
        batch_ok=True, collect=("per_node_msgs",)))

# ------------------------------------------------------------------- fig 8
# Max throughput vs number of relay groups, rotating vs static, 25 nodes.
for rotate in (True, False):
    for r in (1, 2, 3, 4, 5, 6, 8):
        register(Scenario(
            name=f"fig8/{'rotating' if rotate else 'static'}/R={r}",
            protocol="pigpaxos", n=25,
            pig=PigConfig(n_groups=r, prc=1, rotate_relays=rotate,
                          single_group_majority=(r == 1 and rotate)),
            clients=(20, 60, 120), quick_clients=(40, 120),
            duration=1.0, quick_duration=0.4, warmup=0.25, backend="des",
            batch_ok=True, quick_skip=(r in (4, 6, 8))))

# Beyond the paper: the same relay-group sweep at N in {25, 49, 101}.
for n in (25, 49, 101):
    for r in sorted({3, int(round(math.sqrt(n)))}):
        register(Scenario(
            name=f"fig8/scale/N={n}/R={r}", protocol="pigpaxos", n=n,
            pig=PigConfig(n_groups=r, prc=1), engine="fast",
            clients=(60, 120), quick_clients=(60,),
            duration=0.6, quick_duration=0.3, warmup=0.25, backend="des",
            batch_ok=True))

# Zipf-skewed PigPaxos at N=25, R=3: keys never route in Pig, so the batch
# backend (which never samples keys) is flat across theta by construction.
for theta in (0.6, 0.9, 0.99, 1.2):
    register(Scenario(
        name=f"zipf/pigpaxos/theta={theta}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=1),
        workload=WorkloadConfig(key_dist="zipfian", zipf_theta=theta),
        clients=(60,), seeds=(1, 2, 3),
        duration=0.8, quick_duration=0.3, backend="des", batch_ok=True))
register(Scenario(
    name="zipf/pigpaxos/uniform", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=3, prc=1),
    workload=WorkloadConfig(key_dist="uniform"),
    clients=(60,), seeds=(1, 2, 3),
    duration=0.8, quick_duration=0.3, backend="des", batch_ok=True))

# the fig10 three-region WAN latencies (one-way ms)
_WAN3_ONEWAY_MS = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]

# EPaxos conflict-rate sweeps: hot-key probability c drives the
# dependency/interference rate.  Each (N, c) point has the reference's
# discrete-event grid (batch_ok) and its batch-backend grid.
for n, engine in ((25, "exact"), (49, "fast")):
    for c in (0.0, 0.02, 0.1, 0.5):
        register(Scenario(
            name=f"conflict/N={n}/c={c}", protocol="epaxos", n=n,
            engine=engine, backend="des", batch_ok=True,
            workload=WorkloadConfig(key_dist="conflict", conflict_rate=c),
            clients=(40,), seeds=(1, 2, 3), quick_seeds=(1, 2),
            duration=0.8, quick_duration=0.3))
        register(Scenario(
            name=f"conflict/N={n}/c={c}/batch", protocol="epaxos", n=n,
            backend="batch", batch_ok=True,
            workload=WorkloadConfig(key_dist="conflict", conflict_rate=c),
            clients=(40,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2, 3),
            duration=0.8, quick_duration=0.3))


# WAN at N in {25, 49, 101}: the three-region topology scaled up, with
# per-region relay groups (paper §5.3), each size on both backends.
def _wan_scaled(n: int):
    """N nodes over 3 regions (fig10 latencies), per-region groups."""
    per = [n - 2 * (n // 3), n // 3, n // 3]
    spec = {"kind": "wan", "nodes_per_region": per,
            "oneway_ms": _WAN3_ONEWAY_MS}
    bounds = [0, per[0], per[0] + per[1], n]
    groups = [list(range(bounds[i], bounds[i + 1])) for i in range(3)]
    return spec, groups


for n in (25, 49, 101):
    spec, groups = _wan_scaled(n)
    for backend in ("des", "batch"):
        register(Scenario(
            name=f"wan/N={n}" + ("/batch" if backend == "batch" else ""),
            protocol="pigpaxos", n=n,
            pig=PigConfig(n_groups=3, groups=groups, prc=1),
            topo=spec, engine="fast", backend=backend, batch_ok=True,
            leader_timeout=400e-3,
            clients=(40, 120), quick_clients=(40,),
            seeds=(2, 3) if backend == "des" else tuple(range(16)),
            quick_seeds=(2,) if backend == "des" else (0, 1, 2, 3),
            duration=2.0, quick_duration=0.8, warmup=0.5,
            quick_skip=(n == 101 and backend == "des")))

# ======================================================================
# Batch-backend headroom: grids the DES cannot touch (one call per
# scenario; N up to 1025 and hundreds of seed replicates per point).
# ======================================================================
for n, r, nseeds, qseeds in ((257, 16, 128, 8), (1025, 32, 24, 4)):
    register(Scenario(
        name=f"scale/batch/N={n}/R={r}", protocol="pigpaxos", n=n,
        pig=PigConfig(n_groups=r, prc=1), backend="batch", batch_ok=True,
        clients=(60, 120), quick_clients=(60,),
        seeds=tuple(range(nseeds)), quick_seeds=tuple(range(qseeds)),
        duration=0.5, quick_duration=0.25, warmup=0.25,
        quick_skip=(n == 1025)))
# the paper-grade relay-group sweep with hundreds of replicates per R:
# 7 R values x 3 client counts x 64 seeds = 1344 cells, one call per
# scenario
for r in (1, 2, 3, 5, 8, 12, 24):
    register(Scenario(
        name=f"scale/batch/replicates/R={r}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=r, prc=1,
                      single_group_majority=(r == 1)),
        backend="batch", batch_ok=True,
        clients=(20, 60, 120), quick_clients=(60,),
        seeds=tuple(range(64)), quick_seeds=tuple(range(8)),
        duration=0.5, quick_duration=0.25, warmup=0.25))

# avail: availability under a leader (or relay) crash-recover window, as
# fault masks: the window defers hops at the down node, and the units carry
# the completion timeline the unavailability window and dip depth are read
# from.
_AVAIL_WL = WorkloadConfig(request_timeout=25e-3)
_AVAIL_PLANS = {
    # node 0 is the (only) leader
    "leader": crash_window(0, 0.8, 1.2),
    # node 1 relays ~1/R of its group's rounds; node 2 is gray throughout
    # (the open-ended slow window is "throughout" under any duration)
    "relay": crash_window(1, 0.8, 1.2) + slow_window(2, extra_latency=2e-3),
}
for n in (25, 49):
    for role, plan in _AVAIL_PLANS.items():
        register(Scenario(
            name=f"avail/{role}/N={n}", protocol="pigpaxos", n=n,
            pig=PigConfig(n_groups=3, prc=1, use_gray_list=True),
            workload=_AVAIL_WL, faults=plan, audit=True,
            engine="exact" if n == 25 else "fast", backend="des",
            grid_mode="curve", clients=(30,), seeds=(3,),
            duration=2.2, warmup=0.3, quick_duration=1.2,
            collect=("timeline",), batch_ok=True,
            quick_skip=(n == 49)))
for role, plan in _AVAIL_PLANS.items():
    register(Scenario(
        name=f"avail/{role}/N=25/batch", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=1, use_gray_list=True),
        workload=_AVAIL_WL, faults=plan, backend="batch", batch_ok=True,
        grid_mode="curve", clients=(30,), seeds=(3, 4, 5, 6),
        quick_seeds=(3, 4),
        duration=2.2, warmup=0.3, quick_duration=1.2,
        collect=("timeline",)))

# batching: leader-side request batching at saturation, the saturated-
# batch cost model (one kernel lane carries a whole batch of m clients)
for proto, pig in (("paxos", None),
                   ("pigpaxos", PigConfig(n_groups=3, prc=1))):
    for m in (1, 4, 8):
        register(Scenario(
            name=f"batching/{proto}/m={m}/batch", protocol=proto, n=25,
            pig=pig, backend="batch", batch_ok=True,
            batch={"max_batch": m, "max_delay_ms": 1.0},
            clients=(64,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2),
            duration=0.6, warmup=0.3, quick_duration=0.3,
            quick_skip=(m == 4 and proto != "paxos")))

# obs: the leader-backlog series sampled at request arrivals
register(Scenario(
    name="obs/pigpaxos/backlog/batch", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=5, prc=1), backend="batch", batch_ok=True,
    obs={"sample_rate": 0.0}, clients=(40,), seeds=(1, 2, 3, 4),
    quick_seeds=(1, 2), duration=0.6, warmup=0.25, quick_duration=0.3))

# megagrid slices: registry-visible samples of the million-cell
# cross-product study (experiments.megagrid), which streams through
# vectorsim.simulate_grid_sharded from its CLI
for n, r, prc, wan in ((9, 2, 1, False), (9, 2, 1, True),
                       (25, 4, 0, False), (25, 4, 2, True)):
    spec = _wan_scaled(n)[0] if wan else None
    register(Scenario(
        name=f"megagrid/slice/N={n}/R={r}/PRC={prc}/"
             + ("wan3" if wan else "lan"),
        protocol="pigpaxos", n=n, pig=PigConfig(n_groups=r, prc=prc),
        topo=spec, backend="batch", batch_ok=True,
        leader_timeout=400e-3 if wan else 50e-3,
        clients=(4, 16), quick_clients=(4,),
        seeds=tuple(range(16)), quick_seeds=(0, 1, 2, 3),
        duration=0.1, quick_duration=0.1, warmup=0.05,
        quick_skip=(n == 25 and prc == 2)))

# reads: 90% reads served under a held leader lease, against the same mix
# through the log
_LEASE = {"duration_ms": 200.0}
for path in ("lease", "log"):
    register(Scenario(
        name=f"reads/paxos/{path}/r=0.9/batch", protocol="paxos", n=25,
        backend="batch", batch_ok=True,
        workload=WorkloadConfig(read_ratio=0.9, read_path=path),
        lease=_LEASE if path == "lease" else None,
        clients=(60,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2),
        duration=0.6, warmup=0.3, quick_duration=0.3))
