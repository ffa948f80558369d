"""The port's scenario catalog: the reference's 35 batch-backend
scenarios (``repro.experiments.catalog``, ``backend="batch"``), copied
with its specs and in its order: the EPaxos ``conflict`` grids, ``wan``,
``scale``, ``avail``, ``batching``, ``obs``, the ``megagrid`` slices and
``reads``.  Importing this module populates the registry."""
from __future__ import annotations

from ..core.pig import PigConfig
from ..core.workload import WorkloadConfig
from ..faults.plan import crash_window, slow_window
from .registry import register
from .scenario import Scenario

# the fig10 three-region WAN latencies (one-way ms)
_WAN3_ONEWAY_MS = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]

# EPaxos conflict-rate sweeps on the batch backend (the conflict/slow-path
# model): hot-key probability c drives the dependency/interference rate
for n in (25, 49):
    for c in (0.0, 0.02, 0.1, 0.5):
        register(Scenario(
            name=f"conflict/N={n}/c={c}/batch", protocol="epaxos", n=n,
            backend="batch", batch_ok=True,
            workload=WorkloadConfig(key_dist="conflict", conflict_rate=c),
            clients=(40,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2, 3),
            duration=0.8, quick_duration=0.3))


# WAN at N in {25, 49, 101}: the three-region topology scaled up, with
# per-region relay groups (paper §5.3).
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
    register(Scenario(
        name=f"wan/N={n}/batch", protocol="pigpaxos", n=n,
        pig=PigConfig(n_groups=3, groups=groups, prc=1),
        topo=spec, backend="batch", batch_ok=True,
        leader_timeout=400e-3,
        clients=(40, 120), quick_clients=(40,),
        seeds=tuple(range(16)), quick_seeds=(0, 1, 2, 3),
        duration=2.0, quick_duration=0.8, warmup=0.5))

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
