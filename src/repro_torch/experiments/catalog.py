"""The port's scenario catalog: the reference's (``repro.experiments.
catalog``), copied with its specs and in its registration order — every
paper reproduction (Tables 1-2, Figs. 8-17) and the post-paper families,
all 187 of its scenarios.

The reference's ``Scenario`` defaults to ``backend="des"`` and the port's
to ``"batch"``, so every entry here is built through ``_scenario``, which
keeps the reference's default: the recorded specs equal the reference's.
Importing this module populates the registry."""
from __future__ import annotations

import math

from ..core.pig import PigConfig
from ..core.workload import WorkloadConfig
from ..faults.plan import (add_node, crash_window, remove_node,
                           replace_leader, rolling_restart, slow_window,
                           storm)
from .registry import register
from .scenario import Scenario


def _scenario(**kw) -> Scenario:
    """A scenario with the reference's default backend, ``"des"``."""
    return Scenario(**{"backend": "des", **kw})

# --------------------------------------------------------------- tables 1/2
# Analytical message-load tables, each validated against DES-measured
# per-node message counts at representative R (the asserts live in report.py).
# batch_ok: the batch backend reproduces the same per-node loads, so the
# Eq. 1-3 cross-check runs on either backend (--backend batch).
for r in (1, 3):
    register(_scenario(
        name=f"table1/validate/R={r}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=r), clients=(20,), seeds=(7,),
        duration=1.0, warmup=0.2, quick_duration=0.4,
        batch_ok=True, collect=("per_node_msgs",)))

for r in (1, 2):
    register(_scenario(
        name=f"table2/validate/R={r}", protocol="pigpaxos", n=5,
        pig=PigConfig(n_groups=r), clients=(20,), seeds=(7,),
        duration=1.0, warmup=0.2, quick_duration=0.4,
        batch_ok=True, collect=("per_node_msgs",)))

# ------------------------------------------------------------------- fig 8
# Max throughput vs number of relay groups, rotating vs static, 25 nodes.
for rotate in (True, False):
    for r in (1, 2, 3, 4, 5, 6, 8):
        register(_scenario(
            name=f"fig8/{'rotating' if rotate else 'static'}/R={r}",
            protocol="pigpaxos", n=25,
            pig=PigConfig(n_groups=r, prc=1, rotate_relays=rotate,
                          single_group_majority=(r == 1 and rotate)),
            clients=(20, 60, 120), quick_clients=(40, 120),
            duration=1.0, quick_duration=0.4, warmup=0.25,
            batch_ok=True, quick_skip=(r in (4, 6, 8))))

# Beyond the paper: the same relay-group sweep at N in {25, 49, 101} on the
# flattened fast engine (the paper's testbed stopped at 25 nodes).
for n in (25, 49, 101):
    for r in sorted({3, int(round(math.sqrt(n)))}):
        register(_scenario(
            name=f"fig8/scale/N={n}/R={r}", protocol="pigpaxos", n=n,
            pig=PigConfig(n_groups=r, prc=1), engine="fast",
            clients=(60, 120), quick_clients=(60,),
            duration=0.6, quick_duration=0.3, warmup=0.25,
            batch_ok=True))

# ------------------------------------------------------------------- fig 9
# Latency vs throughput curves, 25 nodes, Paxos vs EPaxos vs PigPaxos(R=3).
for proto, pig in (("paxos", None), ("epaxos", None),
                   ("pigpaxos", PigConfig(n_groups=3, prc=1))):
    register(_scenario(
        name=f"fig9/{proto}", protocol=proto, n=25, pig=pig,
        grid_mode="curve",
        clients=(5, 10, 20, 40, 80, 120), quick_clients=(10, 40, 120),
        duration=1.0, quick_duration=0.4))

# ------------------------------------------------------------------ fig 10
# 15-node WAN (Virginia/California/Oregon), per-region relay groups.
_WAN3 = {"kind": "wan", "nodes_per_region": [5, 5, 5],
         "oneway_ms": [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]}
_WAN3_GROUPS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]
for proto, pig in (("paxos", None),
                   ("pigpaxos", PigConfig(n_groups=3, groups=_WAN3_GROUPS, prc=1))):
    register(_scenario(
        name=f"fig10/{proto}", protocol=proto, n=15, pig=pig, topo=_WAN3,
        grid_mode="curve", leader_timeout=400e-3,
        clients=(10, 40, 120, 200), quick_clients=(20, 120),
        duration=2.0, quick_duration=0.8))

# ------------------------------------------------------------------ fig 11
# 5-node cluster: PigPaxos R=1 (single-relay majority) and R=2 vs baselines.
for label, proto, pig in (
        ("paxos", "paxos", None),
        ("epaxos", "epaxos", None),
        ("pig_R1", "pigpaxos", PigConfig(n_groups=1, single_group_majority=True)),
        ("pig_R2", "pigpaxos", PigConfig(n_groups=2))):
    register(_scenario(
        name=f"fig11/{label}", protocol=proto, n=5, pig=pig,
        clients=(20, 60, 120), quick_clients=(40, 120),
        duration=1.0, quick_duration=0.4, warmup=0.25))

# ------------------------------------------------------------------ fig 12
for label, proto, pig in (
        ("paxos", "paxos", None),
        ("pig_R2", "pigpaxos", PigConfig(n_groups=2, prc=1)),
        ("pig_R3", "pigpaxos", PigConfig(n_groups=3, prc=1))):
    register(_scenario(
        name=f"fig12/{label}", protocol=proto, n=9, pig=pig,
        clients=(20, 60, 120), quick_clients=(40, 120),
        duration=1.0, quick_duration=0.4, warmup=0.25))

# ------------------------------------------------------------------ fig 13
# Max throughput vs payload size, write-only workload.
for proto, pig in (("paxos", None), ("pigpaxos", PigConfig(n_groups=3, prc=1))):
    for size in (8, 64, 256, 512, 1024, 1280):
        register(_scenario(
            name=f"fig13/{proto}/payload={size}", protocol=proto, n=25, pig=pig,
            workload=WorkloadConfig(payload_bytes=size, write_fraction=1.0),
            clients=(60, 150), quick_clients=(120,),
            duration=1.0, quick_duration=0.4, warmup=0.25,
            quick_skip=(size not in (8, 256, 1280))))

# ------------------------------------------------------------------ fig 14
# Steady-state latency vs partial-response-collection level, fixed load.
# The paper's failure-section reproductions (figs 14-16) run with the
# linearizability auditor on: they are *checked* fault scenarios,
# not just latency plots.
for r in (1, 3):
    for prc in (0, 1, 2):
        register(_scenario(
            name=f"fig14/R={r}/PRC={prc}", protocol="pigpaxos", n=25,
            pig=PigConfig(n_groups=r, prc=prc, single_group_majority=False),
            audit=True, grid_mode="curve", clients=(18,),
            duration=2.0, quick_duration=0.6))

# ------------------------------------------------------------------ fig 15
# PRC x gray-list latency under one node failure; §4.2 group shape where
# the faulty group is required for majority.  The node-7 failure is a
# FaultPlan (open-ended crash window — the paper's node never returns).
_F15_GROUPS = [list(range(1, 14)), list(range(14, 25))]
for prc in (0, 1):
    for gray in (False, True):
        register(_scenario(
            name=f"fig15/PRC={prc}/gray={int(gray)}", protocol="pigpaxos",
            n=25,
            pig=PigConfig(n_groups=2, groups=_F15_GROUPS, prc=prc,
                          use_gray_list=gray),
            faults=crash_window(7, 0.1), audit=True,
            grid_mode="curve", clients=(30,), seeds=(5,),
            duration=2.0, quick_duration=0.8))
register(_scenario(
    name="fig15/fault_free", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=2, groups=_F15_GROUPS), audit=True,
    grid_mode="curve", clients=(30,), seeds=(5,),
    duration=2.0, quick_duration=0.8))

# ------------------------------------------------------------------ fig 16
# Throughput timeline with one of 3 relay groups partially crashed mid-run.
register(_scenario(
    name="fig16/group_failure", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=3, relay_timeout=50e-3),
    faults=(crash_window(3, 0.8) + crash_window(6, 0.8)
            + crash_window(9, 0.8)),
    audit=True, grid_mode="curve", clients=(60,), seeds=(9,),
    duration=3.0, quick_duration=1.2, warmup=0.3,
    collect=("timeline",)))

# ------------------------------------------------------------------ fig 17
# In-flight message heatmap, 9-node Paxos vs PigPaxos(R=3).
for proto, pig in (("paxos", None), ("pigpaxos", PigConfig(n_groups=3))):
    register(_scenario(
        name=f"fig17/{proto}", protocol=proto, n=9, pig=pig,
        grid_mode="curve", clients=(15,),
        duration=1.5, quick_duration=0.5,
        collect=("flight",)))

# ======================================================================
# Post-paper regimes (data-only entries over the generalized workload layer)
# ======================================================================

# Zipf-skewed PigPaxos: YCSB-style key popularity skew at N=25, R=3.  The
# paper only evaluates uniform keys; skew stresses nothing in Pig's relay
# layer (keys never route), so throughput should be flat across theta —
# a falsifiable no-op check the summarizer reports.  batch_ok because keys
# are performance-neutral in (Pig)Paxos — but note the batch backend makes
# the flatness exact by construction (it never samples keys), so the
# *falsifiable* version of this check is the DES run.
for theta in (0.6, 0.9, 0.99, 1.2):
    register(_scenario(
        name=f"zipf/pigpaxos/theta={theta}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=1),
        workload=WorkloadConfig(key_dist="zipfian", zipf_theta=theta),
        clients=(60,), seeds=(1, 2, 3),
        duration=0.8, quick_duration=0.3, batch_ok=True))
register(_scenario(
    name="zipf/pigpaxos/uniform", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=3, prc=1),
    workload=WorkloadConfig(key_dist="uniform"),
    clients=(60,), seeds=(1, 2, 3),
    duration=0.8, quick_duration=0.3, batch_ok=True))

# Open-loop Poisson fig9 variant: offered load fixed at clients x 100 req/s
# regardless of completion rate — latency blows up past saturation instead
# of the closed-loop self-throttling the paper's testbed had.
for proto, pig in (("paxos", None), ("epaxos", None),
                   ("pigpaxos", PigConfig(n_groups=3, prc=1))):
    register(_scenario(
        name=f"openloop/{proto}", protocol=proto, n=25, pig=pig,
        workload=WorkloadConfig(arrival="poisson", rate_hz=100.0),
        grid_mode="curve",
        clients=(10, 40, 80, 160), quick_clients=(10, 40),
        seeds=(2, 3), quick_seeds=(2,),
        duration=1.0, quick_duration=0.4))

# EPaxos conflict-rate sweeps at scale: hot-key probability c drives the
# dependency/interference rate; N=49 rides the fast engine (a regime the
# paper's 25-node testbed could not reach).  Each (N, c) point also runs on
# the batch backend (the vectorsim conflict/slow-path model): the
# whole grid is one jitted call, and the conflict summarizer emits a
# DES<->batch xcheck ratio per point that the regression gate bounds to
# [0.90, 1.10].
for n, engine in ((25, "exact"), (49, "fast")):
    for c in (0.0, 0.02, 0.1, 0.5):
        register(_scenario(
            name=f"conflict/N={n}/c={c}", protocol="epaxos", n=n,
            engine=engine, batch_ok=True,
            workload=WorkloadConfig(key_dist="conflict", conflict_rate=c),
            clients=(40,), seeds=(1, 2, 3), quick_seeds=(1, 2),
            duration=0.8, quick_duration=0.3))
        register(_scenario(
            name=f"conflict/N={n}/c={c}/batch", protocol="epaxos", n=n,
            backend="batch", batch_ok=True,
            workload=WorkloadConfig(key_dist="conflict", conflict_rate=c),
            clients=(40,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2, 3),
            duration=0.8, quick_duration=0.3))

# WAN sweeps at N in {25, 49, 101}: the fig10
# three-region topology scaled up, per-region relay groups (paper §5.3).
# Each size runs twice — on the fast DES engine and on the batch backend —
# so the wan summarizer doubles as a DES<->batch cross-check at WAN scale.


def _wan_scaled(n: int):
    """N nodes over 3 regions (fig10 latencies), per-region groups."""
    per = [n - 2 * (n // 3), n // 3, n // 3]
    spec = {"kind": "wan", "nodes_per_region": per,
            "oneway_ms": _WAN3["oneway_ms"]}
    bounds = [0, per[0], per[0] + per[1], n]
    groups = [list(range(bounds[i], bounds[i + 1])) for i in range(3)]
    return spec, groups


for n in (25, 49, 101):
    spec, groups = _wan_scaled(n)
    for backend in ("des", "batch"):
        register(_scenario(
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
# Batch-backend headroom: grids the DES cannot touch (one jitted call per
# scenario; N up to 1025 and hundreds of seed replicates per point).
# ======================================================================
for n, r, nseeds, qseeds in ((257, 16, 128, 8), (1025, 32, 24, 4)):
    register(_scenario(
        name=f"scale/batch/N={n}/R={r}", protocol="pigpaxos", n=n,
        pig=PigConfig(n_groups=r, prc=1), backend="batch", batch_ok=True,
        clients=(60, 120), quick_clients=(60,),
        seeds=tuple(range(nseeds)), quick_seeds=tuple(range(qseeds)),
        duration=0.5, quick_duration=0.25, warmup=0.25,
        quick_skip=(n == 1025)))
# the paper-grade relay-group sweep with hundreds of replicates per R:
# 7 R values x 3 client counts x 64 seeds = 1344 cells, one compiled call
# per scenario (~seconds each on the batch backend)
for r in (1, 2, 3, 5, 8, 12, 24):
    register(_scenario(
        name=f"scale/batch/replicates/R={r}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=r, prc=1,
                      single_group_majority=(r == 1)),
        backend="batch", batch_ok=True,
        clients=(20, 60, 120), quick_clients=(60,),
        seeds=tuple(range(64)), quick_seeds=tuple(range(8)),
        duration=0.5, quick_duration=0.25, warmup=0.25))

# ======================================================================
# Fault-injection families (repro.faults): declarative fault plans with
# the linearizability auditor on, extending the paper's failure section
# (figs 14-16) to full crash-RECOVER cycles and randomized storms.
# ======================================================================

# avail: availability under a leader (or relay) crash-recover window.
# Clients run with a request timeout so ops lost to the down node are
# re-sent (the replicas' at-most-once session dedup absorbs duplicates);
# the summarizer reports the unavailability window and throughput-dip
# depth from the completion timeline.  The N=25 variants also run on the
# batch backend (the plan is mask-expressible), giving a DES<->batch
# dip-depth cross-check the wan family's throughput xcheck can't see.
_AVAIL_WL = WorkloadConfig(request_timeout=25e-3)
_AVAIL_PLANS = {
    # node 0 is the (only) leader; recovery re-elects with a fresh ballot
    "leader": crash_window(0, 0.8, 1.2),
    # node 1 relays ~1/R of its group's rounds; node 2 is gray throughout
    # (the fig15 regime, but with recovery and the §4.2 gray list active);
    # the open-ended slow window (t1=inf) is the horizon-proof spelling of
    # "throughout" and stays mask-expressible under any duration change
    "relay": crash_window(1, 0.8, 1.2) + slow_window(2, extra_latency=2e-3),
}
for n in (25, 49):
    for role, plan in _AVAIL_PLANS.items():
        register(_scenario(
            name=f"avail/{role}/N={n}", protocol="pigpaxos", n=n,
            pig=PigConfig(n_groups=3, prc=1, use_gray_list=True),
            workload=_AVAIL_WL, faults=plan, audit=True,
            engine="exact" if n == 25 else "fast",
            grid_mode="curve", clients=(30,), seeds=(3,),
            duration=2.2, warmup=0.3, quick_duration=1.2,
            collect=("timeline",), batch_ok=True,
            quick_skip=(n == 49)))
for role, plan in _AVAIL_PLANS.items():
    register(_scenario(
        name=f"avail/{role}/N=25/batch", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=1, use_gray_list=True),
        workload=_AVAIL_WL, faults=plan, backend="batch", batch_ok=True,
        grid_mode="curve", clients=(30,), seeds=(3, 4, 5, 6),
        quick_seeds=(3, 4),
        duration=2.2, warmup=0.3, quick_duration=1.2,
        collect=("timeline",)))

# avail/epaxos: coordinator crash-recover with explicit-prepare instance
# recovery.  Node 2 is an opportunistic command leader for ~1/N
# of the offered load; while it is down its in-flight instances wedge their
# keys until peers run the explicit-prepare phase (probe timers fire two
# leader-timeouts after an execution stays blocked), so the dip heals and
# the audit stays green with NO hung clients — the pre-recovery protocol
# left those keys wedged forever.  DES-only: EPaxos faults have no batch
# mask lowering (the conflict model is fault-free).
for n in (25, 49):
    register(_scenario(
        name=f"avail/epaxos/N={n}", protocol="epaxos", n=n,
        workload=_AVAIL_WL, faults=crash_window(2, 0.8, 1.2), audit=True,
        engine="exact" if n == 25 else "fast",
        grid_mode="curve", clients=(30,), seeds=(3,),
        duration=2.2, warmup=0.3, quick_duration=1.2,
        collect=("timeline",), quick_skip=(n == 49)))

# storm: randomized crash-recover storms (seeded Poisson arrivals over the
# followers, Exp downtimes, concurrency-capped so a quorum can never be
# down at once), audit always on, at N the paper's testbed could not reach.
_STORM_WL = WorkloadConfig(request_timeout=25e-3)


def _storm_plan(n: int, seed: int, rate: float = 6.0):
    return storm(targets=tuple(range(1, n)), rate_hz=rate, t0=0.35, t1=1.3,
                 mean_downtime=0.15, seed=seed, max_concurrent=2)


for n in (25, 49, 101):
    register(_scenario(
        name=f"storm/pigpaxos/N={n}", protocol="pigpaxos", n=n,
        pig=PigConfig(n_groups=3 if n == 25 else int(round(math.sqrt(n))),
                      prc=1, use_gray_list=True),
        workload=_STORM_WL, faults=_storm_plan(n, seed=11), audit=True,
        engine="fast", clients=(30,), seeds=(1, 2), quick_seeds=(1,),
        duration=1.5, warmup=0.3, quick_duration=1.2,
        collect=("timeline",), quick_skip=(n == 49)))
register(_scenario(
    name="storm/paxos/N=25", protocol="paxos", n=25,
    workload=_STORM_WL, faults=_storm_plan(25, seed=13), audit=True,
    engine="fast", clients=(30,), seeds=(1, 2), quick_seeds=(1,),
    duration=1.5, warmup=0.3, quick_duration=1.2, collect=("timeline",)))
# EPaxos storms.  The original gentle variant (rate 2, one node at a time)
# predates instance recovery and is kept for trajectory continuity; the
# epaxos-recovery variant runs the SAME storm intensity as the pigpaxos
# one (rate 6, two concurrent crashes) — survivable only because crashed
# coordinators' in-flight instances now heal via explicit prepare.
register(_scenario(
    name="storm/epaxos/N=25", protocol="epaxos", n=25,
    workload=_STORM_WL,
    faults=storm(targets=tuple(range(25)), rate_hz=2.0, t0=0.35, t1=1.3,
                 mean_downtime=0.1, seed=17, max_concurrent=1),
    audit=True, engine="fast", clients=(30,), seeds=(1, 2), quick_seeds=(1,),
    duration=1.5, warmup=0.3, quick_duration=1.2, collect=("timeline",)))
register(_scenario(
    name="storm/epaxos-recovery/N=25", protocol="epaxos", n=25,
    workload=_STORM_WL,
    faults=storm(targets=tuple(range(25)), rate_hz=6.0, t0=0.35, t1=1.3,
                 mean_downtime=0.15, seed=19, max_concurrent=2),
    audit=True, engine="fast", clients=(30,), seeds=(1, 2), quick_seeds=(1,),
    duration=1.5, warmup=0.3, quick_duration=1.2, collect=("timeline",)))

# avail/prc: availability as a function of partial response collection:
# the SAME relay crash + gray-relay plan swept over PRC in {0, 1, 2} —
# §4.1 predicts PRC>=1 masks the crashed relay's group entirely (the
# leader proceeds on R-1 groups + partial responses) while PRC=0 waits out
# every relay timeout, so the unavailability window and dip depth should
# fall monotonically with PRC.
for prc in (0, 1, 2):
    register(_scenario(
        name=f"avail/prc/N=25/PRC={prc}", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=prc, use_gray_list=True),
        workload=_AVAIL_WL, faults=_AVAIL_PLANS["relay"], audit=True,
        engine="exact", grid_mode="curve", clients=(30,), seeds=(3,),
        duration=2.2, warmup=0.3, quick_duration=1.2,
        collect=("timeline",), quick_skip=(prc == 2)))

# ======================================================================
# Membership-change families: reconfiguration, rolling upgrades,
# and failover policies — all under the linearizability auditor, with the
# replica set treated as time-varying (audit durability = final members).
# ======================================================================

# reconfig: single-server membership changes under closed-loop load.
#   add     — a spare node (id N) joins from a leader snapshot + log
#             suffix, then an add_node command commits through the log;
#   remove  — follower N-1 is removed (quorums shrink mid-run);
#   replace — the LEADER is removed (leadership moves to the next member)
#             and a spare joins: a full node replacement;
#   handoff — planned leader handoff via a higher-ballot phase-1 (the
#             no-crash baseline for the failover family's windows).
_RC_WL = WorkloadConfig(request_timeout=25e-3)
_RC_PLANS = {
    "add": lambda n: (add_node(n, 0.8), 1),
    "remove": lambda n: (remove_node(n - 1, 0.8), 0),
    "replace": lambda n: (remove_node(0, 0.7) + add_node(n, 1.1), 1),
    "handoff": lambda n: (replace_leader(3, 0.8), 0),
}
for n in (25, 49):
    for kind, mk in _RC_PLANS.items():
        plan, spares = mk(n)
        register(_scenario(
            name=f"reconfig/{kind}/N={n}", protocol="pigpaxos", n=n,
            pig=PigConfig(n_groups=3, prc=1, use_gray_list=True),
            workload=_RC_WL, faults=plan, audit=True, spare_nodes=spares,
            engine="exact" if n == 25 else "fast",
            grid_mode="curve", clients=(30,), seeds=(3,),
            duration=2.2, warmup=0.3, quick_duration=1.2,
            collect=("timeline",),
            quick_skip=(n == 49 or kind == "handoff")))
# EPaxos membership change (leaderless): add a spare + remove a peer.
register(_scenario(
    name="reconfig/epaxos/N=25", protocol="epaxos", n=25,
    workload=_RC_WL, faults=add_node(25, 0.8) + remove_node(3, 1.3),
    audit=True, spare_nodes=1, engine="exact",
    grid_mode="curve", clients=(30,), seeds=(3,),
    duration=2.2, warmup=0.3, quick_duration=1.2,
    collect=("timeline",), quick_skip=True))

# rolling: restart every node in sequence (the rolling-upgrade model) with
# the auditor on.  At most one node is ever down (gap > downtime); the
# leader's own restart is the deep dip, follower restarts should barely
# register.  The per-restart unavailability windows land in the artifact
# (extras.per_fault_unavail_ms), one entry per node.
for proto, quick_skip in (("pigpaxos", False), ("epaxos", True)):
    register(_scenario(
        name=f"rolling/{proto}/N=25", protocol=proto, n=25,
        pig=PigConfig(n_groups=3, prc=1, use_gray_list=True)
        if proto == "pigpaxos" else None,
        workload=_RC_WL,
        faults=rolling_restart(tuple(range(25)), t0=0.45,
                               downtime=0.06, gap=0.14),
        audit=True, engine="fast", grid_mode="curve",
        clients=(30,), seeds=(3,),
        duration=4.0, warmup=0.3, quick_duration=4.0,
        collect=("timeline",), quick_skip=quick_skip))

# failover: the leader crashes at t=0.8 and NEVER recovers; recovery is
# entirely up to the external failover policy (runtime.FailoverPolicy),
# swept over its detection budget.  The measured unavailability window
# decomposes as crash->detect (the swept knob) + election + client retry,
# so unavail_ms should track detect_timeout nearly 1:1.
for detect_ms in (50, 100, 200):
    register(_scenario(
        name=f"failover/detect={detect_ms}ms", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=1),
        workload=_RC_WL, faults=crash_window(0, 0.8), audit=True,
        failover={"detect_timeout": detect_ms * 1e-3,
                  "check_interval": 0.01, "successor": "next"},
        engine="exact", grid_mode="curve", clients=(30,), seeds=(3,),
        duration=2.2, warmup=0.3, quick_duration=1.2,
        collect=("timeline",), quick_skip=(detect_ms == 200)))

# ======================================================================
# Leader-side batching + slot pipelining: closed-loop saturation
# sweeps with the leader packing up to m commands per slot — one phase-2
# fan-out/fan-in (and one Pig relay round) amortized over the batch.  The
# m=1 cells ARE the unbatched baselines (max_batch=1 flushes on first
# enqueue and proposes the bare command — byte-identical to the native
# path); the regression gate requires the m=8 paxos/N=25 cell to reach
# >= 2x its m=1 baseline.  For paxos/pigpaxos each m also runs on the
# batch backend (vectorsim's saturated-batch cost reparameterization) and
# the summarizer emits batch/des fidelity ratios the gate bounds to
# [0.90, 1.10]; batched EPaxos is DES-authoritative (leaderless batching
# has no group-kernel lowering).
# ======================================================================
for proto, pig in (("paxos", None),
                   ("pigpaxos", PigConfig(n_groups=3, prc=1)),
                   ("epaxos", None)):
    for m in (1, 4, 8):
        register(_scenario(
            name=f"batching/{proto}/m={m}", protocol=proto, n=25, pig=pig,
            engine="fast", batch={"max_batch": m, "max_delay_ms": 1.0},
            clients=(64,), seeds=(1, 2), quick_seeds=(1,),
            duration=0.6, warmup=0.3, quick_duration=0.3,
            quick_skip=(m == 4 and proto != "paxos")))
        if proto != "epaxos":
            register(_scenario(
                name=f"batching/{proto}/m={m}/batch", protocol=proto, n=25,
                pig=pig, backend="batch", batch_ok=True,
                batch={"max_batch": m, "max_delay_ms": 1.0},
                clients=(64,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2),
                duration=0.6, warmup=0.3, quick_duration=0.3,
                quick_skip=(m == 4 and proto != "paxos")))
# Slot pipelining: finite in-flight budgets (depth = max uncommitted
# proposals at the leader) under the same saturated load.  depth=0 is the
# protocol-native unbounded default (every other cell above); small finite
# depths trade throughput for bounded leader state — DES only (the batch
# backend's Lindley-chain leader FIFO pipelines implicitly).
for depth in (1, 2, 4):
    register(_scenario(
        name=f"batching/pipeline/depth={depth}", protocol="paxos", n=25,
        engine="fast", batch={"max_batch": 4, "max_delay_ms": 1.0},
        pipeline_depth=depth,
        clients=(64,), seeds=(1,),
        duration=0.6, warmup=0.3, quick_duration=0.3,
        quick_skip=(depth != 2)))

# ======================================================================
# Overload + admission control: open-loop arrivals pushed past
# saturation.  Unbatched paxos/N=25 saturates near ~2k req/s on this
# stack, so the clients grid at rate 100 Hz/client sweeps offered load
# from ~0.5x to ~4x saturation.  collect=("overload",) adds p99.9,
# goodput under the 50 ms SLO (runner.OVERLOAD_SLO_MS), the offered rate
# and every shed counter to each unit.  The paired noadm/adm cells are
# the family's headline claim (and a regression-gate section): WITHOUT
# admission control goodput collapses toward zero past saturation (every
# completion blows the SLO in the unbounded queue); WITH queue-length
# backpressure + token-bucket shedding goodput stays flat (+-10%) from
# 2x to 4x offered load.
# ======================================================================
_OVL_WL = dict(arrival="poisson", rate_hz=100.0, max_outstanding=32,
               reject_action="drop")
# token bucket at ~0.9x the unbatched saturation rate (the classic
# headroom rule: admit below capacity so the queue never builds), plus a
# queue-length guard for transients the bucket's burst lets through
_OVL_ADM = {"max_queue": 32, "rate_hz": 1800.0, "burst": 64.0}
for label, adm in (("noadm", None), ("adm", _OVL_ADM)):
    register(_scenario(
        name=f"overload/paxos/{label}", protocol="paxos", n=25,
        engine="fast", workload=WorkloadConfig(**_OVL_WL),
        admission=adm, grid_mode="curve", collect=("overload",),
        clients=(10, 20, 40, 80), quick_clients=(20, 80),
        seeds=(2,), duration=0.6, warmup=0.2, quick_duration=0.4))
# batching raises the saturation point: the same 4x offered load that
# floors the unbatched leader is absorbed outright with m=8 slots
register(_scenario(
    name="overload/paxos/adm+batch", protocol="paxos", n=25,
    engine="fast", workload=WorkloadConfig(**_OVL_WL),
    admission=_OVL_ADM, batch={"max_batch": 8, "max_delay_ms": 0.2},
    grid_mode="curve", collect=("overload",),
    clients=(20, 80), seeds=(2,),
    duration=0.6, warmup=0.2, quick_duration=0.4))
# bursty/diurnal traces: mean offered ~2x saturation with the bursty ON
# phase running 8x of that for 10% of each period (transient overload the
# token bucket's burst absorbs or sheds), and a diurnal peak at ~1.8x
for label, adm in (("bursty", None), ("bursty/adm", _OVL_ADM)):
    register(_scenario(
        name=f"overload/paxos/{label}", protocol="paxos", n=25,
        engine="fast",
        workload=WorkloadConfig(arrival="bursty", rate_hz=100.0,
                                max_outstanding=32, reject_action="drop",
                                burst_factor=8.0, burst_on=0.1,
                                burst_period=0.2),
        admission=adm, grid_mode="curve", collect=("overload",),
        clients=(40,), seeds=(2,),
        duration=0.6, warmup=0.2, quick_duration=0.4))
register(_scenario(
    name="overload/paxos/diurnal/adm", protocol="paxos", n=25,
    engine="fast",
    workload=WorkloadConfig(arrival="diurnal", rate_hz=100.0,
                            max_outstanding=32, reject_action="drop",
                            diurnal_period=0.4, diurnal_amp=0.8),
    admission=_OVL_ADM, grid_mode="curve", collect=("overload",),
    clients=(40,), seeds=(2,),
    duration=0.6, warmup=0.2, quick_duration=0.4, quick_skip=True))
# latency-driven admission: shed on the observed p99 EWMA
# against the same 50 ms SLO the goodput metric uses, head-to-head with
# the queue-length policy above — the latadm_summary row compares
# goodput and shed volume at 4x offered load
register(_scenario(
    name="overload/paxos/latadm", protocol="paxos", n=25,
    engine="fast", workload=WorkloadConfig(**_OVL_WL),
    admission={"slo_ms": 50.0, "check_interval": 0.005},
    grid_mode="curve", collect=("overload",),
    clients=(10, 20, 40, 80), quick_clients=(20, 80),
    seeds=(2,), duration=0.6, warmup=0.2, quick_duration=0.4))
# the family generalizes past plain paxos: Pig relays under overload
register(_scenario(
    name="overload/pigpaxos/adm", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=3, prc=1), engine="fast",
    workload=WorkloadConfig(**_OVL_WL),
    admission=_OVL_ADM, grid_mode="curve", collect=("overload",),
    clients=(20, 80), seeds=(2,),
    duration=0.6, warmup=0.2, quick_duration=0.4, quick_skip=True))
# audited overload smoke (the CI cells): one admission cell and one
# batched+admission cell with the linearizability auditor on — shedding,
# bounce-retry loops and batch slots must not cost consistency
register(_scenario(
    name="overload/audit/adm", protocol="paxos", n=25,
    engine="fast", workload=WorkloadConfig(**_OVL_WL),
    admission=_OVL_ADM, audit=True, grid_mode="curve",
    collect=("overload",), clients=(40,), seeds=(2,),
    duration=0.5, warmup=0.2, quick_duration=0.4))
register(_scenario(
    name="overload/audit/adm+batch", protocol="paxos", n=25,
    engine="fast", workload=WorkloadConfig(**_OVL_WL),
    admission=_OVL_ADM, batch={"max_batch": 8, "max_delay_ms": 0.2},
    audit=True, grid_mode="curve",
    collect=("overload",), clients=(40,), seeds=(2,),
    duration=0.5, warmup=0.2, quick_duration=0.4))

# ======================================================================
# Observability: traced cells for all three protocols (per-op
# span trees -> critical-path decomposition in the artifact's obs extras),
# the relay-fairness pair (rotating vs static relays, fig8-style, with the
# per-follower busy-seconds the fairness summarizer turns into max/mean +
# Gini — the paper's 'rotation spreads relay load' claim as a number), and
# a batch-backend cell carrying the leader-backlog timeline.
# ======================================================================
_OBS_FULL = {"sample_rate": 0.1, "metrics_dt": 0.01, "perfetto_limit": 2000}
for proto, pig, qskip in (
        ("pigpaxos", PigConfig(n_groups=5, prc=1), False),
        ("paxos", None, False),
        ("epaxos", None, True)):
    register(_scenario(
        name=f"obs/{proto}/traced", protocol=proto, n=25, pig=pig,
        obs=_OBS_FULL, clients=(40,), seeds=(2,),
        duration=0.6, warmup=0.25, quick_duration=0.3,
        quick_skip=qskip))
# fairness pair: same seed/load/groups, only relay rotation differs; the
# fast engine's busy accounting is enough (no span tracing needed), so
# sample_rate=0 keeps the cells cheap while metrics_dt still samples the
# utilization timelines the heat-strip plot renders
for rotate in (True, False):
    register(_scenario(
        name=f"obs/fairness/{'rotating' if rotate else 'static'}",
        protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=5, prc=1, rotate_relays=rotate),
        engine="fast", obs={"sample_rate": 0.0, "metrics_dt": 0.01},
        clients=(40,), seeds=(7,),
        duration=0.6, warmup=0.25, quick_duration=0.3))
register(_scenario(
    name="obs/pigpaxos/backlog/batch", protocol="pigpaxos", n=25,
    pig=PigConfig(n_groups=5, prc=1), backend="batch", batch_ok=True,
    obs={"sample_rate": 0.0}, clients=(40,), seeds=(1, 2, 3, 4),
    quick_seeds=(1, 2), duration=0.6, warmup=0.25, quick_duration=0.3))

# ======================================================================
# megagrid slices: registry-visible samples of the million-cell
# cross-product study (experiments.megagrid).  The full run streams
# through vectorsim.simulate_grid_sharded from the CLI; these four
# points keep the family in the registry (summarizer, nightly gate) and
# cross-check the study's axes against the standard runner path.
# ======================================================================
for n, r, prc, wan in ((9, 2, 1, False), (9, 2, 1, True),
                       (25, 4, 0, False), (25, 4, 2, True)):
    spec = _wan_scaled(n)[0] if wan else None
    register(_scenario(
        name=f"megagrid/slice/N={n}/R={r}/PRC={prc}/"
             + ("wan3" if wan else "lan"),
        protocol="pigpaxos", n=n, pig=PigConfig(n_groups=r, prc=prc),
        topo=spec, backend="batch", batch_ok=True,
        leader_timeout=400e-3 if wan else 50e-3,
        clients=(4, 16), quick_clients=(4,),
        seeds=tuple(range(16)), quick_seeds=(0, 1, 2, 3),
        duration=0.1, quick_duration=0.1, warmup=0.05,
        quick_skip=(n == 25 and prc == 2)))

# ======================================================================
# Read paths: leader leases + quorum reads under read-heavy
# closed-loop traffic, every DES cell under the read-aware auditor
# (stale / phantom / inverted non-logged reads are hard violations).
#
#   reads/*/lease/r=R   — quorum-granted leader lease, leader serves gets
#                         locally (no log round); r sweeps the crossover:
#                         at r=0 Pig's relay fan-out beats Paxos on write
#                         throughput, at r=0.9 the lease path collapses
#                         both protocols onto the leader and plain Paxos
#                         catches back up — the crossover summarizer row.
#   reads/*/log/r=0.9   — the same read mix through the replicated log
#                         (the paper's only read path): the speedup
#                         denominator for the >= 2x leased-read gate.
#   reads/*/quorum, /subgroup — client-side quorum reads (PQR-style
#                         probe + rinse): a random majority on paxos /
#                         epaxos, the geo-closest relay subgroup + leader
#                         on pigpaxos ("subgroup").
#   reads/wan/*         — the fig10 three-region WAN: geo-routed subgroup
#                         probes answer from the client's region while
#                         random-majority probes pay cross-region RTTs.
# The paxos lease/log r=0.9 cells also run on the batch backend
# (vectorsim's leased-read Lindley model) — the reads summarizer emits
# DES<->batch fidelity ratios the regression gate bounds to [0.90, 1.10].
# ======================================================================
_LEASE = {"duration_ms": 200.0}
for proto, pig in (("paxos", None), ("pigpaxos", PigConfig(n_groups=3, prc=1))):
    for r in (0.0, 0.5, 0.9):
        register(_scenario(
            name=f"reads/{proto}/lease/r={r}", protocol=proto, n=25,
            pig=pig,
            workload=WorkloadConfig(read_ratio=r, read_path="lease"),
            lease=_LEASE, audit=True,
            clients=(60,), seeds=(1, 2), quick_seeds=(1,),
            duration=0.6, warmup=0.3, quick_duration=0.3))
    register(_scenario(
        name=f"reads/{proto}/log/r=0.9", protocol=proto, n=25, pig=pig,
        workload=WorkloadConfig(read_ratio=0.9, read_path="log"),
        audit=True, clients=(60,), seeds=(1, 2), quick_seeds=(1,),
        duration=0.6, warmup=0.3, quick_duration=0.3))
for path in ("lease", "log"):
    register(_scenario(
        name=f"reads/paxos/{path}/r=0.9/batch", protocol="paxos", n=25,
        backend="batch", batch_ok=True,
        workload=WorkloadConfig(read_ratio=0.9, read_path=path),
        lease=_LEASE if path == "lease" else None,
        clients=(60,), seeds=tuple(range(1, 9)), quick_seeds=(1, 2),
        duration=0.6, warmup=0.3, quick_duration=0.3))
for proto, pig, label in (
        ("paxos", None, "quorum"),
        ("epaxos", None, "quorum"),
        ("pigpaxos", PigConfig(n_groups=3, prc=1), "subgroup")):
    register(_scenario(
        name=f"reads/{proto}/{label}/r=0.9", protocol=proto, n=25, pig=pig,
        workload=WorkloadConfig(read_ratio=0.9, read_path="quorum"),
        audit=True, clients=(60,), seeds=(1, 2), quick_seeds=(1,),
        duration=0.6, warmup=0.3, quick_duration=0.3))
for proto, pig in (
        ("pigpaxos", PigConfig(n_groups=3, groups=_WAN3_GROUPS, prc=1)),
        ("paxos", None)):
    register(_scenario(
        name=f"reads/wan/{proto}/quorum", protocol=proto, n=15, pig=pig,
        topo=_WAN3, leader_timeout=400e-3,
        workload=WorkloadConfig(read_ratio=0.9, read_path="quorum"),
        audit=True, grid_mode="curve", clients=(30,), seeds=(2,),
        duration=1.5, warmup=0.4, quick_duration=0.8,
        quick_skip=(proto == "paxos")))

# lease: expiry/failover availability windows.  The leader crashes at
# t=0.8 and never recovers; the failover policy elects a successor, but
# follower lease PROMISES block the new leader's phase 1 until the old
# lease drains — so the measured unavailability window must grow with the
# lease duration (the safety/availability trade every lease system makes).
# The auditor stays on: no read served across the failover may be stale.
_LEASE_FO = {"detect_timeout": 0.05, "check_interval": 0.01,
             "successor": "next"}
for d in (50, 400):
    register(_scenario(
        name=f"lease/expiry/d={d}ms", protocol="pigpaxos", n=25,
        pig=PigConfig(n_groups=3, prc=1),
        workload=WorkloadConfig(read_ratio=0.5, read_path="lease",
                                request_timeout=25e-3),
        lease={"duration_ms": float(d)},
        faults=crash_window(0, 0.8), audit=True, failover=_LEASE_FO,
        grid_mode="curve", clients=(30,), seeds=(3,),
        duration=2.2, warmup=0.3, quick_duration=1.2,
        collect=("timeline",)))
