"""The group kernel's optional branches against the JAX reference, on the
CPU: WAN region gathers, leader batching (``batch_m``), fault masks,
leased reads and the obs leader-backlog series.

Both sides draw the same threefry bits, so parity is per cell (see
``test_torch_vectorsim.py`` for why the two still round apart in the
last bit).  Tolerance: counts within one request at the window edges,
latency percentiles rel 1e-5, message loads abs 1e-6, timeline counts
within one per bucket, the backlog means rel 1e-5 (sample counts equal)
and the read/write split's counts within one and means rel 1e-5 -- or,
where it is larger, the reference's own envelope, measured here by
running the reference again with its jitter one f32 ulp up and one down
(a percentile can step to the next sample under a last-bit change).
Measured worst: counts, loads, timelines, backlog series and read/write
counts equal; percentiles 1.238e-5 (``avail/relay``, 60 clients), 1.018e-5
(``batching/paxos/m=8``), 9.7e-6 and 7.7e-6 elsewhere, each equal to the
reference's own one-ulp move at that cell; every other cell 1.9e-6 or
less, the read/write means 1.3e-7.

The cells are the scenarios' own shapes at short windows and loads where
the model damps last-bit differences.  The fault cells run the avail
plans' two shapes (a leader crash-recover window; a relay crash-recover
window plus a node slow throughout) moved to early windows, so that the
whole down-window falls inside a short run; at the avail scenarios' own
30 clients the model amplifies last-bit differences (chaotic: the
reference moves by up to 100 requests of 9638 under a one-ulp jitter
change), which ``chip_smoke.py`` reads on the card instead.
"""
import dataclasses

import jax  # noqa: F401  (the reference below runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from repro.core import PigConfig as RefPig
from repro.core import WorkloadConfig as RefWorkload
from repro.core import vectorsim as rvs
from repro.core import wan_topology as ref_wan
from repro.faults import plan as rplan
from repro_torch.core import vectorsim as tvs
from repro_torch.core.network import wan_topology
from repro_torch.core.pig import PigConfig
from repro_torch.core.workload import WorkloadConfig
from repro_torch.faults import plan as tplan

torch.set_num_threads(1)

W3 = [[0.15, 31, 35], [31, 0.15, 11], [35, 11, 0.15]]


def _wan(n):
    per = [n - 2 * (n // 3), n // 3, n // 3]
    bounds = [0, per[0], per[0] + per[1], n]
    groups = [list(range(bounds[i], bounds[i + 1])) for i in range(3)]
    return per, groups


def _deployment(branch):
    """(protocol, n, reference kwargs, port kwargs) of one branch's
    ``build_config`` call."""
    if branch.startswith("wan"):
        n = int(branch.split("=")[1])
        per, groups = _wan(n)
        return ("pigpaxos", n,
                dict(pig=RefPig(n_groups=3, groups=groups, prc=1),
                     topo=ref_wan(per, W3)),
                dict(pig=PigConfig(n_groups=3, groups=groups, prc=1),
                     topo=wan_topology(per, W3)))
    if branch.startswith("batching"):
        proto, m = branch.split("/")[1:]
        m = int(m.split("=")[1])
        if proto == "paxos":
            return "paxos", 25, dict(batch_m=m), dict(batch_m=m)
        return ("pigpaxos", 25,
                dict(pig=RefPig(n_groups=3, prc=1), batch_m=m),
                dict(pig=PigConfig(n_groups=3, prc=1), batch_m=m))
    if branch.startswith("avail"):
        role = branch.split("/")[1]
        # the avail plans' shapes, in windows a short run spans
        plans = {
            "leader": lambda p: p.crash_window(0, 0.3, 0.45),
            "relay": lambda p: (p.crash_window(1, 0.3, 0.45)
                                + p.slow_window(2, extra_latency=2e-3)),
        }[role]
        masks = plans(rplan).to_masks(25, 1.3)
        assert all(np.array_equal(v, plans(tplan).to_masks(25, 1.3)[k])
                   for k, v in masks.items())
        return ("pigpaxos", 25,
                dict(pig=RefPig(n_groups=3, prc=1, use_gray_list=True),
                     workload=RefWorkload(request_timeout=25e-3),
                     masks=masks),
                dict(pig=PigConfig(n_groups=3, prc=1, use_gray_list=True),
                     workload=WorkloadConfig(request_timeout=25e-3),
                     masks=masks))
    if branch.startswith("reads"):
        path = branch.split("/")[1]
        return ("paxos", 25,
                dict(workload=RefWorkload(read_ratio=0.9, read_path=path)),
                dict(workload=WorkloadConfig(read_ratio=0.9,
                                             read_path=path)))
    assert branch == "obs"
    return ("pigpaxos", 25, dict(pig=RefPig(n_groups=5, prc=1)),
            dict(pig=PigConfig(n_groups=5, prc=1)))


BRANCHES = ["wan/N=25", "wan/N=49", "wan/N=101", "batching/paxos/m=8",
            "batching/pigpaxos/m=4", "avail/leader", "avail/relay",
            "reads/lease", "reads/log", "obs"]


# ------------------------------------------------- (a) host lowering
@pytest.mark.parametrize("branch", BRANCHES)
def test_build_config_and_stacked_cells_equal_reference(branch):
    proto, n, rkw, tkw = _deployment(branch)
    rc = rvs.build_config(proto, n, **rkw)
    tc = tvs.build_config(proto, n, **tkw)
    for f in ("kind", "n", "static_relay", "majority", "jitter", "costs",
              "label", "read_ratio"):
        assert getattr(tc, f) == getattr(rc, f), f
    for f in ("members", "sizes", "thresh", "region_of", "region_latency",
              "down", "slow"):
        a, b = getattr(tc, f), getattr(rc, f)
        assert (a is None) == (b is None), f
        assert a is None or np.array_equal(a, b), f
    grid = [(0, 20, 0), (0, 64, 3)]
    assert tvs._pad_spec([tc], grid) == rvs._pad_spec([rc], grid)
    rb, rk, rkmax = rvs._stack_cells([rc], grid, 0.5, 0.25)
    tb, tk, tkmax = tvs._stack_cells([tc], grid, 0.5, 0.25)
    assert (tk, tkmax) == (rk, rkmax) and sorted(tb) == sorted(rb)
    for k in rb:
        assert tb[k].dtype == rb[k].dtype, k
        assert np.array_equal(tb[k], rb[k]), k
    for k in (8, 20, 64):
        assert tvs._estimate_rate(tc, k) == rvs._estimate_rate(rc, k)


def test_mixed_lan_wan_grid_pads_like_reference():
    """A LAN cell beside WAN cells of two sizes and a faulty cell: the
    region matrices, down-windows and slot layouts pad alike."""
    per, groups = _wan(49)
    masks = rplan.crash_window(3, 0.1, 0.2).to_masks(25, 1.0)
    rcs = [rvs.build_config("pigpaxos", 25, pig=RefPig(n_groups=3)),
           rvs.build_config("pigpaxos", 49,
                            pig=RefPig(n_groups=3, groups=groups, prc=1),
                            topo=ref_wan(per, W3)),
           rvs.build_config("pigpaxos", 25, pig=RefPig(n_groups=3, prc=1),
                            masks=masks)]
    tcs = [tvs.build_config("pigpaxos", 25, pig=PigConfig(n_groups=3)),
           tvs.build_config("pigpaxos", 49,
                            pig=PigConfig(n_groups=3, groups=groups, prc=1),
                            topo=wan_topology(per, W3)),
           tvs.build_config("pigpaxos", 25, pig=PigConfig(n_groups=3, prc=1),
                            masks=masks)]
    grid = [(0, 8, 1), (1, 4, 2), (2, 6, 0)]
    rb = rvs._stack_cells(rcs, grid, 0.2, 0.1)[0]
    tb = tvs._stack_cells(tcs, grid, 0.2, 0.1)[0]
    assert sorted(tb) == sorted(rb)
    for k in rb:
        assert np.array_equal(tb[k], rb[k]), k
    assert tb["reg_lat"].shape == (3, 3, 3) and tb["downF"].shape[1] == 48


# ----------------------------------------- (b) per-cell scenario parity
CELLS = [
    # (branch, clients, seeds, duration, warmup)
    ("wan/N=25", (40, 120), (0, 1), 0.3, 0.2),
    ("wan/N=49", (40,), (0, 1), 0.3, 0.2),
    ("wan/N=101", (40,), (0,), 0.3, 0.2),
    ("batching/paxos/m=8", (64,), (1, 2), 0.2, 0.1),
    ("batching/pigpaxos/m=4", (128,), (1, 2), 0.2, 0.1),
    ("avail/leader", (60, 120), (3,), 0.6, 0.2),
    ("avail/relay", (60, 120), (4,), 0.6, 0.2),
    ("reads/lease", (60,), (1, 2), 0.2, 0.1),
    ("reads/log", (60,), (1, 2), 0.2, 0.1),
    ("obs", (40,), (1, 2), 0.2, 0.1),
]


def _moved_jitter(rkw, n, to):
    """The reference's kwargs with the link jitter one f32 ulp up or down
    (through the topology, which carries it)."""
    from repro.core.network import Topology as RefTopology
    topo = rkw.get("topo") or RefTopology(n=n)
    j = np.nextafter(np.float32(topo.jitter), np.float32(to))
    return dict(rkw, topo=dataclasses.replace(topo, jitter=float(j)))


LAT_MS = ("median_ms", "p25_ms", "p75_ms", "p99_ms")


def _diff(a_units, b_units, m):
    """Worst per-cell differences between two unit lists: counts in
    kernel requests (units scale them by m), latency percentiles and
    means relative, message loads absolute, and the branch records."""
    d = {"count": 0, "lat": 0.0, "msg": 0.0}
    for a, b in zip(a_units, b_units):
        assert (a["clients"], a["seed"]) == (b["clients"], b["seed"])
        d["count"] = max(d["count"], abs(a["count"] - b["count"]) // m,
                         abs(a["committed"] - b["committed"]) // m)
        d["lat"] = max([d["lat"]] + [abs(a[k] / b[k] - 1.0) for k in LAT_MS])
        d["msg"] = max([d["msg"]] + [
            abs(a[k] - b[k]) for k in ("leader_msgs_per_op",
                                       "follower_msgs_per_op")])
        if "timeline" in a:
            d["timeline"] = max(d.get("timeline", 0), int(np.abs(np.subtract(
                a["timeline"]["counts"], b["timeline"]["counts"])).max()))
        if "obs" in a:
            ra, rb = a["obs"]["leader_backlog"], b["obs"]["leader_backlog"]
            d["backlog_n"] = max(d.get("backlog_n", 0), int(np.abs(
                np.subtract(ra["n"], rb["n"])).max()))
            x, y = np.array(ra["mean_ms"]), np.array(rb["mean_ms"])
            d["backlog"] = max(d.get("backlog", 0.0), float(np.max(
                np.abs(x - y) / np.maximum(np.abs(x), 1e-3))))
        if "rw" in a:
            ra, rb = a["rw"], b["rw"]
            d["rw_count"] = max([d.get("rw_count", 0)] + [
                abs(ra[k] - rb[k]) for k in ("reads", "writes")])
            d["rw"] = max([d.get("rw", 0.0)] + [
                abs(ra[k] / rb[k] - 1.0)
                for k in ("read_mean_ms", "write_mean_ms", "read_p99_ms")])
    return d


STRICT = {"count": 1, "lat": 1e-5, "msg": 1e-6, "timeline": 1,
          "backlog_n": 0, "backlog": 1e-5, "rw_count": 1, "rw": 1e-5}


@pytest.mark.parametrize("branch,clients,seeds,dur,warm", CELLS,
                         ids=[c[0] for c in CELLS])
def test_branch_matches_reference(branch, clients, seeds, dur, warm):
    """``simulate_scenario`` per cell, unit fields and branch records
    (the x m and / m scalings, ``lat_adj``, timeline, obs, rw)."""
    proto, n, rkw, tkw = _deployment(branch)
    m = rkw.get("batch_m", 1)
    kw = dict(clients=clients, seeds=seeds, duration=dur, warmup=warm,
              obs=branch == "obs")
    want = rvs.simulate_scenario(proto, n, kernel="lax", **rkw, **kw)
    got = tvs.simulate_scenario(proto, n, device="cpu", **tkw, **kw)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        assert a["exhausted"] == b["exhausted"] is False
        assert a["retry_risk"] == b["retry_risk"]
        assert b["count"] > 0
        for rec in ("timeline", "obs"):
            if rec in a:
                ra, rb = a[rec], b[rec]
                ra, rb = ra.get("leader_backlog", ra), rb.get(
                    "leader_backlog", rb)
                assert ra["bucket_s"] == rb["bucket_s"] == 0.05
    # the reference's own envelope: its jitter one f32 ulp up and down
    tol = dict(STRICT)
    for to in (1.0, 0.0):
        moved = rvs.simulate_scenario(proto, n, kernel="lax",
                                      **_moved_jitter(rkw, n, to), **kw)
        for k, v in _diff(want, moved, m).items():
            tol[k] = max(tol[k], v)
    worst = _diff(want, got, m)
    assert all(worst[k] <= tol[k] for k in worst), (worst, tol)
    # the branch's own outputs are there
    u = got[0]
    if branch.startswith("avail"):
        assert len(u["timeline"]["counts"]) == int(np.ceil(
            (warm + dur + 0.2) / 0.05)) + 1
        assert sum(u["timeline"]["counts"]) > 0
    if branch == "obs":
        assert sum(u["obs"]["leader_backlog"]["n"]) > 0
    if branch == "reads/lease":
        assert all(v["rw"]["reads"] > 4 * v["rw"]["writes"] for v in got)
        assert all(v["rw"]["read_mean_ms"] < v["rw"]["write_mean_ms"]
                   for v in got)


def test_batch_m_needs_divisible_clients():
    with pytest.raises(ValueError) as want:
        rvs.simulate_scenario("paxos", 25, batch_m=4, clients=(30,))
    with pytest.raises(ValueError) as got:
        tvs.simulate_scenario("paxos", 25, batch_m=4, clients=(30,),
                              device="cpu")
    assert str(got.value) == str(want.value)


# --------------------------------- (c) the backlog sum with reads
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_follower_work_is_exact_for_any_active_set(seed):
    """The count-based backlog sum equals the reference's order of
    operations -- the burst's peer work summed request by request, then
    its relay work scattered request by request -- bit for bit, when the
    requests that touch the followers are not a prefix of the burst (leased
    reads take theirs out)."""
    rng = np.random.default_rng(seed)
    C, B, F, G = 3, 8, 24, 3
    sizes = np.array([8, 8, 8])
    grp = np.repeat(np.arange(G), sizes)
    act = rng.uniform(size=(C, B)) < 0.6              # not a prefix
    j_rel = rng.integers(0, 8, (C, B, G))
    is_relay = (np.arange(F) % 8)[None, None, :] == np.take_along_axis(
        j_rel, np.broadcast_to(grp, (C, B, F)), axis=2)
    peer_mask = ~is_relay
    w_peer = rng.uniform(1e-5, 3e-5, C).astype(np.float32)
    relay_work = rng.uniform(1e-4, 3e-4, (C, G)).astype(np.float32)
    # the reference's order: where(act & peer, w_peer, 0).sum(axis=0),
    # then .at[rel_idx].add(relay_work) over (b, g) in order
    want = np.zeros((C, F), np.float32)
    for c in range(C):
        for f in range(F):
            acc = np.float32(0.0)
            for b in range(B):
                acc = np.float32(acc + (w_peer[c] if act[c, b]
                                        and peer_mask[c, b, f] else 0.0))
            want[c, f] = acc
        for b in range(B):
            for g in range(G):
                if act[c, b]:
                    f = g * 8 + j_rel[c, b, g]
                    want[c, f] = np.float32(want[c, f] + relay_work[c, g])
    t = torch.from_numpy
    got = tvs._follower_work(
        t(act)[:, :, None], t(peer_mask), t(is_relay), t(w_peer),
        t(relay_work)[:, grp])
    assert np.array_equal(got.numpy(), want)
