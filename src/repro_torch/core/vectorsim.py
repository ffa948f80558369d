"""Batched round-level simulation backend, group kernel (port of
``repro.core.vectorsim``).

The per-request message flow of Paxos / PigPaxos is pure array math: a
step loop over request bursts, with every grid cell on one leading axis,
so a whole clients x seeds grid advances together on the device.  The
model is the reference's, line for line (see its module docstring):
closed-loop client credit, a Lindley-chain leader FIFO over each burst,
rotating relay choice, fluid follower backlogs with an M/D/1 floor, the
relay reply fan-in order statistic (the ``seg_fanin`` kernel) and the
aggregate quorum at the leader.

Translation from the JAX reference:

* ``vmap`` over cells -> an explicit leading cell axis ``C``;
* ``lax.scan`` -> a Python loop over scan steps, outputs written into
  preallocated (C, steps, B) tensors;
* ``jax.random`` -> ``repro_torch.prng`` (the same threefry bits);
* ``lax.top_k(-ready, B)`` -> the first B of a stable ascending sort;
* scatter-adds -> dense per-slot masks, accumulated row by row in the
  reference's order (no float atomics, so the same key gives the same
  output on the card too).

This slice carries the LAN, fault-free, write-path, ``batch_m=1`` group
kernel.  ``build_config`` raises ``NotImplementedError`` for the rest
(WAN, fault masks, reads, leader batching, EPaxos, obs), naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..convert import cells_from_numpy
from ..device import resolve_device
from ..kernels import ops, ref
from .messages import HEADER_BYTES, CostModel
from .pig import partition_followers, required_per_group
from .quorums import fast_quorum, majority

# measurement harness constants — identical to the reference
_DRAIN_S = 0.2          # post-stop drain window (Cluster.measure)
_CLIENT_START = 20e-3   # Cluster.add_clients start_at
_CLIENT_STAGGER = 1e-4  # per-client start stagger

_MAX_STEPS = 400_000    # hard cap for the exhausted-retry loop
# random draws are made for a block of scan steps at once (the draws of
# step i depend only on the cell key and i); the block holds at most this
# many elements, which bounds the threefry intermediates' memory
_DRAW_BLOCK_ELEMS = 1 << 21

KERNELS = ("auto", "torch")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, "
        f"{item}); run it on the JAX reference, repro.core.vectorsim")


# ===================================================================== config
@dataclasses.dataclass
class SimConfig:
    """One protocol deployment, lowered to arrays (leader = node 0)."""
    kind: str
    n: int
    members: np.ndarray        # (r, g) follower node ids, -1 padding
    sizes: np.ndarray          # (r,) group sizes (0 = padded group)
    thresh: np.ndarray         # (r,) relay flush threshold incl. the relay
    static_relay: bool
    majority: int
    region_of: np.ndarray      # (n,) region per node (all 0 for LAN)
    region_latency: np.ndarray  # (1, 1) one-way base seconds
    jitter: float
    costs: Dict[str, float]    # c_req/c_fanout/c_rel/c_repl/c_agg/c_replycl
    label: str = ""

    @property
    def rmax(self) -> int:
        return self.members.shape[0]


def _expected_wires(workload) -> Dict[str, float]:
    """Expected wire sizes per message role (costs are linear in bytes, so
    using the expectation is exact for mean CPU load)."""
    wf = 0.5
    payload = 8.0
    if workload is not None:
        wf = float(workload.write_fraction)
        if getattr(workload, "read_ratio", None) is not None:
            wf = 1.0 - float(workload.read_ratio)
        if workload.payload_choices:
            w = np.asarray(workload.payload_weights
                           or [1.0] * len(workload.payload_choices), float)
            sizes = np.asarray([float(s) for s in workload.payload_choices])
            payload = float((sizes * w / w.sum()).sum())
        else:
            payload = float(workload.payload_bytes)
    cmd = 16.0 + wf * payload                      # Command.wire_size
    return {
        "req": HEADER_BYTES + cmd,                 # ClientRequest
        "p2a": HEADER_BYTES + 16 + cmd,            # P2a
        "p2b": float(HEADER_BYTES),                # P2b
        # gets return the stored value (= a put payload); puts return None
        "reply_cl": HEADER_BYTES + 8 + (1.0 - wf) * payload,
        "cmd": cmd,
    }


def build_config(protocol: str, n: int, pig=None, topo=None, workload=None,
                 cost: Optional[CostModel] = None, label: str = "",
                 masks: Optional[Dict[str, np.ndarray]] = None,
                 batch_m: int = 1) -> SimConfig:
    """Lower a (protocol, n, PigConfig, Topology, workload) deployment to
    the array form the group kernel consumes.  The reference's boundary
    ``ValueError``s keep their wording; what this slice does not carry yet
    raises ``NotImplementedError``."""
    cm = cost or CostModel()
    base, pb = cm.base, cm.per_byte
    w = _expected_wires(workload)
    if workload is not None and getattr(workload, "arrival", "closed") != "closed":
        raise ValueError("batch backend models closed-loop clients only")
    if batch_m < 1:
        raise ValueError("batch_m must be >= 1")
    if batch_m > 1 and protocol == "epaxos":
        raise ValueError("batch-backend batching is group-kernel only; "
                         "batched EPaxos runs are DES-authoritative "
                         "(leaderless per-node buffers interact with the "
                         "conflict model)")
    rr = (getattr(workload, "read_ratio", None)
          if workload is not None else None)
    rpath = (getattr(workload, "read_path", "log")
             if workload is not None else "log")
    if rr is not None and float(rr) > 0.0:
        if rpath == "quorum":
            raise ValueError(
                "batch backend models log and leased leader reads only; "
                "quorum reads (probe / rinse / re-probe rounds) have no "
                "array form — quorum-read scenarios are DES-authoritative")
        if rpath == "lease":
            if protocol == "epaxos":
                raise ValueError(
                    "leased reads are group-kernel only: epaxos is "
                    "leaderless (no leader lease to serve reads under) — "
                    "epaxos read scenarios need the DES quorum-read path")
            if masks is not None:
                raise ValueError(
                    "leased reads with fault masks need the DES: the "
                    "batch lease model assumes the lease is held for the "
                    "whole run, which a down-window invalidates")
            if batch_m > 1:
                raise ValueError(
                    "leased reads with leader batching are "
                    "DES-authoritative (reads bypass the batch buffer, so "
                    "the full-batch cost reparameterization no longer "
                    "describes the leader's service distribution)")
        raise _not_ported("a workload with read_ratio > 0",
                          "item 6, leased reads")
    if masks is not None and protocol == "epaxos":
        raise ValueError("fault masks are group-kernel only; "
                         "EPaxos fault scenarios need the DES")
    if batch_m > 1:
        raise _not_ported("leader batching (batch_m > 1)",
                          "item 6, batch_m")
    if masks is not None:
        raise _not_ported("fault masks", "item 6, fault masks")
    if protocol == "epaxos":
        raise _not_ported("the EPaxos kernel", "item 7")
    if topo is not None and getattr(topo, "region_of", None) is not None:
        raise _not_ported("a WAN topology", "item 6, WAN region gathers")
    # LAN = one region
    region_of = np.zeros(n, dtype=np.int32)
    blat = float(topo.base_latency) if topo is not None else 0.25e-3
    jitter = float(topo.jitter) if topo is not None else 0.05e-3
    region_latency = np.asarray([[blat]], dtype=np.float64)

    followers = [i for i in range(1, n)]
    if protocol == "paxos" or pig is None:
        groups = [[f] for f in followers]
        thresh = [1] * len(groups)
        costs = {
            "c_req": base + pb * w["req"],
            "c_fanout": base + pb * w["p2a"],      # P2a direct
            "c_rel": 0.0,
            "c_repl": 0.0,
            "c_agg": base + pb * w["p2b"],         # P2b direct
            "c_replycl": base + pb * w["reply_cl"],
        }
        static = True
    elif protocol == "pigpaxos":
        if pig.groups is not None:
            groups = [[m for m in grp if m != 0] for grp in pig.groups]
            groups = [g for g in groups if g]
        else:
            groups = partition_followers(followers, pig.n_groups)
        req = required_per_group(groups, n, pig.prc,
                                 pig.single_group_majority)
        thresh = [min(q, len(g)) for q, g in zip(req, groups)]
        pig_wrap = HEADER_BYTES + 8 + w["p2a"]     # PigFanout/PigRelayed(P2a)
        costs = {
            "c_req": base + pb * w["req"],
            "c_fanout": base + pb * pig_wrap,
            "c_rel": base + pb * pig_wrap,
            "c_repl": base + pb * (HEADER_BYTES + 8 + w["p2b"]),  # PigReply
            "c_agg": base + pb * (HEADER_BYTES + 16),             # PigAggregate
            "c_replycl": base + pb * w["reply_cl"],
        }
        static = not pig.rotate_relays
    else:
        raise ValueError(f"unknown protocol {protocol!r}")

    rmax = len(groups)
    gmax = max(len(g) for g in groups)
    members = np.full((rmax, gmax), -1, dtype=np.int32)
    sizes = np.zeros(rmax, dtype=np.int32)
    tarr = np.zeros(rmax, dtype=np.int32)
    for gi, g in enumerate(groups):
        members[gi, :len(g)] = g
        sizes[gi] = len(g)
        tarr[gi] = thresh[gi]
    return SimConfig(
        kind="group", n=n, members=members, sizes=sizes, thresh=tarr,
        static_relay=static, majority=majority(n), region_of=region_of,
        region_latency=region_latency, jitter=jitter, costs=costs,
        label=label or f"{protocol}/N={n}/R={rmax}")


# ================================================================ rate bound
def _estimate_rate(cfg: SimConfig, k: int) -> float:
    """Optimistic committed-req/s bound (steers the scan-step budget; an
    exhausted grid retries with 2x steps, so this only needs to be sane)."""
    c = cfg.costs
    reg_lat = cfg.region_latency
    leader_reg = int(cfg.region_of[0])
    b_cl = float(reg_lat[0, leader_reg])
    sizes = cfg.sizes[cfg.sizes > 0].astype(float)
    ng = len(sizes)
    leader_cpu = c["c_req"] + ng * (c["c_fanout"] + c["c_agg"]) + c["c_replycl"]
    fol_cpu = (ng * (c["c_fanout"] + c["c_agg"])
               + 2.0 * float((sizes - 1).sum()) * (c["c_rel"] + c["c_repl"]))
    fol_bound = (cfg.n - 1) / fol_cpu if fol_cpu > 0 else float("inf")
    # unloaded round trip: client hops + 2 leader-side + 2 intra-group hops
    mem = cfg.members[cfg.members >= 0]
    b_med = float(np.median(reg_lat[leader_reg, cfg.region_of[mem]]))
    b_in = float(np.median(np.median(reg_lat, axis=0)))
    rt = (2 * b_cl + 2 * b_med + 2 * b_in + 6 * cfg.jitter + leader_cpu
          + c["c_fanout"] + float(sizes.max()) * (c["c_rel"] + c["c_repl"]))
    return min(1.0 / leader_cpu, fol_bound, k / rt)


# ================================================================== batching
def _pad_spec(configs: Sequence[SimConfig], grid) -> Dict[str, int]:
    """The padded-shape signature a (configs, grid) batch runs under."""
    return {
        "nreg": max(c.region_latency.shape[0] for c in configs),
        "kmax": max(k for _, k, _ in grid),
        "wmax": 1,
        "rmax": max(c.rmax for c in configs),
        "fmax": max(c.n - 1 for c in configs),
        "nkeys_max": 1,     # the group kernel never samples keys
    }


def _stack_cells(configs: Sequence[SimConfig], grid, duration: float,
                 warmup: float):
    """Stack (config_idx, clients, seed) grid points into one batch dict of
    numpy arrays, key for key the reference's (the fault-mask and EPaxos
    fields hold their fault-free, group-kernel values)."""
    if any(c.kind != "group" for c in configs):
        raise _not_ported("the EPaxos kernel", "item 7")
    spec = _pad_spec(configs, grid)
    nreg, kmax, wmax = spec["nreg"], spec["kmax"], spec["wmax"]
    rmax, fmax = spec["rmax"], spec["fmax"]
    stop = warmup + duration
    cells: Dict[str, list] = {k: [] for k in (
        "sizes", "thresh", "grp", "pos", "gstart", "regF", "reg_lat",
        "leader_reg", "jitter", "costs",
        "majority", "n_groups", "static_relay", "k_clients", "key", "stop",
        "warmup", "duration", "n_followers", "reg_nodes", "fq",
        "w_follower", "downL", "downF", "slowF", "slowL",
        "key_mode", "n_keys", "conflict_rate", "key_cdf", "read_ratio")}
    for ci, k, seed in grid:
        c = configs[ci]
        sizes = np.zeros(rmax, np.int32)
        thresh = np.zeros(rmax, np.int32)
        # flat group-contiguous follower layout (padding at the tail keeps
        # segment scans confined to real slots)
        grp = np.full(fmax, max(rmax - 1, 0), np.int32)
        pos = np.full(fmax, 1, np.int32)      # non-zero: never a segment start
        gstart = np.zeros(rmax, np.int32)
        regf = np.zeros(fmax, np.int32)
        sizes[:c.rmax] = c.sizes
        thresh[:c.rmax] = c.thresh
        off = 0
        for gi in range(c.rmax):
            sz = int(c.sizes[gi])
            grp[off:off + sz] = gi
            pos[off:off + sz] = np.arange(sz)
            gstart[gi] = off
            regf[off:off + sz] = c.region_of[c.members[gi, :sz]]
            off += sz
        gstart[c.rmax:] = off
        rl = np.zeros((nreg, nreg), np.float64)
        nr = c.region_latency.shape[0]
        rl[:nr, :nr] = c.region_latency
        cells["sizes"].append(sizes)
        cells["thresh"].append(thresh)
        cells["grp"].append(grp)
        cells["pos"].append(pos)
        cells["gstart"].append(gstart)
        cells["regF"].append(regf)
        cells["downL"].append(np.full((wmax, 2), np.inf, np.float32))
        cells["downF"].append(np.full((fmax, wmax, 2), np.inf, np.float32))
        cells["slowF"].append(np.zeros(fmax, np.float32))
        cells["slowL"].append(np.float32(0.0))
        cells["reg_lat"].append(rl.astype(np.float32))
        cells["leader_reg"].append(np.int32(c.region_of[0]))
        cells["jitter"].append(np.float32(c.jitter))
        cells["costs"].append(np.asarray(
            [c.costs[o] for o in ("c_req", "c_fanout", "c_rel", "c_repl",
                                  "c_agg", "c_replycl")], np.float32))
        cells["key_mode"].append(np.int32(0))
        cells["n_keys"].append(np.int32(1))
        cells["conflict_rate"].append(np.float32(0.0))
        cells["key_cdf"].append(np.ones(spec["nkeys_max"], np.float32))
        cells["majority"].append(np.int32(c.majority))
        cells["n_groups"].append(np.int32(int((c.sizes > 0).sum())))
        cells["static_relay"].append(np.bool_(c.static_relay))
        cells["k_clients"].append(np.int32(k))
        cells["key"].append(
            prng.PRNGKey(int(seed) * 1_000_003 + ci).numpy().astype(np.uint32))
        cells["stop"].append(np.float32(stop))
        cells["warmup"].append(np.float32(warmup))
        cells["duration"].append(np.float32(duration))
        cells["n_followers"].append(np.int32(c.n - 1))
        szs = c.sizes[c.sizes > 0].astype(float)
        wf = (len(szs) * (c.costs["c_fanout"] + c.costs["c_agg"])
              + 2.0 * float((szs - 1).sum())
              * (c.costs["c_rel"] + c.costs["c_repl"])) / max(c.n - 1, 1)
        cells["w_follower"].append(np.float32(wf))
        cells["read_ratio"].append(np.float32(0.0))
        cells["reg_nodes"].append(np.zeros(1, np.int32))
        cells["fq"].append(np.int32(fast_quorum(c.n)))
    batch = {k: np.stack(v) for k, v in cells.items()}
    return batch, "group", kmax


# ============================================================== group kernel
def _pct(sorted_vals, m, q):
    """np.percentile(..., q) with linear interpolation over the first
    ``m[c]`` entries of each ascending row (invalid entries sorted to
    +inf)."""
    n = sorted_vals.shape[1]
    mf = torch.clamp_min(m.to(torch.float32), 1.0)
    idx = q * (mf - 1.0)
    lo = torch.clamp(torch.floor(idx).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = idx - lo.to(torch.float32)
    lov = torch.gather(sorted_vals, 1, lo[:, None])[:, 0]
    hiv = torch.where(hi < m, torch.gather(sorted_vals, 1, hi[:, None])[:, 0],
                      lov)
    v = lov * (1.0 - frac) + hiv * frac
    return torch.where(m > 0, v, torch.nan)


def _summarize(lat, t_fin, commit_t, active, ready, loadF, loadL, cell):
    """Per-cell measurement summary over (C, requests) step outputs."""
    f32 = torch.float32
    stop = cell["stop"][:, None]
    warmup = cell["warmup"][:, None]
    in_lat = active & (t_fin >= warmup) & (t_fin <= stop)
    in_commit = active & (commit_t >= warmup) & (commit_t <= stop + _DRAIN_S)
    count = in_lat.sum(1)
    committed = in_commit.sum(1)
    vals = torch.sort(torch.where(in_lat, lat, torch.inf), dim=1).values
    nf = torch.clamp_min(count.to(f32), 1.0)
    followers = cell["n_followers"].to(f32)
    comf = torch.clamp_min(committed.to(f32), 1.0)
    return {
        "throughput": count.to(f32) / cell["duration"],
        "count": count,
        "committed": committed,
        "mean_s": torch.where(count > 0,
                              torch.where(in_lat, lat, 0.0).sum(1) / nf,
                              torch.nan),
        "median_s": _pct(vals, count, 0.5),
        "p25_s": _pct(vals, count, 0.25),
        "p75_s": _pct(vals, count, 0.75),
        "p99_s": _pct(vals, count, 0.99),
        "m_leader": loadL / comf,
        "m_follower": loadF / (followers * comf),
        "exhausted": ready.amin(1) < cell["stop"],
    }


def _group_cell(cell: Dict[str, torch.Tensor], steps: int, kmax: int,
                breq: int, kernel: str = "auto"):
    """Simulate every grid cell of the Paxos/PigPaxos group kernel (LAN,
    fault-free, write path) for ``steps`` scan steps of ``breq`` requests.

    ``cell`` holds the stacked per-cell tensors (``cells_from_numpy``);
    every quantity below carries the cell axis C first.  ``kernel``
    selects the reply fan-in: "auto" goes through ``kernels.ops``
    (the CUDA kernel on the card, the plain version on the CPU); "torch"
    forces the plain version, for whole-run comparisons on the card.
    """
    f32 = torch.float32
    inf = torch.inf
    grp = cell["grp"]                          # (C, F) group of each slot
    pos = cell["pos"]                          # (C, F) position within group
    gstart = cell["gstart"]                    # (C, G) segment start offsets
    sizes = cell["sizes"]                      # (C, G)
    thresh = cell["thresh"]
    dev = grp.device
    C, F = grp.shape
    G = sizes.shape[1]
    B = breq
    # LAN: every link base collapses to the one region latency
    lat0 = cell["reg_lat"][:, 0, 0]            # (C,)
    lat0_c = lat0[:, None, None]
    c_req, c_fanout, c_rel, c_repl, c_agg, c_replycl = cell["costs"].unbind(1)
    c_fanout_c, c_rel_c = c_fanout[:, None, None], c_rel[:, None, None]
    c_repl_c, c_agg_c = c_repl[:, None, None], c_agg[:, None, None]
    majf = cell["majority"].to(f32)[:, None, None]
    ngf = cell["n_groups"].to(f32)
    stop, warmup = cell["stop"], cell["warmup"]
    jitter = cell["jitter"][:, None, None]
    static_relay = cell["static_relay"][:, None, None]
    w_follower = cell["w_follower"]

    szf = sizes.to(f32)
    grp_mask = sizes > 0
    valid = torch.arange(F, device=dev) < cell["n_followers"][:, None]
    grp_b = grp[:, None, :].expand(C, B, F)
    pos_b = pos[:, None, :]
    kk_r = torch.arange(G, dtype=f32, device=dev)
    kk_b = torch.arange(B, dtype=f32, device=dev)
    npeers = torch.clamp_min(sizes - 1, 0)
    npeers_c = npeers[:, None, :]
    acks_b = torch.where(grp_mask, thresh, 0).to(f32)[:, None, :] \
        .expand(C, B, G)
    # total leader work per request (early serialize + deferred late part)
    T_l = c_req + ngf * (c_fanout + c_agg) + c_replycl
    kT = kk_b * T_l[:, None]                   # (C, B)
    w_peer = c_rel + c_repl
    relay_work = c_fanout[:, None] + npeers.to(f32) * w_peer[:, None] \
        + c_agg[:, None]                       # (C, G)
    # per-slot views of group-constant quantities
    valid_relay = valid & torch.gather(grp_mask, 1, grp)
    relay_work_f = torch.gather(relay_work, 1, grp)
    relay_load_f = 2.0 * torch.gather(szf, 1, grp)
    # the fan-in's order-statistic cap (thresh - 2) per slot, and the flat
    # slot each group's order statistic is read back from
    kg = torch.clamp_min(thresh - 2, 0)
    kgf_c = kg.to(f32)[:, None, :]
    kcap = torch.gather(kg, 1, grp)
    seg32, kcap32 = grp.to(torch.int32), kcap.to(torch.int32)
    gread = torch.clamp(gstart, 0, F - 1)[:, None, :].expand(C, B, G)
    flush_at = (thresh >= 2)[:, None, :]
    grp_mask_c = grp_mask[:, None, :]

    kf = torch.arange(kmax, dtype=f32, device=dev)
    ready = torch.where(torch.arange(kmax, device=dev)
                        < cell["k_clients"][:, None],
                        _CLIENT_START + _CLIENT_STAGGER * kf, inf)
    cpuF = torch.zeros(C, F, dtype=f32, device=dev)
    cpuL = torch.zeros(C, dtype=f32, device=dev)
    loadF = torch.zeros(C, F, dtype=f32, device=dev)
    loadL = torch.zeros(C, dtype=f32, device=dev)
    dt_ewma = torch.ones(C, dtype=f32, device=dev)
    t_prev = torch.zeros(C, dtype=f32, device=dev)
    lat_o = torch.empty(C, steps, B, dtype=f32, device=dev)
    tfin_o = torch.empty_like(lat_o)
    commit_o = torch.empty_like(lat_o)
    active_o = torch.empty(C, steps, B, dtype=torch.bool, device=dev)
    key = cell["key"][:, None, :]
    n_draw = 2 + 2 * G + 2 * F
    blk = max(1, min(steps, _DRAW_BLOCK_ELEMS // (C * B * (n_draw + G))))

    for i in range(steps):
        j = i % blk
        if j == 0:
            # k1, k2 = split(fold_in(key, i)) for every step of the block
            idx = torch.arange(i, min(i + blk, steps), device=dev)
            ks = prng.split(prng.fold_in(key, idx))          # (C, n, 2, 2)
            e_blk = prng.exponential(ks[:, :, 0], (B, n_draw))
            u_blk = prng.uniform(ks[:, :, 1], (B, G))
        t0, cids = torch.sort(ready, dim=1, stable=True)
        t0, cids = t0[:, :B], cids[:, :B]      # (C, B) ascending issue times
        active = t0 < stop[:, None]
        any_active = active[:, 0]              # actives are a prefix

        e = e_blk[:, j] * jitter
        e_cl = e[:, :, :2]
        e_Lr = e[:, :, 2:2 + G]
        e_rL = e[:, :, 2 + G:2 + 2 * G]
        e_rp = e[:, :, 2 + 2 * G:2 + 2 * G + F]
        e_pr = e[:, :, 2 + 2 * G + F:]
        u_rel = u_blk[:, j]

        # leader ingress: exact FIFO over the burst (Lindley recursion with
        # constant work T_l), seeded by the accumulator
        aL = t0 + lat0[:, None] + e_cl[:, :, 0]
        start_b = torch.maximum(torch.cummax(aL - kT, dim=1).values + kT,
                                cpuL[:, None] + kT)
        cpuL_next = torch.maximum(
            cpuL, torch.where(active, start_b + T_l[:, None], -inf).amax(1))
        W_L = start_b - aL
        L1 = start_b + c_req[:, None]
        L1_c = L1[:, :, None]
        fan_done = L1_c + (kk_r + 1.0) * c_fanout_c
        cpuL2 = L1 + ngf[:, None] * c_fanout[:, None]

        # rotating-relay choice (static relays pinned to slot 0)
        j_rel = torch.where(static_relay, 0,
                            torch.floor(u_rel * szf[:, None, :]).long())
        j_rel = torch.minimum(torch.clamp_min(j_rel, 0), npeers_c)
        rel_idx = torch.clamp(gstart[:, None, :] + j_rel, 0, F - 1)

        # online rate estimate (EWMA of the L1 pacing interval) -> follower
        # utilization rho and an M/D/1 stochastic-wait floor
        n_act = torch.clamp_min(active.sum(1).to(f32), 1.0)
        last_L1 = torch.where(active, L1, -inf).amax(1)
        dt_ewma = torch.where(
            any_active, 0.95 * dt_ewma + 0.05 * (last_L1 - t_prev) / n_act,
            dt_ewma)
        t_prev = torch.where(any_active, last_L1, t_prev)
        rho = torch.clamp(w_follower / torch.clamp_min(dt_ewma, 1e-9),
                          0.0, 0.95)
        md1 = rho * w_peer / (2.0 * (1.0 - rho))
        rm1_c = (rho - 1.0)[:, None, None]
        md1_c = md1[:, None, None]

        # relay: receive the fanout, re-broadcast to its group peers
        # (fluid work-backlog accumulators anchored at L1)
        arr_rel = fan_done + lat0_c + e_Lr
        B_r = torch.gather(cpuF, 1, rel_idx.reshape(C, B * G)) \
            .reshape(C, B, G) - L1_c
        W_r = torch.clamp_min(B_r + rm1_c * (arr_rel - L1_c), 0.0) + md1_c
        h = arr_rel + W_r + c_fanout_c
        j_rel_f = torch.gather(j_rel, 2, grp_b)
        is_relay = pos_b == j_rel_f            # (C, B, F)
        peer_mask = valid[:, None, :] & ~is_relay
        order = (pos_b - (pos_b > j_rel_f).long()).to(f32)
        send_done = torch.gather(h, 2, grp_b) + (order + 1.0) * c_rel_c
        arr_p = send_done + lat0_c + e_rp
        W_p = torch.clamp_min(cpuF[:, None, :] - L1_c
                              + rm1_c * (arr_p - L1_c), 0.0) + md1_c
        doneP = arr_p + W_p + c_rel_c + c_repl_c
        arr_back = doneP + lat0_c + e_pr

        # relay FIFO over its reply fan-in: the seg_fanin kernel emits each
        # slot's capped segment max (the thresh-2 order statistic)
        relay_free0 = h + npeers_c.to(f32) * c_rel_c
        fan_args = (torch.where(peer_mask, arr_back, inf),
                    torch.gather(B_r, 2, grp_b))
        if kernel == "torch":
            m = ref.seg_fanin_ref(*fan_args, grp, kcap, rho - 1.0, md1,
                                  c_repl, L1)
        else:
            m = ops.seg_fanin(*fan_args, seg32, kcap32, rho - 1.0, md1,
                              c_repl, L1)
        mg = torch.gather(m, 2, gread)
        done_g = (kgf_c + 1.0) * c_repl_c + torch.maximum(relay_free0, mg)
        flush = torch.where(flush_at, done_g, relay_free0)
        agg_sent = flush + c_agg_c

        # leader FIFO over aggregates; commit at the quorum-completing one
        agg_in = agg_sent + lat0_c + e_rL
        arr_agg = torch.where(grp_mask_c, agg_in, inf)
        arr_as, perm = torch.sort(arr_agg, dim=2, stable=True)
        cum = torch.cumsum(torch.gather(acks_b, 2, perm), dim=2)
        got = 1.0 + cum >= majf
        kstar = torch.argmax(got.to(torch.int32), dim=2, keepdim=True)
        prefL = torch.cummax(arr_as + W_L[:, :, None] - kk_r * c_agg_c,
                             dim=2).values
        doneL = (kk_r + 1.0) * c_agg_c + torch.maximum(cpuL2[:, :, None],
                                                       prefL)
        commit_done = torch.where(got.any(2),
                                  torch.gather(doneL, 2, kstar)[:, :, 0], inf)
        reply_done = commit_done + c_replycl[:, None]
        t_fin = reply_done + lat0[:, None] + e_cl[:, :, 1]

        # state updates: follower backlogs grow by the burst's per-node WORK
        # from the anchor (the first active request's pacing point).  The
        # burst's work is summed one request at a time in the reference's
        # order (peer work, then the relay work of its scatter-add) and
        # added to the anchored backlog
        act_b = active[:, :, None]
        relay_slot = valid_relay[:, None, :] & is_relay
        n_peer = (act_b & peer_mask).sum(1)
        n_work = n_peer + (act_b & relay_slot).sum(1)
        add_w = torch.zeros_like(cpuF)
        for b in range(B):
            add_w = add_w + torch.where(
                n_peer > b, w_peer[:, None],
                torch.where(n_work > b, relay_work_f, 0.0))
        anchored = torch.maximum(
            cpuF, torch.where(any_active, L1[:, 0], 0.0)[:, None])
        cpuF = torch.where(any_active[:, None], anchored + add_w, cpuF)
        cpuL = torch.where(any_active, cpuL_next, cpuL)
        ready = ready.scatter(1, cids, torch.where(active, t_fin, inf))

        # per-node message loads, accumulated over the measurement window
        in_win = active & (commit_done >= warmup[:, None]) \
            & (commit_done <= (stop + _DRAIN_S)[:, None])
        win_b = in_win[:, :, None]
        loadF = loadF + (torch.where(win_b & peer_mask, 2.0, 0.0)
                         + torch.where(win_b & relay_slot, relay_load_f[:, None],
                                       0.0)).sum(1)
        loadL = loadL + torch.where(in_win, 2.0 * ngf[:, None] + 2.0,
                                    0.0).sum(1)

        lat_o[:, i] = t_fin - t0
        tfin_o[:, i] = t_fin
        commit_o[:, i] = commit_done
        active_o[:, i] = active

    return _summarize(lat_o.reshape(C, -1), tfin_o.reshape(C, -1),
                      commit_o.reshape(C, -1), active_o.reshape(C, -1),
                      ready, loadF.sum(1), loadL, cell)


def _run_cells(cells: Dict[str, torch.Tensor], steps: int, kmax: int,
               breq: int, kernel: str = "auto") -> Dict[str, torch.Tensor]:
    """Every cell of a stacked grid through ``steps`` scan steps."""
    return _group_cell(cells, steps, kmax, breq, kernel)


def simulate_grid(configs: Sequence[SimConfig], grid, duration: float,
                  warmup: float, steps: Optional[int] = None,
                  kernel: str = "auto", device=None) -> Dict[str, np.ndarray]:
    """Run every (config_idx, clients, seed) grid point together on
    ``device`` (CUDA unless the caller passes "cpu").

    Returns per-cell numpy arrays (throughput, median_s, p99_s, committed,
    m_leader, m_follower, exhausted, ...).  Step budgets are per cell: the
    first pass uses the grid's estimate, and ONLY the exhausted subset
    re-runs with a doubled budget (extra scan steps past the stop time are
    no-ops, so finished cells keep their results).  ``out["steps"]`` is
    each cell's final budget; ``out["scan_steps"]`` (an int) counts the
    scan steps run over all passes, one fan-in launch each.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    dev = resolve_device(device)
    batch, _, kmax = _stack_cells(configs, grid, duration, warmup)
    cells = cells_from_numpy(batch, dev)
    if steps is None:
        # requests are only issued inside [0, stop); the rate bound is
        # optimistic, and the exhausted-retry loop below is the safety net
        rate = max(_estimate_rate(configs[ci], k) for ci, k, _ in grid)
        steps = int(rate * (warmup + duration) * 1.15) + kmax + 64
    steps = min(steps, _MAX_STEPS)
    breq = min(8, kmax)                # requests popped per scan step
    scan = -(-steps // breq)
    out = {k: v.cpu().numpy()
           for k, v in _run_cells(cells, scan, kmax, breq, kernel).items()}
    scan_steps = scan
    steps_arr = np.full(len(grid), steps, np.int32)
    while out["exhausted"].any() and steps < _MAX_STEPS:
        steps = min(steps * 2, _MAX_STEPS)
        scan = -(-steps // breq)
        idx = np.nonzero(out["exhausted"])[0]
        sel = torch.as_tensor(idx, device=dev)
        sub = {k: v[sel] for k, v in cells.items()}
        for k, v in _run_cells(sub, scan, kmax, breq, kernel).items():
            out[k][idx] = v.cpu().numpy()
        steps_arr[idx] = steps
        scan_steps += scan
    out["steps"] = steps_arr
    out["scan_steps"] = scan_steps
    return out


def simulate_scenario(protocol: str, n: int, *, pig=None, topo=None,
                      workload=None, clients: Sequence[int] = (60,),
                      seeds: Sequence[int] = (0,), duration: float = 0.6,
                      warmup: float = 0.3, leader_timeout: float = 50e-3,
                      masks: Optional[Dict[str, np.ndarray]] = None,
                      kernel: str = "auto", batch_m: int = 1,
                      obs: bool = False, device=None,
                      info: Optional[dict] = None) -> List[dict]:
    """One scenario's full clients x seeds grid, run together on
    ``device``.  Returns one dict per (clients, seed) in runner unit order
    with the reference's measurement fields.

    ``retry_risk`` marks cells whose p99 latency reaches the leader
    timeout (the model's validity boundary, as in the reference).

    ``info``, when given, receives the run's device name, cell count, scan
    steps and wall seconds (the host clock around work that ends with the
    results on the host).
    """
    if obs:
        raise _not_ported("the batch obs leader-backlog series",
                          "item 6, obs")
    t0 = time.perf_counter()
    cfg = build_config(protocol, n, pig=pig, topo=topo, workload=workload,
                       masks=masks, batch_m=batch_m)
    grid = [(0, int(k), int(s)) for k in clients for s in seeds]
    dev = resolve_device(device)
    out = simulate_grid([cfg], grid, duration, warmup, kernel=kernel,
                        device=dev)
    if info is not None:
        info.update({"device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                     "cells": len(grid), "scan_steps": int(out["scan_steps"]),
                     "wall_s": time.perf_counter() - t0})
    units = []
    kidx = [int(k) for k in clients for _ in seeds]
    sidx = [int(s) for _ in clients for s in seeds]
    for i, (k, s) in enumerate(zip(kidx, sidx)):
        units.append({
            "retry_risk": bool(out["p99_s"][i] >= leader_timeout),
            "clients": k, "seed": s,
            "throughput": float(out["throughput"][i]),
            "mean_ms": float(out["mean_s"][i]) * 1e3,
            "median_ms": float(out["median_s"][i]) * 1e3,
            "p25_ms": float(out["p25_s"][i]) * 1e3,
            "p75_ms": float(out["p75_s"][i]) * 1e3,
            "p99_ms": float(out["p99_s"][i]) * 1e3,
            "count": int(out["count"][i]),
            "committed": int(out["committed"][i]),
            "leader_msgs_per_op": float(out["m_leader"][i]),
            "follower_msgs_per_op": float(out["m_follower"][i]),
            "exhausted": bool(out["exhausted"][i]),
        })
    return units
