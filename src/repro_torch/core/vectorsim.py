"""Batched round-level simulation backend (port of
``repro.core.vectorsim``).

The per-request message flow of Paxos / PigPaxos / EPaxos is pure array
math: a step loop over request bursts, with every grid cell on one leading
axis, so a whole clients x seeds grid advances together on the device.
The model is the reference's, line for line (see its module docstring):
closed-loop client credit, a Lindley-chain leader FIFO over each burst,
rotating relay choice, fluid follower backlogs with an M/D/1 floor, the
relay reply fan-in order statistic (the ``seg_fanin`` kernel) and the
aggregate quorum at the leader; for EPaxos a random command leader per
request, the fast-quorum and slow-path fan-ins (the same order statistic,
one segment a cell) and the per-key conflict and dependency carry.

Translation from the JAX reference:

* ``vmap`` over cells -> an explicit leading cell axis ``C``;
* ``lax.scan`` -> a Python loop over scan steps, outputs written into
  preallocated (C, steps, B) tensors;
* ``jax.random`` -> ``repro_torch.prng`` (the same threefry bits);
* ``lax.top_k(-ready, B)`` -> the first B of a stable ascending sort;
  ``argmin(ready)`` -> ``torch.argmin`` (the first of equal minima);
* float scatter-adds -> dense per-slot masks, accumulated row by row in
  the reference's order (no float atomics, so the same key gives the same
  output on the card too); the scatter-adds that only add small integers
  (up-member counts, the selected relay's position, timeline counts) stay
  scatter-adds, since an integer sum is exact in any order;
* float sums over a cell's own axis (the summary's latency sum, EPaxos's
  mean propagation base) run in one fixed order, so that a cell's bits
  do not depend on how many cells share its tensors: chunked runs
  (``simulate_grid_sharded``) equal one ``simulate_grid`` call bit for
  bit.

The group kernel carries every branch of the reference's: LAN and WAN
region latencies, leader batching (``batch_m``), fault masks (deferred
hops, relays sampled among the up members, slow nodes, the completion
timeline), leased leader reads (the varying-service leader chain and the
read/write split) and the obs leader-backlog series.  Each optional
branch is static per grid, as in the reference: with every one off, a
step issues the LAN, fault-free, write-path operations alone.  The
EPaxos kernel takes LAN and WAN topologies and the three key
distributions (uniform, zipfian, hot-key conflict); batching, leased
reads and fault masks are refused for it in the reference's words.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..convert import cells_from_numpy
from ..device import resolve_device
from ..kernels import draws, ops, segfanin
from ..kernels.ref import seg_fanin_rows_ref
from .messages import HEADER_BYTES, CostModel
from . import spans
from .pig import partition_followers, required_per_group
from .quorums import fast_quorum, majority
from .segscan import seg_cumsum
from .workload import zipf_cdf

# measurement harness constants — identical to the reference
_DRAIN_S = 0.2          # post-stop drain window (Cluster.measure)
_CLIENT_START = 20e-3   # Cluster.add_clients start_at
_CLIENT_STAGGER = 1e-4  # per-client start stagger
_TL_BUCKET = 0.05       # timeline bucket (= runner.TIMELINE_BUCKET_S)

_MAX_STEPS = 400_000    # hard cap for the exhausted-retry loop
# random draws are made for a block of scan steps at once (the draws of
# step i depend only on the cell key and i); the block holds at most this
# many elements, which bounds the memory of the threefry intermediates (the
# plain versions') or, through the draws kernels, of their outputs
_DRAW_BLOCK_ELEMS = 1 << 21
# threefry draw blocks issued by every step loop so far (``info``'s
# ``draw_blocks`` is a call's difference; ``draw_launches`` counts those
# made by the draws kernels, ``kernels.draws.launches_sm90``)
draw_blocks = 0

KERNELS = ("auto", "torch")


# ===================================================================== config
@dataclasses.dataclass
class SimConfig:
    """One protocol deployment, lowered to arrays (leader = node 0).

    ``kind`` selects the kernel: "group" covers Paxos (singleton groups,
    direct-message costs) and PigPaxos (relay groups); "epaxos" is the
    symmetric random-leader kernel."""
    kind: str
    n: int
    members: np.ndarray        # (r, g) follower node ids, -1 padding
    sizes: np.ndarray          # (r,) group sizes (0 = padded group)
    thresh: np.ndarray         # (r,) relay flush threshold incl. the relay
    static_relay: bool
    majority: int
    region_of: np.ndarray      # (n,) region per node (all 0 for LAN)
    region_latency: np.ndarray  # (nreg, nreg) one-way base seconds
    jitter: float
    costs: Dict[str, float]    # c_req/c_fanout/c_rel/c_repl/c_agg/c_replycl
    label: str = ""
    # fault masks (None = fault-free): down-windows (n, W, 2) [lo, hi) with
    # +inf padding, and per-node whole-run extra one-way latency (n,)
    down: Optional[np.ndarray] = None
    slow: Optional[np.ndarray] = None
    # EPaxos conflict model (epaxos kernel only): the workload's key
    # distribution — 0 uniform, 1 zipfian (key_cdf), 2 hot-key conflict
    key_mode: int = 0
    n_keys: int = 1000
    conflict_rate: float = 0.0
    key_cdf: Optional[np.ndarray] = None
    # leased-leader-read model (group kernel only): fraction of requests
    # served locally at the leader under a held lease (0 = write path only)
    read_ratio: float = 0.0

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
    """Lower a (protocol, n, PigConfig, Topology, WorkloadConfig)
    deployment to the array form the batched kernels consume.  ``masks``
    is the fault lowering produced by ``repro_torch.faults.FaultPlan
    .to_masks`` (down-windows and slow vectors; group kernel only).  An
    EPaxos deployment carries its seven costs and the workload's key
    distribution.

    ``batch_m`` models leader-side request batching with a full batch of m
    on every slot: one "request" through the kernel is a whole batch, with
    per-batch cost = fixed + per-command marginal (m ClientRequest ingests,
    ONE phase-2 fan-out carrying the batched P2a, fixed-size votes and
    aggregates, m serial client replies).  Callers divide the client count
    by m and scale throughput back up; ``simulate_scenario`` does both.

    The reference's boundary ``ValueError``s keep their wording."""
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
    # leased-read model eligibility: only the group kernel's single-leader
    # FIFO has a lease to serve reads under
    rr = (getattr(workload, "read_ratio", None)
          if workload is not None else None)
    rpath = (getattr(workload, "read_path", "log")
             if workload is not None else "log")
    lease_rr = 0.0
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
            lease_rr = float(rr)
    # batched P2a wire: BatchCmd = 8-byte batch header + m commands
    w_p2a = (w["p2a"] if batch_m == 1
             else HEADER_BYTES + 16 + 8 + batch_m * w["cmd"])
    down = slow = None
    if masks is not None:
        if protocol == "epaxos":
            raise ValueError("fault masks are group-kernel only; "
                             "EPaxos fault scenarios need the DES")
        d = np.asarray(masks["down"], dtype=np.float64)
        sl = np.asarray(masks["slow"], dtype=np.float64)
        if d.shape[0] != n or sl.shape[0] != n:
            raise ValueError(f"mask shape mismatch: n={n}, "
                             f"down={d.shape}, slow={sl.shape}")
        if np.isfinite(d[..., 0]).any():
            down = d
        if (sl > 0).any():
            slow = sl
    # topology -> region arrays (LAN = one region)
    if topo is not None and topo.region_of is not None:
        region_of = np.asarray(topo.region_of, dtype=np.int32)
        region_latency = np.asarray(topo.region_latency, dtype=np.float64)
        jitter = float(topo.jitter)
    else:
        region_of = np.zeros(n, dtype=np.int32)
        blat = float(topo.base_latency) if topo is not None else 0.25e-3
        jitter = float(topo.jitter) if topo is not None else 0.05e-3
        region_latency = np.asarray([[blat]], dtype=np.float64)
    if protocol == "epaxos":
        # conflict model inputs: the workload's key distribution decides the
        # per-request conflict draw (interfering in-flight instances route
        # conflicted requests through the Paxos-accept slow path)
        key_mode, n_keys, crate, cdf = 0, 1000, 0.0, None
        if workload is not None:
            n_keys = int(getattr(workload, "n_keys", 1000))
            kd = getattr(workload, "key_dist", "uniform")
            if kd == "zipfian":
                key_mode = 1
                cdf = zipf_cdf(n_keys, float(workload.zipf_theta))
            elif kd == "conflict":
                key_mode = 2
                crate = float(workload.conflict_rate)
        dep = cm.epaxos_extra_per_node * n
        costs = {
            "c_req": base + pb * w["req"],
            # PreAccept / PreAcceptReply / ECommit all carry the O(N)
            # dependency bookkeeping term (CostModel §5.3)
            "c_pa": base + pb * (HEADER_BYTES + w["cmd"] + 12 + 8 * n) + dep,
            "c_par": base + pb * (HEADER_BYTES + 12 + 8 * n) + dep,
            "c_com": base + pb * (HEADER_BYTES + w["cmd"] + 12 + 8 * n) + dep,
            "c_replycl": base + pb * w["reply_cl"],
            # slow path (conflicts): EAccept carries the same O(N) payload
            # as PreAccept; EAcceptReply is a fixed-size ack
            "c_acc": base + pb * (HEADER_BYTES + w["cmd"] + 12 + 8 * n) + dep,
            "c_accr": base + pb * (HEADER_BYTES + 16),
        }
        return SimConfig(
            kind="epaxos", n=n,
            members=np.zeros((1, 1), np.int32), sizes=np.zeros(1, np.int32),
            thresh=np.zeros(1, np.int32), static_relay=False,
            majority=majority(n), region_of=region_of,
            region_latency=region_latency, jitter=jitter, costs=costs,
            label=label or f"epaxos/N={n}",
            key_mode=key_mode, n_keys=n_keys, conflict_rate=crate,
            key_cdf=cdf)

    followers = [i for i in range(1, n)]
    if protocol == "paxos" or pig is None:
        groups = [[f] for f in followers]
        thresh = [1] * len(groups)
        costs = {
            "c_req": batch_m * (base + pb * w["req"]),
            "c_fanout": base + pb * w_p2a,         # P2a direct (batched)
            "c_rel": 0.0,
            "c_repl": 0.0,
            "c_agg": base + pb * w["p2b"],         # P2b direct
            "c_replycl": batch_m * (base + pb * w["reply_cl"]),
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
        pig_wrap = HEADER_BYTES + 8 + w_p2a        # PigFanout/PigRelayed(P2a)
        costs = {
            "c_req": batch_m * (base + pb * w["req"]),
            "c_fanout": base + pb * pig_wrap,
            "c_rel": base + pb * pig_wrap,
            "c_repl": base + pb * (HEADER_BYTES + 8 + w["p2b"]),  # PigReply
            "c_agg": base + pb * (HEADER_BYTES + 16),             # PigAggregate
            "c_replycl": batch_m * (base + pb * w["reply_cl"]),
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
        label=label or f"{protocol}/N={n}/R={rmax}", down=down, slow=slow,
        read_ratio=lease_rr)


# ================================================================ rate bound
def _estimate_rate(cfg: SimConfig, k: int) -> float:
    """Optimistic committed-req/s bound (steers the scan-step budget; an
    exhausted grid retries with 2x steps, so this only needs to be sane)."""
    c = cfg.costs
    reg_lat = cfg.region_latency
    leader_reg = int(cfg.region_of[0])
    b_cl = float(reg_lat[0, leader_reg])
    if cfg.kind == "epaxos":
        n = cfg.n
        per_node = 2.0 * (n - 1) * (c["c_pa"] + c["c_par"] + c["c_com"]) / n
        cpu_bound = 1.0 / per_node
        rt = 4 * (b_cl + cfg.jitter) + (n - 1) * c["c_pa"] + 3 * c["c_pa"]
        return min(cpu_bound, k / rt)
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
    rr = cfg.read_ratio
    if rr > 0.0:
        # leased reads skip the fan-out entirely: leader work shrinks to
        # ingest + reply, followers see only the write fraction, and the
        # read round trip is two client hops plus the leader service
        w_read = c["c_req"] + c["c_replycl"]
        leader_cpu = rr * w_read + (1.0 - rr) * leader_cpu
        fol_bound = (fol_bound / (1.0 - rr)
                     if rr < 1.0 else float("inf"))
        rt = rr * (2 * b_cl + 2 * cfg.jitter + w_read) + (1.0 - rr) * rt
    return min(1.0 / leader_cpu, fol_bound, k / rt)


# ================================================================== batching
def _grid_array(grid) -> np.ndarray:
    """A grid of (config_idx, clients, seed) points as one (cells, 3) int64
    array (an int64 array as it is, a sequence of tuples converted once)."""
    return np.asarray(grid, dtype=np.int64).reshape(-1, 3)


def _pad_spec(configs: Sequence[SimConfig], grid) -> Dict[str, int]:
    """The padded-shape signature a (configs, grid) batch runs under.  A
    chunked run computes it ONCE over the whole grid and lowers every chunk
    under it, so every chunk has the whole grid's shapes."""
    kind = configs[0].kind
    spec = {
        "nreg": max(c.region_latency.shape[0] for c in configs),
        "kmax": int(_grid_array(grid)[:, 1].max()),
        "wmax": max([c.down.shape[1] for c in configs
                     if c.down is not None] + [1]),
    }
    if kind == "group":
        spec["rmax"] = max(c.rmax for c in configs)
        spec["fmax"] = max(c.n - 1 for c in configs)
        spec["nmax"] = 1
        spec["nkeys_max"] = 1   # the group kernel never samples keys
    else:
        spec["rmax"] = spec["fmax"] = 1
        spec["nmax"] = max(c.n for c in configs)
        spec["nkeys_max"] = max(c.n_keys for c in configs)
    return spec


_CELL_FIELDS = (
    "sizes", "thresh", "grp", "pos", "gstart", "regF", "reg_lat",
    "leader_reg", "jitter", "costs",
    "majority", "n_groups", "static_relay", "k_clients", "key", "stop",
    "warmup", "duration", "n_followers", "reg_nodes", "fq",
    "w_follower", "downL", "downF", "slowF", "slowL",
    "key_mode", "n_keys", "conflict_rate", "key_cdf", "read_ratio")
# the fields that vary between the cells of one config (``_cell_columns``);
# every other field is its config's row (``_config_rows``)
_COLUMNS = ("k_clients", "key")


def _config_row(c: SimConfig, kind: str, spec: Dict[str, int], stop: float,
                warmup: float, duration: float) -> Dict[str, np.ndarray]:
    """One config's stacked fields, the reference's per-cell values for
    every field but ``k_clients`` and ``key`` (the only two that vary
    between the cells of one config)."""
    nreg, wmax = spec["nreg"], spec["wmax"]
    rmax, fmax = spec["rmax"], spec["fmax"]
    nmax, nkeys_max = spec["nmax"], spec["nkeys_max"]
    sizes = np.zeros(rmax, np.int32)
    thresh = np.zeros(rmax, np.int32)
    # flat group-contiguous follower layout (padding at the tail keeps
    # segment scans confined to real slots)
    grp = np.full(fmax, max(rmax - 1, 0), np.int32)
    pos = np.full(fmax, 1, np.int32)      # non-zero: never a segment start
    gstart = np.zeros(rmax, np.int32)
    regf = np.zeros(fmax, np.int32)
    # fault masks in flat-slot layout (inf-padded = never down)
    downf = np.full((fmax, wmax, 2), np.inf, np.float32)
    slowf = np.zeros(fmax, np.float32)
    downl = np.full((wmax, 2), np.inf, np.float32)
    slowl = np.float32(0.0)
    if kind == "group":
        sizes[:c.rmax] = c.sizes
        thresh[:c.rmax] = c.thresh
        off = 0
        for gi in range(c.rmax):
            sz = int(c.sizes[gi])
            grp[off:off + sz] = gi
            pos[off:off + sz] = np.arange(sz)
            gstart[gi] = off
            members = c.members[gi, :sz]
            regf[off:off + sz] = c.region_of[members]
            if c.down is not None:
                downf[off:off + sz, :c.down.shape[1]] = c.down[members]
            if c.slow is not None:
                slowf[off:off + sz] = c.slow[members]
            off += sz
        gstart[c.rmax:] = off
        if c.down is not None:
            downl[:c.down.shape[1]] = c.down[0]
        if c.slow is not None:
            slowl = np.float32(c.slow[0])
        order = ("c_req", "c_fanout", "c_rel", "c_repl", "c_agg",
                 "c_replycl")
        szs = c.sizes[c.sizes > 0].astype(float)
        wf = (len(szs) * (c.costs["c_fanout"] + c.costs["c_agg"])
              + 2.0 * float((szs - 1).sum())
              * (c.costs["c_rel"] + c.costs["c_repl"])) / max(c.n - 1, 1)
        # leased reads add no follower work: the utilization estimate
        # sees per-op work scaled to the write fraction
        wf *= 1.0 - c.read_ratio
    else:
        order = ("c_req", "c_pa", "c_par", "c_com", "c_replycl", "c_acc",
                 "c_accr")
        wf = 0.0
    rl = np.zeros((nreg, nreg), np.float64)
    nr = c.region_latency.shape[0]
    rl[:nr, :nr] = c.region_latency
    cdf = np.ones(nkeys_max, np.float32)
    if kind == "epaxos" and c.key_cdf is not None:
        cdf[:len(c.key_cdf)] = np.asarray(c.key_cdf, np.float32)
    return {
        "sizes": sizes, "thresh": thresh, "grp": grp, "pos": pos,
        "gstart": gstart, "regF": regf, "downL": downl, "downF": downf,
        "slowF": slowf, "slowL": slowl,
        "reg_lat": rl.astype(np.float32),
        "leader_reg": np.int32(c.region_of[0]),
        "jitter": np.float32(c.jitter),
        "costs": np.asarray([c.costs[o] for o in order], np.float32),
        "key_mode": np.int32(c.key_mode),
        "n_keys": np.int32(c.n_keys if kind == "epaxos" else 1),
        "conflict_rate": np.float32(c.conflict_rate),
        "key_cdf": cdf,
        "majority": np.int32(c.majority),
        "n_groups": np.int32(int((c.sizes > 0).sum())),
        "static_relay": np.bool_(c.static_relay),
        "stop": np.float32(stop), "warmup": np.float32(warmup),
        "duration": np.float32(duration),
        "n_followers": np.int32(c.n - 1),
        "w_follower": np.float32(wf),
        "read_ratio": np.float32(c.read_ratio),
        "reg_nodes": np.asarray(c.region_of[:nmax] if kind == "epaxos"
                                else np.zeros(1), np.int32),
        "fq": np.int32(fast_quorum(c.n)),
    }


def _batch_kind(configs: Sequence[SimConfig]) -> str:
    """The kernel every config of a batch runs ("group" or "epaxos")."""
    kind = configs[0].kind
    if any(c.kind != kind for c in configs):
        raise ValueError("cannot mix group and epaxos kernels in one batch")
    return kind


def _config_rows(configs: Sequence[SimConfig], spec: Dict[str, int],
                 duration: float, warmup: float) -> Dict[str, np.ndarray]:
    """Every config's row (``_config_row``) stacked once: {field:
    (configs, ...)} for each field but the ``_COLUMNS``."""
    kind = _batch_kind(configs)
    if kind == "epaxos" and any(c.n != spec["nmax"] for c in configs):
        raise ValueError("epaxos batches must share one cluster size")
    rows = [_config_row(c, kind, spec, warmup + duration, warmup, duration)
            for c in configs]
    return {name: np.stack([r[name] for r in rows])
            for name in _CELL_FIELDS if name not in _COLUMNS}


def _cell_columns(grid: np.ndarray) -> Dict[str, np.ndarray]:
    """The per-cell columns of a ``_grid_array``: the config index ``ci``,
    ``k_clients`` and the keys ``PRNGKey(seed * 1_000_003 + ci)``."""
    ci = grid[:, 0]
    s = grid[:, 2] * 1_000_003 + ci
    return {"ci": ci, "k_clients": grid[:, 1].astype(np.int32),
            "key": np.stack([(s >> 32) & 0xFFFFFFFF,
                             s & 0xFFFFFFFF], -1).astype(np.uint32)}


def _stack_cells(configs: Sequence[SimConfig], grid, duration: float,
                 warmup: float, pad_to: Optional[Dict[str, int]] = None):
    """Stack (config_idx, clients, seed) grid points into one batch dict of
    numpy arrays, key for key and bit for bit the reference's: each
    config field taken from the configs' rows by the cells' config index.

    ``pad_to`` (a ``_pad_spec`` dict, possibly of a larger grid) pins the
    padded shapes.  The runners never build this per-cell batch: they ship
    the rows and the columns and gather on the device
    (``_device_cells``)."""
    kind = _batch_kind(configs)
    spec = pad_to or _pad_spec(configs, grid)
    rows = _config_rows(configs, spec, duration, warmup)
    cols = _cell_columns(_grid_array(grid))
    batch = {name: (cols[name] if name in _COLUMNS
                    else np.take(rows[name], cols["ci"], axis=0))
             for name in _CELL_FIELDS}
    return batch, kind, spec["kmax"]


def _device_cells(rows: Dict[str, torch.Tensor],
                  cols: Dict[str, np.ndarray], device):
    """The cell dict on ``device``, ``cells_from_numpy(_stack_cells(...))``
    key for key and bit for bit: the host ``cols`` copied, each config
    field gathered from the configs' ``rows`` (already on ``device``) by
    the cells' config index.  Returns it and the bytes copied."""
    c = cells_from_numpy(cols, device)
    cells = {name: (c[name] if name in _COLUMNS
                    else rows[name].index_select(0, c["ci"]))
             for name in _CELL_FIELDS}
    return cells, sum(t.nbytes for t in c.values())


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


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of each row of a (C, S) float tensor in one fixed pairwise
    order (halves added elementwise, a zero appended to an odd length), so
    that a cell's bits depend neither on how many cells share the tensor
    nor on the device: a library reduction picks its order by shape and
    device."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def _summarize(lat, t_fin, commit_t, active, ready, loadF, loadL, cell,
               nb: int = 0):
    """Per-cell measurement summary over (C, requests) step outputs; with
    ``nb`` buckets, the completion timeline too.  The loads are sums of
    small integers (exact in any order); the latency sum goes through
    ``_row_sum``."""
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
    out = {
        "throughput": count.to(f32) / cell["duration"],
        "count": count,
        "committed": committed,
        "mean_s": torch.where(count > 0,
                              _row_sum(torch.where(in_lat, lat, 0.0)) / nf,
                              torch.nan),
        "median_s": _pct(vals, count, 0.5),
        "p25_s": _pct(vals, count, 0.25),
        "p75_s": _pct(vals, count, 0.75),
        "p99_s": _pct(vals, count, 0.99),
        "m_leader": loadL / comf,
        "m_follower": loadF / (followers * comf),
        "exhausted": ready.amin(1) < cell["stop"],
    }
    if nb:
        # completion timeline (the DES collect=("timeline",) format): counts
        # of client-visible completions per fixed virtual-time bucket from
        # t=0.  Integer counts: the scatter-add is exact in any order
        ok = active & torch.isfinite(t_fin) & (t_fin <= stop + _DRAIN_S)
        tb = _bucket(torch.where(ok, t_fin, 0.0), nb)
        out["timeline"] = torch.zeros(
            ok.shape[0], nb, dtype=torch.int32, device=ok.device
        ).scatter_add_(1, tb, ok.to(torch.int32))
    return out


def _bucket(t: torch.Tensor, nb: int) -> torch.Tensor:
    """Timeline bucket of each time ``t`` (>= 0), clipped to [0, nb).  The
    bucket width is a tensor: on the card a Python divisor would become a
    product with its rounded reciprocal."""
    width = torch.full((), _TL_BUCKET, dtype=torch.float32, device=t.device)
    return torch.clamp(torch.floor(t / width).to(torch.int64), 0, nb - 1)


def _defer(t: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Defer ``t`` past any [lo, hi) down-window containing it; ``win`` has
    shape (..., W, 2) broadcastable against t[..., None] (+inf padding is
    never down)."""
    inw = (t[..., None] >= win[..., 0]) & (t[..., None] < win[..., 1])
    return torch.maximum(t, torch.where(inw, win[..., 1], -torch.inf)
                         .amax(-1))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[c, idx[c, ...]] for x (C, F, *tail) and an index (C, *ishape):
    (C, *ishape, *tail)."""
    C, F = x.shape[:2]
    tail = x.shape[2:]
    flat = x.reshape(C, F, -1)
    i = idx.reshape(C, -1, 1).expand(-1, -1, flat.shape[2])
    return torch.gather(flat, 1, i).reshape(idx.shape + tail)


def _follower_work(act_b, peer_mask, relay_slot, w_peer, relay_work_f):
    """The burst's work added to each follower's backlog (C, F): for every
    active request, ``w_peer`` at its peers, then ``relay_work_f`` at its
    relays, summed one request at a time in the reference's order (its sum
    over the burst, then its scatter-add of the relay work).  Each slot's
    peer and relay work are constants of its cell, so the sum depends only
    on how many requests touch the slot in each role: it stays exact when
    the active requests are not a prefix of the burst (leased reads take
    theirs out)."""
    B = act_b.shape[1]
    n_peer = (act_b & peer_mask).sum(1)
    n_work = n_peer + (act_b & relay_slot).sum(1)
    add_w = torch.zeros(relay_work_f.shape, dtype=relay_work_f.dtype,
                        device=relay_work_f.device)
    for b in range(B):
        add_w = add_w + torch.where(
            n_peer > b, w_peer[:, None],
            torch.where(n_work > b, relay_work_f, 0.0))
    return add_w


def _group_cell(cell: Dict[str, torch.Tensor], steps: int, kmax: int,
                breq: int, kernel: str = "auto", faulty: bool = False,
                nb: int = 0, obs: bool = False, read: bool = False):
    """Simulate every grid cell of the Paxos/PigPaxos group kernel for
    ``steps`` scan steps of ``breq`` requests.

    ``cell`` holds the stacked per-cell tensors (``cells_from_numpy``);
    every quantity below carries the cell axis C first.  ``kernel``
    selects the reply fan-in and the draw blocks: "auto" goes through
    ``kernels.ops.seg_fanin_groups`` and ``kernels.ops.group_draws`` (the
    CUDA kernels on the card, the plain versions on the CPU); "torch"
    forces the plain versions, for whole-run comparisons on the card.

    The branches are static, as in the reference's ``_group_cell``:

    * WAN region gathers run when the batch's padded ``reg_lat`` has more
      than one region (a LAN cell in such a batch takes them too); a LAN
      batch reads the one region latency;
    * ``faulty``: hops arriving at a down node are deferred past its
      window, relays are sampled among the group members up at the burst's
      pacing point, slow nodes add their extra one-way latency;
    * ``read``: leased reads (an extra fold of each step's relay key draws
      the read mask, so the write path's draws do not move) are served at
      the leader alone: a varying-service leader chain, no follower work,
      no commit, and the read/write split in the summary;
    * ``obs`` (needs ``nb``): the leader backlog the first request of each
      step saw, averaged per timeline bucket;
    * ``nb``: the completion timeline's bucket count (0 = none).
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
    reg_lat = cell["reg_lat"]                  # (C, nreg, nreg)
    nreg = reg_lat.shape[1]
    wan = nreg > 1
    # LAN: every link base collapses to the one region latency
    lat0 = reg_lat[:, 0, 0]                    # (C,)
    lat0_c = lat0[:, None, None]
    if wan:
        regF = cell["regF"]                    # (C, F) follower regions
        lreg = cell["leader_reg"]
        # one-way bases from the leader's region and to it, per region
        lat_from_L = torch.gather(
            reg_lat, 1, lreg[:, None, None].expand(C, 1, nreg))[:, 0, :]
        lat_to_L = torch.gather(
            reg_lat, 2, lreg[:, None, None].expand(C, nreg, 1))[:, :, 0]
        reg_flat = reg_lat.reshape(C, nreg * nreg)
        b_cl = lat_to_L[:, 0]                  # client -> leader
        b_lc = lat_from_L[:, 0]                # leader -> client
    else:
        b_cl = b_lc = lat0
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
    # the fan-in's order-statistic cap (thresh - 2) per group; the fan-in
    # reads each group's result at its slot clamp(gstart, 0, F - 1)
    kg = torch.clamp_min(thresh - 2, 0)
    kgf_c = kg.to(f32)[:, None, :]
    with spans.span("fanin_setup"):
        fanin = ops.seg_fanin_groups(grp, gstart, sizes, kg, B,
                                     plain=kernel == "torch")
    c_repl_dense = c_repl.contiguous()     # a column of the costs
    flush_at = (thresh >= 2)[:, None, :]
    grp_mask_c = grp_mask[:, None, :]
    if faulty:
        downL = cell["downL"]                  # (C, W, 2) leader windows
        downL_b, downL_c = downL[:, None], downL[:, None, None]
        downF = cell["downF"]                  # (C, F, W, 2) per-slot windows
        slowF = cell["slowF"]                  # (C, F) extra one-way seconds
        slowL = cell["slowL"]                  # (C,) node 0
        slowL_b = slowL[:, None]
        slowL_c = slowL[:, None, None]
        seg_first = pos == 0
        posf_b = pos.to(f32)[:, None, :]
    if read:
        read_ratio = cell["read_ratio"][:, None]
        w_read = (c_req + c_replycl)[:, None]  # ingest + reply
    if obs:
        qsum = torch.zeros(C, nb, dtype=f32, device=dev)
        qn = torch.zeros(C, nb, dtype=f32, device=dev)
        buckets = torch.arange(nb, device=dev)

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
    if read:
        isr_o = torch.empty_like(active_o)
    key = cell["key"]
    n_draw = 2 + 2 * G + 2 * F
    blk = max(1, min(steps, _DRAW_BLOCK_ELEMS
                     // (C * B * (n_draw + G + int(read)))))
    global draw_blocks
    draw_blocks += -(-steps // blk)

    for i in range(steps):
        j = i % blk
        if j == 0:
            with spans.span("draws", dev):
                # k1, k2 = split(fold_in(key, i)) for every step of the
                # block, their draws and (leased reads) the read mask's,
                # from an extra fold of k2
                e_blk, u_blk, r_blk = ops.group_draws(
                    key, i, min(blk, steps - i), B, n_draw, G, read=read,
                    plain=kernel == "torch")
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
        aL = t0 + b_cl[:, None] + e_cl[:, :, 0]
        if faulty:
            # a request arriving at a down leader waits out the window
            aL = _defer(aL + slowL_b, downL_b)
        if read:
            # leased reads serve at the leader only (ingest + reply), writes
            # keep the full round's work: the exclusive prefix sum Wc
            # generalizes the constant-work kk_b * T_l chain
            is_read = r_blk[:, j] < read_ratio
            w_serve = torch.where(is_read, w_read, T_l[:, None])
            Wc = torch.cumsum(w_serve, dim=1) - w_serve
            start_b = torch.maximum(torch.cummax(aL - Wc, dim=1).values + Wc,
                                    cpuL[:, None] + Wc)
            cpuL_next = torch.maximum(
                cpuL, torch.where(active, start_b + w_serve, -inf).amax(1))
        else:
            start_b = torch.maximum(torch.cummax(aL - kT, dim=1).values + kT,
                                    cpuL[:, None] + kT)
            cpuL_next = torch.maximum(
                cpuL, torch.where(active, start_b + T_l[:, None], -inf)
                .amax(1))
        W_L = start_b - aL
        L1 = start_b + c_req[:, None]
        L1_c = L1[:, :, None]
        fan_done = L1_c + (kk_r + 1.0) * c_fanout_c
        cpuL2 = L1 + ngf[:, None] * c_fanout[:, None]

        # rotating-relay choice (static relays pinned to slot 0)
        if faulty:
            # sample uniformly among the group members UP at the burst's
            # pacing point (the DES leader gray-lists a dead relay); the
            # up-member count and the selected position are small integers,
            # so their scatter-adds are exact in any order
            tref = L1[:, 0, None, None]
            down0 = ((tref >= downF[..., 0]) & (tref < downF[..., 1])).any(-1)
            af = (valid & ~down0).to(f32)                     # (C, F)
            rank = seg_cumsum(af, seg_first, dim=1) - af      # rank among up
            cnt = torch.zeros(C, G, dtype=f32, device=dev) \
                .scatter_add_(1, grp, af)                     # (C, G)
            k_sel = torch.minimum(torch.floor(u_rel * cnt[:, None, :]),
                                  torch.clamp_min(cnt - 1.0, 0.0)[:, None, :])
            k_slot = torch.gather(k_sel, 2, grp_b)            # (C, B, F)
            is_sel = (af > 0)[:, None, :] & (rank[:, None, :] == k_slot)
            j_dyn = torch.zeros(C, B, G, dtype=f32, device=dev).scatter_add_(
                2, grp_b, torch.where(is_sel, posf_b, 0.0))
            j_rel = torch.where(static_relay, 0, j_dyn.long())
        else:
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
        if wan:
            # per-direction region bases (one-way matrices may be
            # asymmetric): leader <-> relay, relay <-> each peer
            reg_relay = _gather_rows(regF, rel_idx)           # (C, B, G)
            b_Lr = _gather_rows(lat_from_L, reg_relay)
            b_rL = _gather_rows(lat_to_L, reg_relay)
            reg_relay_f = torch.gather(reg_relay, 2, grp_b)   # (C, B, F)
            regF_b = regF[:, None, :]
            b_rp = _gather_rows(reg_flat, reg_relay_f * nreg + regF_b)
            b_pr = _gather_rows(reg_flat, regF_b * nreg + reg_relay_f)
        else:
            b_Lr = b_rL = b_rp = b_pr = lat0_c
        arr_rel = fan_done + b_Lr + e_Lr
        if faulty:
            slow_rel = _gather_rows(slowF, rel_idx)           # (C, B, G)
            arr_rel = _defer(arr_rel + slowL_c + slow_rel,
                             _gather_rows(downF, rel_idx))
        B_r = torch.gather(cpuF, 1, rel_idx.reshape(C, B * G)) \
            .reshape(C, B, G) - L1_c
        W_r = torch.clamp_min(B_r + rm1_c * (arr_rel - L1_c), 0.0) + md1_c
        h = arr_rel + W_r + c_fanout_c
        j_rel_f = torch.gather(j_rel, 2, grp_b)
        is_relay = pos_b == j_rel_f            # (C, B, F)
        peer_mask = valid[:, None, :] & ~is_relay
        order = (pos_b - (pos_b > j_rel_f).long()).to(f32)
        send_done = torch.gather(h, 2, grp_b) + (order + 1.0) * c_rel_c
        arr_p = send_done + b_rp + e_rp
        if faulty:
            # relay-out + peer-in slow extras; a down peer serves the
            # relayed message after it recovers
            slow_rel_f = torch.gather(slow_rel, 2, grp_b)
            arr_p = _defer(arr_p + slow_rel_f + slowF[:, None, :],
                           downF[:, None])
        W_p = torch.clamp_min(cpuF[:, None, :] - L1_c
                              + rm1_c * (arr_p - L1_c), 0.0) + md1_c
        doneP = arr_p + W_p + c_rel_c + c_repl_c
        arr_back = doneP + b_pr + e_pr
        if faulty:
            # the returning reply queues at the relay once IT is back up
            win_rel_f = _gather_rows(downF, torch.gather(rel_idx, 2, grp_b))
            arr_back = _defer(arr_back + slow_rel_f + slowF[:, None, :],
                              win_rel_f)

        # relay FIFO over its reply fan-in: the fan-in (one seg_fanin_sm90
        # launch on the card) masks the replies, ranks them in their group
        # and emits each group's capped segment max (the thresh-2 order
        # statistic)
        relay_free0 = h + npeers_c.to(f32) * c_rel_c
        mg = fanin(arr_back, peer_mask, B_r, rho - 1.0, md1, c_repl_dense, L1)
        done_g = (kgf_c + 1.0) * c_repl_c + torch.maximum(relay_free0, mg)
        flush = torch.where(flush_at, done_g, relay_free0)
        agg_sent = flush + c_agg_c

        # leader FIFO over aggregates; commit at the quorum-completing one
        agg_in = agg_sent + b_rL + e_rL
        if faulty:
            agg_in = _defer(agg_in + slow_rel + slowL_c, downL_c)
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
        t_fin = reply_done + b_lc[:, None] + e_cl[:, :, 1]
        if faulty:
            t_fin = t_fin + slowL_b
        if read:
            # leased reads never enter the log: the reply leaves the leader
            # at service completion, and commit_done = inf keeps them out of
            # `committed` and every commit-windowed load
            read_fin = start_b + w_serve + b_lc[:, None] + e_cl[:, :, 1]
            commit_done = torch.where(is_read, inf, commit_done)
            t_fin = torch.where(is_read, read_fin, t_fin)

        # state updates: follower backlogs grow by the burst's per-node WORK
        # from the anchor (the first active request's pacing point)
        act_b = ((active & ~is_read) if read else active)[:, :, None]
        relay_slot = valid_relay[:, None, :] & is_relay
        add_w = _follower_work(act_b, peer_mask, relay_slot, w_peer,
                               relay_work_f)
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

        if obs:
            # leader-backlog observation: the wait the step's first popped
            # request saw at the leader FIFO, stamped with its arrival and
            # added to its bucket in step order (the reference's scatter
            # order; adding 0.0 to the other buckets changes no bit)
            t_obs = torch.where(any_active, aL[:, 0], inf)
            ok = torch.isfinite(t_obs) & (t_obs <= stop + _DRAIN_S)
            # (a step with no active request has W_L = inf - inf = nan: the
            # reference's qlag * ok compiles to a select, which drops it)
            hit = _bucket(torch.where(ok, t_obs, 0.0), nb)[:, None] == buckets
            qsum = qsum + torch.where(
                hit, torch.where(ok, W_L[:, 0], 0.0)[:, None], 0.0)
            qn = qn + torch.where(hit, ok.to(f32)[:, None], 0.0)

        lat_o[:, i] = t_fin - t0
        tfin_o[:, i] = t_fin
        commit_o[:, i] = commit_done
        active_o[:, i] = active
        if read:
            isr_o[:, i] = is_read

    lat, t_fin = lat_o.reshape(C, -1), tfin_o.reshape(C, -1)
    active = active_o.reshape(C, -1)
    with spans.span("summary"):
        out = _summarize(lat, t_fin, commit_o.reshape(C, -1), active, ready,
                         loadF.sum(1), loadL, cell, nb=nb)
    if obs:
        out["leader_backlog_s"] = torch.where(
            qn > 0, qsum / torch.clamp_min(qn, 1.0), 0.0)
        out["leader_backlog_n"] = qn.to(torch.int32)
    if read:
        # read/write latency split over the window the headline latencies
        # use (DES counterpart: Cluster.read_write_split)
        isr = isr_o.reshape(C, -1)
        in_lat = active & (t_fin >= warmup[:, None]) \
            & (t_fin <= stop[:, None])
        rm, wm = in_lat & isr, in_lat & ~isr
        rn, wn = rm.sum(1), wm.sum(1)
        out["read_count"], out["write_count"] = rn, wn
        out["read_mean_s"] = torch.where(
            rn > 0, _row_sum(torch.where(rm, lat, 0.0))
            / torch.clamp_min(rn.to(f32), 1.0), torch.nan)
        out["write_mean_s"] = torch.where(
            wn > 0, _row_sum(torch.where(wm, lat, 0.0))
            / torch.clamp_min(wn.to(f32), 1.0), torch.nan)
        out["read_p99_s"] = _pct(
            torch.sort(torch.where(rm, lat, inf), dim=1).values, rn, 0.99)
    return out


# ============================================================= epaxos kernel
def _epaxos_tables(cell: Dict[str, torch.Tensor]):
    """Per-cell tables of what a step reads by its coordinator: the client
    hops (C, n), the coordinator <-> peer bases (C, n, n) and ``b_prop``
    (C, n), the mean one-way base to the other nodes.  ``b_prop`` is summed
    node by node in id order, once a grid, so its bits depend on neither
    the batch nor the device."""
    reg_nodes = cell["reg_nodes"]              # (C, n) region of each node
    reg_lat = cell["reg_lat"]                  # (C, nreg, nreg)
    C, n = reg_nodes.shape
    nreg = reg_lat.shape[1]
    flat = reg_lat.reshape(C, nreg * nreg)

    def at(idx):
        return torch.gather(flat, 1, idx.reshape(C, -1)).reshape(idx.shape)
    b_cl = at(reg_nodes)                       # reg_lat[0, coord_reg]
    b_lc = at(reg_nodes * nreg)                # reg_lat[coord_reg, 0]
    b_cp = at(reg_nodes[:, :, None] * nreg + reg_nodes[:, None, :])
    b_pc = b_cp.transpose(1, 2).contiguous()   # b_pc[c, p] = b_cp[p, c]
    acc = torch.zeros(C, n, dtype=torch.float32, device=reg_nodes.device)
    ids = torch.arange(n, device=reg_nodes.device)
    for p in range(n):
        acc = acc + torch.where(ids != p, b_cp[:, :, p], 0.0)
    b_prop = acc / torch.full((), float(max(n - 1, 1)), device=acc.device)
    return b_cl, b_lc, b_cp, b_pc, b_prop


def _epaxos_cell(cell: Dict[str, torch.Tensor], steps: int, kmax: int,
                 kernel: str = "auto", nb: int = 0,
                 counts: Optional[dict] = None):
    """Simulate every grid cell of the EPaxos kernel for ``steps`` scan
    steps of one request each: a random command leader per request,
    PreAccept broadcast to all peers, fast-quorum commit on the
    conflict-free path, ECommit broadcast, and the reference's
    conflict/slow-path model:

    * each request draws its key from the workload distribution (uniform /
      zipfian via the cell's CDF row / hot-key conflict);
    * a request CONFLICTS when the previous same-key instance's PreAccept
      round is still propagating at its fan-out time (``race[k]``): the
      commit then takes the slow path, a Paxos-accept fan-out and a
      majority fan-in;
    * execution (and the client reply) waits until the previous same-key
      instance's commit is known everywhere (``depk[k]``).

    Both fan-in rounds are the ``seg_fanin`` order statistic with one
    segment a cell (rows = cells, F = n, the coordinator's slot +inf,
    coef = the coordinator's backlog W_C, scalars [-0.5, 0, c, L1], cap
    fq - 2 or majority - 2): ``kernels.segfanin.seg_fanin_rows``, two
    sm90 launches a scan step on the card, the plain version on the CPU
    or with ``kernel="torch"``.  Node 0 is summarized as the "leader".
    ``counts``, when given, receives ``slow_path``: each cell's window
    requests (those ``committed`` counts) that took the slow round.  The
    per-key update of ``race`` and ``depk`` is the ``keys`` span."""
    f32 = torch.float32
    inf = torch.inf
    reg_nodes = cell["reg_nodes"]
    dev = reg_nodes.device
    C, n = reg_nodes.shape
    wan = cell["reg_lat"].shape[1] > 1
    jitter = cell["jitter"]
    jitter_c = jitter[:, None]
    c_req, c_pa, c_par, c_com, c_replycl, c_acc, c_accr = \
        cell["costs"].unbind(1)
    c_pa_c, c_par_c, c_com_c = c_pa[:, None], c_par[:, None], c_com[:, None]
    c_acc_c, c_accr_c = c_acc[:, None], c_accr[:, None]
    acc_sum = c_acc + c_accr
    # the coordinator's work less the slow round's, in the reference's order
    coord_base = c_req + (n - 1) * (c_pa + c_par + c_com) + c_replycl
    stop, warmup = cell["stop"], cell["warmup"]
    win_hi = stop + _DRAIN_S
    key_cdf = cell["key_cdf"]                  # (C, nk)
    nk = key_cdf.shape[1]
    nkeysf = cell["n_keys"].to(f32)
    key_mode = cell["key_mode"]
    kmodes = set(key_mode.unique().tolist())
    crate = cell["conflict_rate"]
    hot_div = torch.clamp_min(1.0 - crate, 1e-9)
    key_hi = (cell["n_keys"] - 1)[:, None]
    b_cl_t, b_lc_t, b_cp_t, b_pc_t, b_prop_t = _epaxos_tables(cell)
    if not wan:
        # one region: every base is the cell's one latency
        b_cl = b_lc = b_cl_t[:, 0]
        b_cp = b_pc = b_cl[:, None]
        b_prop = b_prop_t[:, 0]
    ids = torch.arange(n, device=dev)
    peer_of = ids[None, :] != ids[:, None]                 # [coord, node]
    ord1_of = (ids[None, :] - (ids[None, :] > ids[:, None]).long()
               + 1).to(f32)                                # order + 1
    cells_ix = torch.arange(C, device=dev)
    # the two fan-in rounds' fixed inputs
    fan = (seg_fanin_rows_ref if kernel == "torch"
           else segfanin.seg_fanin_rows)
    segid = torch.zeros(C, n, dtype=torch.int32, device=dev)
    kc1 = torch.clamp(cell["fq"] - 2, 0, n - 1)
    kc2 = torch.clamp(cell["majority"] - 2, 0, n - 1)
    kcap1 = kc1.to(torch.int32)[:, None].expand(C, n).contiguous()
    kcap2 = kc2.to(torch.int32)[:, None].expand(C, n).contiguous()
    kf1, kf2 = kc1.to(f32) + 1.0, kc2.to(f32) + 1.0
    vcoef = torch.full((C,), -0.5, dtype=f32, device=dev)
    md1 = torch.zeros(C, dtype=f32, device=dev)

    def fanin(arr_back, W_C, c, L1, kcap):
        scal = torch.stack((vcoef, md1, c, L1), dim=1)
        coef = W_C[:, None].expand(C, n).contiguous()
        return fan(arr_back, coef, segid, kcap, scal, 1)[:, 0]

    kf = torch.arange(kmax, dtype=f32, device=dev)
    ready = torch.where(torch.arange(kmax, device=dev)
                        < cell["k_clients"][:, None],
                        _CLIENT_START + _CLIENT_STAGGER * kf, inf)
    cpu = torch.zeros(C, n, dtype=f32, device=dev)
    load = torch.zeros(C, n, dtype=f32, device=dev)
    race = torch.zeros(C, nk, dtype=f32, device=dev)
    depk = torch.zeros(C, nk, dtype=f32, device=dev)
    t0_o = torch.empty(C, steps, dtype=f32, device=dev)
    tfin_o = torch.empty_like(t0_o)
    commit_o = torch.empty_like(t0_o)
    active_o = torch.empty(C, steps, dtype=torch.bool, device=dev)
    slow_n = torch.zeros(C, dtype=torch.int32, device=dev)
    blk = max(1, min(steps, _DRAW_BLOCK_ELEMS // (C * (2 * n + 5))))
    global draw_blocks
    draw_blocks += -(-steps // blk)

    for i in range(steps):
        j = i % blk
        if j == 0:
            with spans.span("draws", dev):
                # split(fold_in(key, i), 5) for every step of the block,
                # then the reference's five draws in its order
                coord_blk, ecl_blk, eout_blk, eback_blk, ukey_blk = \
                    ops.epaxos_draws(cell["key"], i, min(blk, steps - i), n,
                                     plain=kernel == "torch")
        # the earliest-ready client (the first of equal minima)
        cid = torch.argmin(ready, dim=1, keepdim=True)
        t0 = torch.gather(ready, 1, cid)[:, 0]
        active = t0 < stop
        coord = coord_blk[:, j]
        coord_k = coord[:, None]
        e_cl = ecl_blk[:, j] * jitter_c
        e_out = eout_blk[:, j] * jitter_c
        e_back = eback_blk[:, j] * jitter_c
        u_key = ukey_blk[:, j]

        # the request's key, from the cell's distribution
        k = torch.floor(u_key * nkeysf).long()
        if 1 in kmodes:
            k_zipf = torch.searchsorted(
                key_cdf, u_key[:, None].contiguous(), right=True)[:, 0]
            k = torch.where(key_mode == 1, k_zipf, k)
        if 2 in kmodes:
            k_conf = torch.where(
                u_key < crate, 0,
                1 + torch.floor((u_key - crate) / hot_div
                                * (nkeysf - 1.0)).long())
            k = torch.where(key_mode == 2, k_conf, k)
        k = torch.clamp_min(torch.minimum(k[:, None], key_hi), 0)

        if wan:
            b_cl = torch.gather(b_cl_t, 1, coord_k)[:, 0]
            b_lc = torch.gather(b_lc_t, 1, coord_k)[:, 0]
            b_cp = b_cp_t[cells_ix, coord]
            b_pc = b_pc_t[cells_ix, coord]
            b_prop = torch.gather(b_prop_t, 1, coord_k)[:, 0]

        # every node's CPU is a fluid work backlog anchored at t0
        aC = t0 + b_cl + e_cl[:, 0]
        W_C = torch.clamp_min(torch.gather(cpu, 1, coord_k)[:, 0] - t0, 0.0)
        L1 = aC + W_C + c_req
        is_peer = peer_of[coord]
        ord1 = ord1_of[coord]
        pa_done = L1[:, None] + ord1 * c_pa_c
        cpuC2 = L1 + (n - 1) * c_pa
        arr_p = pa_done + b_cp + e_out
        W_p = torch.clamp_min(cpu - t0[:, None], 0.0)
        doneP = arr_p + W_p + c_pa_c + c_par_c
        arr_back = torch.where(is_peer, doneP + b_pc + e_back, inf)
        # fast-path commit after fq - 1 peer replies (the leader votes
        # itself); the coordinator's backlog drains at half rate meanwhile
        fast_commit = kf1 * c_par + torch.maximum(
            cpuC2, fanin(arr_back, W_C, c_par, L1, kcap1))

        # conflict: the previous same-key PreAccept round still propagates
        race_k = torch.gather(race, 1, k)[:, 0]
        slow = active & (L1 < race_k)
        acc_done = fast_commit[:, None] + ord1 * c_acc_c
        cpuC3 = fast_commit + (n - 1) * c_acc
        arr_p2 = acc_done + b_cp + e_out
        doneP2 = arr_p2 + W_p + c_acc_c + c_accr_c
        arr_back2 = torch.where(is_peer, doneP2 + b_pc + e_back, inf)
        slow_commit = kf2 * c_accr + torch.maximum(
            cpuC3, fanin(arr_back2, W_C, c_accr, L1, kcap2))
        commit_done = torch.where(slow, slow_commit, fast_commit)

        # dependency-order execution behind the same-key predecessor
        depk_k = torch.gather(depk, 1, k)[:, 0]
        committed_all = commit_done + (n - 1) * c_com
        exec_done = torch.maximum(committed_all, depk_k)
        t_fin = exec_done + c_replycl + b_lc + e_cl[:, 1]

        slowf = slow.to(f32)
        anchored = torch.maximum(cpu, t0[:, None])
        coord_work = coord_base + slowf * (n - 1) * acc_sum
        new_cpu = torch.where(is_peer, anchored + c_pa_c + c_par_c + c_com_c
                              + (slowf * acc_sum)[:, None], cpu)
        new_cpu = new_cpu.scatter(
            1, coord_k, (torch.gather(anchored, 1, coord_k)[:, 0]
                         + coord_work)[:, None])
        cpu = torch.where(active[:, None], new_cpu, cpu)
        ready = ready.scatter(1, cid, torch.where(active, t_fin, inf)[:, None])

        # conflict tracking: when every peer has processed this request's
        # PreAccept (race), and when its commit is known everywhere (depk)
        with spans.span("keys", dev):
            race_new = torch.where(is_peer, arr_p + W_p + c_pa_c,
                                   -inf).amax(1)
            dep_new = committed_all + b_prop + jitter
            race = race.scatter(1, k, torch.where(active, race_new,
                                                  race_k)[:, None])
            depk = depk.scatter(1, k, torch.where(active, dep_new,
                                                  depk_k)[:, None])

        # per-node messages of a request in the window (small integers)
        in_win = active & (commit_done >= warmup) & (commit_done <= win_hi)
        add = torch.where(is_peer, 3.0 + 2.0 * slowf[:, None],
                          ((3.0 * n - 1.0) + 2.0 * (n - 1) * slowf)[:, None])
        load = load + torch.where(in_win[:, None], add, 0.0)
        slow_n = slow_n + (slow & in_win)

        t0_o[:, i] = t0
        tfin_o[:, i] = t_fin
        commit_o[:, i] = commit_done
        active_o[:, i] = active

    if counts is not None:
        counts["slow_path"] = slow_n
    # symmetric protocol: node 0 is reported as "leader", the rest as
    # followers
    with spans.span("summary"):
        return _summarize(tfin_o - t0_o, tfin_o, commit_o, active_o, ready,
                          load[:, 1:].sum(1), load[:, 0], cell, nb=nb)


# ================================================================== runners
def _run_cells(cells: Dict[str, torch.Tensor], steps: int, kmax: int,
               breq: int, kernel: str = "auto", faulty: bool = False,
               nb: int = 0, obs: bool = False, read: bool = False,
               kind: str = "group",
               counts: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Every cell of a stacked grid through ``steps`` scan steps of the
    ``kind`` kernel (EPaxos pops one request a step: ``breq`` = 1).
    ``counts`` receives the EPaxos kernel's ``slow_path``."""
    with spans.span("step_loop"):
        if kind == "epaxos":
            return _epaxos_cell(cells, steps, kmax, kernel, nb, counts)
        return _group_cell(cells, steps, kmax, breq, kernel, faulty, nb, obs,
                           read)


def fanin_name(kernel: str, device) -> str:
    """The fan-in a run goes through: the sm90 kernel on the card with
    ``kernel="auto"``, else the plain version."""
    dev = torch.device(device)
    return ("seg_fanin_sm90" if dev.type == "cuda" and kernel == "auto"
            else "plain")


def simulate_grid(configs: Sequence[SimConfig], grid, duration: float,
                  warmup: float, steps: Optional[int] = None,
                  timeline: bool = False, kernel: str = "auto",
                  obs: bool = False, device=None) -> Dict[str, np.ndarray]:
    """Run every (config_idx, clients, seed) grid point together on
    ``device`` (CUDA unless the caller passes "cpu"): one chunk of
    ``simulate_grid_sharded`` on one device.

    Returns per-cell numpy arrays (throughput, median_s, p99_s, committed,
    m_leader, m_follower, exhausted, ...).  Step budgets are per cell: the
    first pass uses the grid's estimate, and ONLY the exhausted subset
    re-runs with a doubled budget (extra scan steps past the stop time are
    no-ops, so finished cells keep their results).  ``out["steps"]`` is
    each cell's final budget; ``out["scan_steps"]`` (an int) counts the
    scan steps run over all passes: one fan-in launch each for the group
    kernel, two for EPaxos.  An EPaxos grid adds ``slow_path``: each
    cell's window requests that committed on the slow path.

    ``timeline=True`` (implied by fault-mask configs) adds per-cell
    completion timelines (``_TL_BUCKET`` buckets); ``obs=True`` (group
    kernel only) adds the leader-backlog series (``leader_backlog_s`` /
    ``leader_backlog_n``) on the same buckets.
    """
    out = simulate_grid_sharded(configs, grid, duration, warmup, steps=steps,
                                timeline=timeline, kernel=kernel, obs=obs,
                                chunk=len(grid),
                                devices=[resolve_device(device)])
    del out["sharding"]
    return out


def _step_budget(configs: Sequence[SimConfig], grid: np.ndarray,
                 kmax: int, stop: float) -> int:
    """A grid's first scan-step budget.  Requests are only issued inside
    [0, stop); the rate bound is optimistic, and the exhausted-retry loop
    is the safety net.  The bound depends on a cell's (config, clients)
    point alone, so it is estimated once a distinct point (found as
    ci * (kmax + 1) + k): the per-cell maximum, to the bit."""
    w = kmax + 1
    pts = np.unique(grid[:, 0] * w + grid[:, 1]).tolist()
    rate = max(_estimate_rate(configs[p // w], p % w) for p in pts)
    return int(rate * stop * 1.15) + kmax + 64


def _chunk(grid: np.ndarray, lo: int, size: int) -> np.ndarray:
    """Cells [lo, lo + size) of a grid array, a ragged last chunk padded
    with its last cell: every chunk one shape."""
    part = grid[lo:lo + size]
    return np.concatenate([part, np.repeat(part[-1:], size - len(part), 0)])


def _run_on_devices(rows, cols, devices, steps, kmax, breq, kernel, flags):
    """One chunk's cells split evenly over ``devices`` (the cell count is a
    multiple of theirs): every device's share of the columns ``cols`` is
    copied and gathered with that device's ``rows`` (``_device_cells``) and
    issued from this thread in turn (its launches are asynchronous), then
    every result is brought to the host.  Returns the results and the
    bytes copied."""
    per = len(cols["ci"]) // len(devices)
    outs, copied = [], 0
    for d, dev in enumerate(devices):
        with spans.span("lowering"):
            cells, nbytes = _device_cells(
                rows[d], {k: v[d * per:(d + 1) * per]
                          for k, v in cols.items()}, dev)
        copied += nbytes
        counts: Dict[str, torch.Tensor] = {}
        outs.append(_run_cells(cells, steps, kmax, breq, kernel,
                               counts=counts, **flags))
        outs[-1].update(counts)
    with spans.span("collect"):
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}, copied


def simulate_grid_sharded(configs: Sequence[SimConfig], grid,
                          duration: float, warmup: float, *,
                          steps: Optional[int] = None,
                          timeline: bool = False, kernel: str = "auto",
                          obs: bool = False, chunk: int = 4096, devices=None,
                          device=None) -> Dict[str, np.ndarray]:
    """``simulate_grid`` in fixed chunks over a list of devices (port of
    ``repro.core.vectorsim.simulate_grid_sharded``).  ``devices`` defaults
    to every visible CUDA device, or ``[cpu]`` when ``device="cpu"``.

    ``grid`` is a sequence of (config_idx, clients, seed) tuples or a
    (cells, 3) int64 array.  The step budget is estimated once a distinct
    (config, clients) point.  The configs' rows are stacked and copied to
    every device once a grid; a chunk copies its cells' columns alone
    (config index, clients, key) and gathers the rows to its cells on the
    device.  Each chunk holds ``chunk`` cells (rounded down to a multiple
    of the device count, at least one a device), a ragged last chunk padded
    with its last cell; shapes are pinned grid-wide (``_pad_spec``); a
    chunk's exhausted cells retry inside it with doubled budgets, padded
    back to a device multiple; a chunk's results reach the host before the
    next is lowered, so device memory is bounded by one chunk.  Per-cell
    results are bit-identical to one ``simulate_grid`` call on the same
    cells.

    Returns the ``simulate_grid`` dict plus ``out["sharding"]``: device
    count, ``impl`` ("chunked"), the fan-in (``fanin_name``),
    chunk size and per chunk {cells, wall_s (lowering included), stack_s
    (the host's lowering), lowered_bytes (copied host-to-device, retries
    included), steps, scan_steps, retries}; the first chunk's stack_s and
    lowered_bytes include the configs' rows.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = [resolve_device(d) for d in devices]
    D = len(devices)
    chunk = max(chunk - chunk % D, D)
    if obs and _batch_kind(configs) != "group":
        raise ValueError("obs timelines are group-kernel only — the epaxos "
                         "kernel has no single-leader FIFO to observe")
    with spans.span("budget"):
        grid = _grid_array(grid)
        spec = _pad_spec(configs, grid)
        kmax = spec["kmax"]
        if steps is None:
            steps = _step_budget(configs, grid, kmax, warmup + duration)
    faulty = any(c.down is not None or c.slow is not None for c in configs)
    read = any(c.read_ratio > 0.0 for c in configs)
    nb = (int(np.ceil((warmup + duration + _DRAIN_S) / _TL_BUCKET)) + 1
          if (faulty or timeline or obs) else 0)
    steps0 = min(steps, _MAX_STEPS)
    # the group kernel pops `breq` requests a scan step, EPaxos one
    breq = min(8, kmax) if configs[0].kind == "group" else 1
    flags = dict(faulty=faulty, nb=nb, obs=obs, read=read,
                 kind=configs[0].kind)
    n_cells = len(grid)
    out: Dict[str, np.ndarray] = {}
    steps_arr = np.empty(n_cells, np.int32)
    meta = []
    for lo in range(0, n_cells, chunk):
        part = _chunk(grid, lo, chunk)
        real = min(chunk, n_cells - lo)
        t0 = time.perf_counter()
        lowered = 0
        with spans.span("lowering"):
            if lo == 0:
                # the configs' rows, on every device once a grid
                rows = [cells_from_numpy(_config_rows(configs, spec,
                                                      duration, warmup), dev)
                        for dev in devices]
                lowered = sum(t.nbytes for r in rows for t in r.values())
            cols = _cell_columns(part)
        stack_s = time.perf_counter() - t0
        steps_c = steps0
        scan = -(-steps_c // breq)
        cout, nbytes = _run_on_devices(rows, cols, devices, scan, kmax, breq,
                                       kernel, flags)
        lowered += nbytes
        scans, retries = scan, 0
        csteps = np.full(chunk, steps_c, np.int32)
        while cout["exhausted"][:real].any() and steps_c < _MAX_STEPS:
            steps_c = min(steps_c * 2, _MAX_STEPS)
            scan = -(-steps_c // breq)
            idx = np.nonzero(cout["exhausted"])[0]
            # retry the exhausted subset, padded back to a device multiple
            ridx = np.resize(idx, -(-len(idx) // D) * D)
            with spans.span("retry"):
                sub, nbytes = _run_on_devices(
                    rows, {k: v[ridx] for k, v in cols.items()}, devices,
                    scan, kmax, breq, kernel, flags)
            lowered += nbytes
            for k, v in sub.items():
                cout[k][idx] = v[:len(idx)]
            csteps[idx] = steps_c
            scans += scan
            retries += 1
        wall = time.perf_counter() - t0
        for k, v in cout.items():
            if k not in out:
                out[k] = np.empty((n_cells,) + v.shape[1:], v.dtype)
            out[k][lo:lo + real] = v[:real]
        steps_arr[lo:lo + real] = csteps[:real]
        meta.append({"cells": real, "wall_s": wall, "stack_s": stack_s,
                     "lowered_bytes": lowered,
                     "steps": int(csteps[:real].max()), "scan_steps": scans,
                     "retries": retries})
    out["steps"] = steps_arr
    out["scan_steps"] = sum(m["scan_steps"] for m in meta)
    out["sharding"] = {"devices": D, "impl": "chunked",
                       "kernel": fanin_name(kernel, devices[0]),
                       "chunk": chunk, "chunks": meta}
    return out


def _units(out, clients, seeds, m: int, lat_adj: float,
           leader_timeout: float) -> List[dict]:
    """``simulate_scenario``'s per-cell result dicts from ``out``'s
    arrays, in runner unit order."""
    units = []
    kidx = [int(k) for k in clients for _ in seeds]
    sidx = [int(s) for _ in clients for s in seeds]
    for i, (k, s) in enumerate(zip(kidx, sidx)):
        u = {
            "retry_risk": bool(out["p99_s"][i] - lat_adj >= leader_timeout),
            "clients": k, "seed": s,
            "throughput": float(out["throughput"][i]) * m,
            "mean_ms": float(out["mean_s"][i] - lat_adj) * 1e3,
            "median_ms": float(out["median_s"][i] - lat_adj) * 1e3,
            "p25_ms": float(out["p25_s"][i] - lat_adj) * 1e3,
            "p75_ms": float(out["p75_s"][i] - lat_adj) * 1e3,
            "p99_ms": float(out["p99_s"][i] - lat_adj) * 1e3,
            "count": int(out["count"][i]) * m,
            "committed": int(out["committed"][i]) * m,
            "leader_msgs_per_op": float(out["m_leader"][i]) / m,
            "follower_msgs_per_op": float(out["m_follower"][i]) / m,
            "exhausted": bool(out["exhausted"][i]),
        }
        if "timeline" in out:
            u["timeline"] = {"bucket_s": _TL_BUCKET,
                             "counts": out["timeline"][i].tolist()}
        if "leader_backlog_s" in out:
            u["obs"] = {"leader_backlog": {
                "bucket_s": _TL_BUCKET,
                "mean_ms": [round(float(v) * 1e3, 6)
                            for v in out["leader_backlog_s"][i]],
                "n": out["leader_backlog_n"][i].tolist()}}
        if "read_count" in out:
            # leased-read split (DES counterpart: Cluster.read_write_split)
            u["rw"] = {
                "reads": int(out["read_count"][i]),
                "writes": int(out["write_count"][i]),
                "read_mean_ms": float(out["read_mean_s"][i]) * 1e3,
                "write_mean_ms": float(out["write_mean_s"][i]) * 1e3,
                "read_p99_ms": float(out["read_p99_s"][i]) * 1e3,
            }
        units.append(u)
    return units


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

    ``masks`` enables the fault path (``FaultPlan.to_masks``); its units
    carry a completion ``timeline``.  ``batch_m`` > 1 runs the
    leader-batching model: every ``batch_m`` clients share one slot, so
    client counts must divide evenly; throughput, counts and committed
    scale back up by m, message loads down by m, and latencies drop by the
    mean reply-serialization rank ((m-1)/2 per-reply CPU slots).  ``obs``
    adds the leader-backlog series to every unit, and a leased-read
    workload the read/write split (``rw``).

    ``info``, when given, receives the run's device name, cell count, scan
    steps, fan-in kernel launches (one a scan step for the group kernel,
    two for EPaxos; none on the CPU), threefry draw blocks
    (``draw_blocks``) and the draws kernels' launches among them
    (``draw_launches``: one a block of either loop on the card, none on
    the CPU or with ``kernel="torch"``), the window's requests that took
    EPaxos's slow round (``slow_path_requests``; 0 for the group kernel),
    the
    chunks, the exhausted-cell retry passes summed over them
    (``retries``), the seconds spent lowering them on the host
    (``stack_s``), the bytes the lowering copied host-to-device
    (``lowered_bytes``: the config's row, then 32 a cell a pass) and wall
    seconds (the host clock around work that ends with the results on
    the host).  Its spans (``core/spans.py``) are recorded only inside
    ``spans.recording()`` or under the profiler.
    """
    with spans.grid():
        t0 = time.perf_counter()
        launches0, blocks0 = segfanin.launches, draw_blocks
        draws0 = draws.launches_sm90
        with spans.span("lowering"):
            cfg = build_config(protocol, n, pig=pig, topo=topo,
                               workload=workload, masks=masks,
                               batch_m=batch_m)
        m = int(batch_m)
        if m > 1:
            for k in clients:
                if int(k) % m:
                    raise ValueError(f"clients={k} not divisible by "
                                     f"batch_m={m}: one kernel lane carries "
                                     f"a whole batch of {m} clients")
        # (0, clients, seed) with the clients outer and the seeds inner
        ks = np.asarray([int(k) // m for k in clients], np.int64)
        ss = np.asarray([int(s) for s in seeds], np.int64)
        grid = np.stack([np.zeros(len(ks) * len(ss), np.int64),
                         np.repeat(ks, len(ss)), np.tile(ss, len(ks))], 1)
        dev = resolve_device(device)
        # simulate_grid's one chunk, keeping its record
        out = simulate_grid_sharded([cfg], grid, duration, warmup,
                                    kernel=kernel, obs=obs, chunk=len(grid),
                                    devices=[dev])
        chunks = out.pop("sharding")["chunks"]
        slow = out.pop("slow_path", None)
        if info is not None:
            info.update({"device": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
                         "cells": len(grid),
                         "scan_steps": int(out["scan_steps"]),
                         "fanin_launches": segfanin.launches - launches0,
                         "draw_blocks": draw_blocks - blocks0,
                         "draw_launches": draws.launches_sm90 - draws0,
                         "slow_path_requests": (0 if slow is None
                                                else int(slow.sum())),
                         "chunks": len(chunks),
                         "retries": sum(c["retries"] for c in chunks),
                         "stack_s": sum(c["stack_s"] for c in chunks),
                         "lowered_bytes": sum(c["lowered_bytes"]
                                              for c in chunks),
                         "wall_s": time.perf_counter() - t0})
        # mean reply rank correction (seconds); 0 when unbatched
        lat_adj = (0.0 if m == 1
                   else (m - 1) / 2.0 * (cfg.costs["c_replycl"] / m))
        with spans.span("units"):
            return _units(out, clients, seeds, m, lat_adj, leader_timeout)
