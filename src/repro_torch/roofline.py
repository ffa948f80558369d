"""Roofline accounting from the dry-run's op record (no card required).
The port of ``repro.roofline``.

Three terms per (arch x shape x mesh):
  compute    = FLOPs / (chips * peak_FLOPs)
  memory     = bytes / (chips * HBM_bw)
  collective = in-pod collective bytes / (chips * link_bw)
               + cross-pod collective bytes / (chips * cross_bw)

The reference reads FLOPs, traffic and collective bytes out of compiled
XLA HLO text (``analyze_hlo`` and its parsers).  The port compiles no HLO,
so those parsers are not copied: ``analyze_ops`` reads the record that
``launch.dryrun`` takes of the operations PyTorch dispatches on one rank
(each with its local shapes) and returns the same keys.  The constants
are datasheet figures, not measurements.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# -------------------------------------------------------- TPU v5e constants
# (the reference's, kept so a report on its fields can be compared)
PEAK_FLOPS = 197e12          # bf16 per chip
HBM_BW = 819e9               # bytes/s per chip
ICI_BW = 50e9                # bytes/s per link (~3 links/chip on a 2D torus)
DCN_BW = 25e9                # bytes/s per chip across pods (conservative)

# ------------------------------------------------- NVIDIA H100 SXM constants
# NVIDIA H100 Tensor Core GPU datasheet (SXM5): datasheet figures, not
# measurements on a card.
H100_PEAK_FLOPS = 989e12     # bf16 dense tensor-core FLOP/s (1979 sparse)
H100_HBM_BW = 3.35e12        # HBM3 bytes/s
H100_NVLINK_BW = 450e9       # NVLink 4 bytes/s a direction, within a node
# A production mesh axis of 16 ranks spans two 8-GPU nodes at least, so
# every in-pod collective crosses the InfiniBand fabric: one NDR 400 Gb/s
# NIC a GPU (DGX H100) is 50e9 bytes/s.  Between pods (256 GPUs = 32
# nodes) the spine is assumed 2:1 oversubscribed: 25e9 bytes/s a GPU.
# Both are assumptions about the cluster, not datasheet figures.
H100_IB_BW = 50e9
H100_CROSS_POD_BW = 25e9

CONSTANTS = {
    "v5e": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": ICI_BW,
            "cross_bw": DCN_BW},
    "h100": {"peak_flops": H100_PEAK_FLOPS, "hbm_bw": H100_HBM_BW,
             "link_bw": H100_IB_BW, "cross_bw": H100_CROSS_POD_BW},
}

# the op record's collective kinds, named as the reference's HLO opcodes
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def analyze_ops(record: list, pod_size: Optional[int] = None) -> dict:
    """Per-device flops / traffic / collective bytes of an op record
    (``launch.dryrun``: one entry a dispatched operation, with ``flops``
    (matrix products only, as the reference counts ``dot`` only),
    ``bytes`` (operand + output bytes; 0 for views), and for a collective
    ``coll`` (its kind), ``coll_bytes`` (the output for all-gather and
    all-reduce, else the larger of input and output) and ``ranks`` (the
    group's ranks)).  A collective whose group spans two pods of
    ``pod_size`` ranks is cross-pod; without ``pod_size`` neither split is
    made (as in the reference).  Eager dispatch runs every loop iteration
    as its own operations, so the record is already loop-corrected:
    ``loops`` is ``[]``."""
    flops = traffic = coll_total = coll_cross = coll_in = 0.0
    by_kind: Dict[str, float] = {}
    for op in record:
        flops += op.get("flops", 0.0)
        traffic += op.get("bytes", 0.0)
        kind = op.get("coll")
        if kind is None:
            continue
        b = op["coll_bytes"]
        by_kind[kind] = by_kind.get(kind, 0.0) + b
        coll_total += b
        if pod_size:
            ranks = op["ranks"]
            if any(r // pod_size != ranks[0] // pod_size for r in ranks):
                coll_cross += b
            else:
                coll_in += b
    return {"flops": flops, "traffic_bytes": traffic,
            "coll_total": coll_total, "coll_cross_pod": coll_cross,
            "coll_in_pod": coll_in, "by_kind": by_kind, "loops": []}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_cross_pod: float
    model_flops: float
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = ICI_BW
    cross_bw: float = DCN_BW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        """In-pod bytes at the link rate + cross-pod bytes at the cross-pod
        rate (the scarce resource the Pig schedule protects)."""
        in_pod = self.coll_bytes - self.coll_cross_pod
        return (in_pod / (self.chips * self.link_bw)
                + self.coll_cross_pod / (self.chips * self.cross_bw))

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """How close the step is to the compute roofline: T_compute / T_bound
        where T_bound = max of the three terms (1.0 = compute-bound at peak)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "coll_bytes": self.coll_bytes,
            "coll_cross_pod": self.coll_cross_pod,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_train(param_count: int, tokens: int) -> float:
    """6*N*D for a training step (fwd+bwd).  ``param_count`` is the
    config's ``active_param_count()``, which for the Mamba2 families falls
    short of their parameter trees (a fault of the reference kept in the
    port: ``models.config.param_count_shortfall``, ROADMAP §3)."""
    return 6.0 * param_count * tokens


def model_flops_decode(active_params: int, tokens: int) -> float:
    """2*N*D for a forward-only step (the same shortfall applies)."""
    return 2.0 * active_params * tokens
