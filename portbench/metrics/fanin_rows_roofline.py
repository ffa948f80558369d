"""The EPaxos path's fan-in share of its roofline (the per-slot entry
``kernels/segfanin.py::seg_fanin_rows`` -> ``csrc/seg_fanin_sm90.cu``,
kernel ``fanin_rows_kernel``, two launches a scan step: the fast and the
slow quorum): the least time for the bytes the EPaxos path needs (each
row's values, its six scalars and its one output:
``yardstick.fanin_epaxos_bytes``) at the HBM peak, over the kernel's
device time."""
from portbench import yardstick


def read(ctx):
    return yardstick.fanin_share_pct(
        ctx, "fanin_rows_kernel", 2,
        lambda sh: yardstick.fanin_epaxos_bytes(sh["C"], sh["F"]))
