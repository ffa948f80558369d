"""The grouped fan-in's share of its roofline (``kernels/ops.py::
seg_fanin_groups`` -> ``csrc/seg_fanin_sm90.cu``, kernel
``fanin_groups_kernel``, one launch a scan step): the least time for the
bytes its work needs (``yardstick.fanin_group_bytes`` at the grid's
shapes) at the HBM peak, over the kernel's device time."""
from portbench import yardstick


def read(ctx):
    return yardstick.fanin_share_pct(
        ctx, "fanin_groups_kernel", 1,
        lambda sh: yardstick.fanin_group_bytes(sh["C"], sh["B"], sh["F"],
                                               sh["G"]))
