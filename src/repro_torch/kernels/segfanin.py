"""Launch wrapper of the Hopper segmented fan-in kernel
(``csrc/seg_fanin.cu``), the counterpart of
``repro.kernels.segfanin.seg_fanin_bf``: one row per burst, rows = cells x
B, with ``segid``/``kcap`` given once per cell.

A CPU tensor goes to the plain version (``ref.seg_fanin_rows_ref``); a
CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import seg_fanin_rows_ref

launches = 0

SMEM_LIMIT = 48 * 1024      # the kernel requests no opt-in shared memory
MAX_THREADS = 256


@functools.cache
def _launcher():
    lib = build.load("seg_fanin")
    fn = lib.seg_fanin_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(F: int) -> int:
    """Shared memory one block uses for F slots: six F-slot arrays, as
    ``seg_fanin_launch`` in the source requests."""
    return 6 * F * 4


def seg_fanin_rows(vals: torch.Tensor, coef: torch.Tensor,
                   segid: torch.Tensor, kcap: torch.Tensor,
                   scal: torch.Tensor, rows_per_cell: int) -> torch.Tensor:
    """vals/coef: (R, F) f32 with R = C x rows_per_cell; segid/kcap: (C, F)
    int32; scal: (R, 4) f32 rows of [vcoef, md1, c, anchor].  Returns (R, F)
    f32 capped segment maxes (see ``csrc/seg_fanin.cu``)."""
    if vals.device.type == "cpu":
        return seg_fanin_rows_ref(vals, coef, segid, kcap, scal,
                                  rows_per_cell)
    if vals.device.type != "cuda":
        raise ValueError(f"seg_fanin_rows: unsupported device {vals.device}")
    R, F = vals.shape
    C = segid.shape[0]
    for name, t, dt, shape in (("vals", vals, torch.float32, (R, F)),
                               ("coef", coef, torch.float32, (R, F)),
                               ("segid", segid, torch.int32, (C, F)),
                               ("kcap", kcap, torch.int32, (C, F)),
                               ("scal", scal, torch.float32, (R, 4))):
        if t.device != vals.device:
            raise ValueError(f"seg_fanin_rows: {name} on {t.device}, "
                             f"vals on {vals.device}")
        if t.dtype != dt:
            raise TypeError(f"seg_fanin_rows: {name} must be {dt}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"seg_fanin_rows: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"seg_fanin_rows: {name} is not contiguous")
    if R != C * rows_per_cell:
        raise ValueError(f"seg_fanin_rows: {R} rows != {C} cells x "
                         f"{rows_per_cell}")
    if smem_bytes(F) > SMEM_LIMIT:
        raise ValueError(f"seg_fanin_rows: F={F} needs {smem_bytes(F)} B of "
                         f"shared memory, the kernel requests at most "
                         f"{SMEM_LIMIT}")
    out = torch.empty_like(vals)
    if R == 0 or F == 0:
        return out
    threads = min(MAX_THREADS, -(-F // 32) * 32)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(vals.data_ptr(), coef.data_ptr(), segid.data_ptr(),
                          kcap.data_ptr(), scal.data_ptr(), out.data_ptr(),
                          R, F, rows_per_cell, threads, stream)
    if err:
        raise RuntimeError(f"seg_fanin kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
