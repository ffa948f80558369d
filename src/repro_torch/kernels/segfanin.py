"""Launch wrappers of the Hopper segmented fan-in kernel, the counterpart
of ``repro.kernels.segfanin.seg_fanin_bf``.

One kernel, ``csrc/seg_fanin_sm90.cu`` (warp-resident segments), two
entries: ``seg_fanin_rows`` (one row per burst, rows = cells x B,
``segid``/``kcap`` once per cell, a per-slot output) and ``FaninGroups``,
the step loop's route, which takes the fan-in's inputs as the step has
them (``arr_back`` with ``peer_mask``, ``B_r`` per group, the per-cell
layout and scalars) and writes each group's result (C, B, G) directly.

A CPU tensor goes to the plain version (``ref.seg_fanin_rows_ref``,
``ref.seg_fanin_groups_ref``); a CUDA tensor launches the kernel or raises.
``launches`` counts every launch of the kernel and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .ref import seg_fanin_groups_ref, seg_fanin_rows_ref

launches = 0

SMEM_LIMIT = 48 * 1024      # the kernel requests no opt-in shared memory
WARP = 32
ROW_WARPS = 8               # a block has max(1, 8 / windows) rows ...
MAX_WARPS = 32              # ... and one warp a 32-slot window, up to 32
INT32_MAX = 2**31 - 1


def geometry(F: int) -> tuple:
    """(rows a block, warps a block) of ``seg_fanin_sm90.cu`` for rows of F
    slots: one warp a 32-slot window of a row, several rows a block when
    rows are short."""
    windows = -(-F // WARP)
    rows = max(1, ROW_WARPS // max(windows, 1))
    return rows, min(MAX_WARPS, rows * windows)


def sm90_smem_bytes(F: int) -> int:
    """Shared memory a block of ``seg_fanin_sm90.cu`` uses (its
    ``fanin_smem_bytes``): values, sorted values and m of each row, and two
    run masks a window."""
    windows = -(-F // WARP)
    return geometry(F)[0] * windows * (3 * WARP * 4 + 2 * 4)


# slots a row: a block at this F uses sm90_smem_bytes(2048) = 25,088 B,
# under SMEM_LIMIT
F_MAX = 2048


@functools.cache
def _lib_sm90():
    lib = build.load("seg_fanin_sm90")
    lib.seg_fanin_sm90_rows_launch.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.seg_fanin_sm90_groups_launch.argtypes = [ctypes.c_void_p] * 10
    lib.seg_fanin_sm90_empty_launch.argtypes = [ctypes.c_void_p]
    for fn in (lib.seg_fanin_sm90_rows_launch,
               lib.seg_fanin_sm90_groups_launch,
               lib.seg_fanin_sm90_empty_launch):
        fn.restype = ctypes.c_int
    return lib


# the current stream of a device as an int: the public accessor builds a
# Stream object a call, the raw one does not
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(torch.cuda.current_device() if device.index is None
                           else device.index)
    return torch.cuda.current_stream(device).cuda_stream


class _Plan(ctypes.Structure):
    """``FaninPlan`` of ``seg_fanin_sm90.cu``: what a grid's calls share."""
    _fields_ = [("grp", ctypes.c_void_p), ("gstart", ctypes.c_void_p),
                ("kg", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("rows", "F", "G", "rows_per_cell",
                                    "rows_per_block", "warps")]


def _check_rows(vals, coef, segid, kcap, scal, rows_per_cell, what):
    R, F = vals.shape
    C = segid.shape[0]
    for name, t, dt, shape in (("vals", vals, torch.float32, (R, F)),
                               ("coef", coef, torch.float32, (R, F)),
                               ("segid", segid, torch.int32, (C, F)),
                               ("kcap", kcap, torch.int32, (C, F)),
                               ("scal", scal, torch.float32, (R, 4))):
        if t.device != vals.device:
            raise ValueError(f"{what}: {name} on {t.device}, "
                             f"vals on {vals.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if R != C * rows_per_cell:
        raise ValueError(f"{what}: {R} rows != {C} cells x {rows_per_cell}")
    if F > F_MAX:
        raise ValueError(f"{what}: F={F} slots exceed the {F_MAX} a "
                         f"block's shared memory holds")
    if R * F > INT32_MAX:
        raise ValueError(f"{what}: {R} x {F} slots overflow int32 offsets")


def seg_fanin_rows(vals: torch.Tensor, coef: torch.Tensor,
                   segid: torch.Tensor, kcap: torch.Tensor,
                   scal: torch.Tensor, rows_per_cell: int) -> torch.Tensor:
    """vals/coef: (R, F) f32 with R = C x rows_per_cell; segid/kcap: (C, F)
    int32 (kcap >= 0); scal: (R, 4) f32 rows of [vcoef, md1, c, anchor].
    Returns (R, F) f32 capped segment maxes (see ``csrc/seg_fanin_sm90.cu``)
    through the sm90 kernel."""
    if vals.device.type == "cpu":
        return seg_fanin_rows_ref(vals, coef, segid, kcap, scal,
                                  rows_per_cell)
    if vals.device.type != "cuda":
        raise ValueError(f"seg_fanin_rows: unsupported device {vals.device}")
    _check_rows(vals, coef, segid, kcap, scal, rows_per_cell,
                "seg_fanin_rows")
    R, F = vals.shape
    out = torch.empty_like(vals)
    if R == 0 or F == 0:
        return out
    rpb, warps = geometry(F)
    with torch.cuda.device(vals.device):
        err = _lib_sm90().seg_fanin_sm90_rows_launch(
            vals.data_ptr(), coef.data_ptr(), segid.data_ptr(),
            kcap.data_ptr(), scal.data_ptr(), out.data_ptr(), R, F,
            rows_per_cell, rpb, warps, _stream(vals.device))
    if err:
        raise RuntimeError(f"seg_fanin_sm90 kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out


def empty_launch(device: torch.device) -> None:
    """One launch of an empty kernel on the current stream: the floor a
    launch cannot go under.  Counts nothing."""
    with torch.cuda.device(device):
        err = _lib_sm90().seg_fanin_sm90_empty_launch(_stream(device))
    if err:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def check_layout(grp: np.ndarray, gstart: np.ndarray, sizes: np.ndarray,
                 kg: np.ndarray) -> None:
    """Raise unless every cell's groups lie contiguously in group order:
    gstart[0] = 0, gstart[g + 1] = gstart[g] + sizes[g], the groups fill
    at most F slots, grp names each slot's group there, every slot's grp
    is a group (the padded tail too) and every cap kg is >= 0."""
    C, F = grp.shape
    G = gstart.shape[1]
    if (sizes < 0).any():
        raise ValueError("seg_fanin_groups: a group size is negative")
    ends = np.cumsum(sizes, axis=1)
    starts = ends - sizes
    if not np.array_equal(gstart, starts):
        raise ValueError("seg_fanin_groups: the groups are not contiguous "
                         "(gstart != the running sum of sizes)")
    if G and (ends[:, -1] > F).any():
        raise ValueError(f"seg_fanin_groups: the groups fill more than "
                         f"F={F} slots")
    if (grp < 0).any() or (grp >= G).any():
        raise ValueError(f"seg_fanin_groups: a slot's group is outside "
                         f"[0, {G})")
    for c in range(C):
        n = int(ends[c, -1]) if G else 0
        if not np.array_equal(grp[c, :n], np.repeat(np.arange(G), sizes[c])):
            raise ValueError(f"seg_fanin_groups: cell {c}'s grp does not "
                             f"match its gstart/sizes layout")
    if (kg < 0).any():
        raise ValueError("seg_fanin_groups: a cap kg is negative")


class FaninGroups:
    """The step loop's fan-in for one grid, checked once at set-up:
    ``FaninGroups(grp, gstart, sizes, kg, B)`` takes the grid's per-cell
    layout (grp (C, F); gstart, sizes, kg (C, G); integer) and burst rows
    B; calling it with one step's ``arr_back`` (C, B, F) f32, ``peer_mask``
    (C, B, F) bool, ``B_r`` (C, B, G) f32, ``vcoef`` (rho - 1), ``md1``,
    ``c`` (c_repl) (C,) f32 and ``anchor`` (L1) (C, B) f32, all contiguous,
    returns mg (C, B, G) f32: the per-slot fan-in at each group's read slot
    clamp(gstart, 0, F - 1), as ``ref.seg_fanin_groups_ref`` defines it.

    On CPU tensors, or with ``plain=True``, every call runs that plain
    version.  On the card a call checks its inputs' type, shape and
    contiguity, allocates the output and launches ``seg_fanin_sm90.cu``:
    the layout, F and the rows were checked here, once."""

    def __init__(self, grp: torch.Tensor, gstart: torch.Tensor,
                 sizes: torch.Tensor, kg: torch.Tensor, rows_per_cell: int,
                 plain: bool = False):
        self.device = grp.device
        self.plain = plain or self.device.type == "cpu"
        C, F = grp.shape
        G = gstart.shape[1]
        B = rows_per_cell
        for name, t, shape in (("gstart", gstart, (C, G)),
                               ("sizes", sizes, (C, G)), ("kg", kg, (C, G))):
            if t.device != self.device:
                raise ValueError(f"seg_fanin_groups: {name} on {t.device}, "
                                 f"grp on {self.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"seg_fanin_groups: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
        for name, t in (("grp", grp), ("gstart", gstart), ("sizes", sizes),
                        ("kg", kg)):
            if t.dtype.is_floating_point or t.dtype == torch.bool:
                raise TypeError(f"seg_fanin_groups: {name} must be an "
                                f"integer tensor, got {t.dtype}")
        self.out_shape = (C, B, G)
        self.grp, self.gstart, self.kg = grp, gstart, kg
        if self.plain:
            return
        if self.device.type != "cuda":
            raise ValueError(f"seg_fanin_groups: unsupported device "
                             f"{self.device}")
        if F > F_MAX:
            raise ValueError(f"seg_fanin_groups: F={F} slots exceed the "
                             f"{F_MAX} a block's shared memory holds")
        if C * B * max(F, G) > INT32_MAX:
            raise ValueError(f"seg_fanin_groups: {C} x {B} rows overflow "
                             f"int32 offsets")
        i32 = lambda t: t.to(torch.int32).contiguous()
        self.grp, self.gstart, self.kg = i32(grp), i32(gstart), i32(kg)
        check_layout(self.grp.cpu().numpy(), self.gstart.cpu().numpy(),
                     sizes.cpu().numpy(), self.kg.cpu().numpy())
        f32 = torch.float32
        self._want = ((f32, (C, B, F)), (torch.bool, (C, B, F)),
                      (f32, (C, B, G)), (f32, (C,)), (f32, (C,)),
                      (f32, (C,)), (f32, (C, B)))
        self._plan = _Plan(self.grp.data_ptr(), self.gstart.data_ptr(),
                           self.kg.data_ptr(), C * B, F, G, B, *geometry(F))
        self._plan_ptr = ctypes.addressof(self._plan)
        self._fn = _lib_sm90().seg_fanin_sm90_groups_launch

    def __call__(self, arr_back, peer_mask, B_r, vcoef, md1, c, anchor):
        if self.plain:
            return seg_fanin_groups_ref(arr_back, peer_mask, B_r, self.grp,
                                        self.gstart, self.kg, vcoef, md1, c,
                                        anchor)
        args = (arr_back, peer_mask, B_r, vcoef, md1, c, anchor)
        for t, (dt, shape) in zip(args, self._want):
            if t.dtype != dt or t.shape != shape or not t.is_contiguous() \
                    or t.device != self.device:
                self._refuse(args)
        out = torch.empty(self.out_shape, dtype=torch.float32,
                          device=self.device)
        if torch.cuda.current_device() != self.device.index:
            with torch.cuda.device(self.device):
                err = self._launch(args, out)
        else:
            err = self._launch(args, out)
        if err:
            raise RuntimeError(f"seg_fanin_sm90 kernel launch failed: CUDA "
                               f"error {err}")
        global launches
        launches += 1
        return out

    def _launch(self, args, out) -> int:
        a, m, br, vc, md, cc, l1 = args
        return self._fn(self._plan_ptr, a.data_ptr(), m.data_ptr(),
                        br.data_ptr(), vc.data_ptr(), md.data_ptr(),
                        cc.data_ptr(), l1.data_ptr(), out.data_ptr(),
                        _stream(self.device))

    def _refuse(self, args):
        names = ("arr_back", "peer_mask", "B_r", "vcoef", "md1", "c",
                 "anchor")
        for name, t, (dt, shape) in zip(names, args, self._want):
            if t.device != self.device:
                raise ValueError(f"seg_fanin_groups: {name} on {t.device}, "
                                 f"the layout on {self.device}")
            if t.dtype != dt:
                raise TypeError(f"seg_fanin_groups: {name} must be {dt}, "
                                f"got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"seg_fanin_groups: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"seg_fanin_groups: {name} is not "
                                 f"contiguous")
        raise ValueError("seg_fanin_groups: inputs refused")
