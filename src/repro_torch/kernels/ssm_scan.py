"""Launch wrappers of the Hopper chunked-scan kernels, the counterparts of
``repro.kernels.ssm_scan.ssm_scan_bhtd``, in the model's (B, T, H, D)
layout and with an initial and a final state.

Two kernels serve a CUDA tensor, chosen from its dtype and shape alone
(``uses_sm90``):

- ``csrc/ssm_scan_sm90.cu`` (3xTF32 mma.sync, one block per head and 64
  state columns) takes bf16 and f32 at Dk 64, Dv a multiple of 64 and
  chunk 16: rwkv6's prefill;
- ``csrc/ssm_scan.cu`` (f32 on the CUDA cores, 16-column slabs) takes the
  rest: Dk and chunk in (16, 32, 64), Dv a multiple of 16.

Neither falls back to the other or to the plain version: a build or launch
failure raises.  A CPU tensor goes to the plain version
(``ref.ssm_scan_ref``).  ``launches`` counts every kernel launch,
``launches_sm90`` those of the sm90 kernel alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .ref import ssm_scan_ref

launches = 0
launches_sm90 = 0

DIMS = (16, 32, 64)          # Dk and chunk the kernel is built for
SLAB = 16                    # state columns a block owns: Dv % SLAB == 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535          # heads and batch are the grid's y and z
SM90_DK, SM90_COLS, SM90_CHUNK = 64, 64, 16   # what ssm_scan_sm90.cu takes
ALIGN = 16                   # bytes: the sm90 kernel copies 16 at a time


def uses_sm90(dtype: torch.dtype, Dk: int, Dv: int, chunk: int) -> bool:
    """The dispatch rule: which inputs go to ``csrc/ssm_scan_sm90.cu``
    (the rest go to ``csrc/ssm_scan.cu``)."""
    return (dtype in DTYPES and Dk == SM90_DK and chunk == SM90_CHUNK
            and Dv > 0 and Dv % SM90_COLS == 0)


@functools.cache
def _launcher():
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher_sm90():
    lib = build.load("ssm_scan_sm90")
    fn = lib.ssm_scan_sm90_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, log_a, u, chunk, s0) -> None:
    named = [("k", k), ("v", v), ("log_a", log_a), ("u", u), ("s0", s0)]
    for name, t in named:
        if t is not None and t.device != q.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"ssm_scan: q is {q.dtype}; the kernel takes "
                        f"{sorted(map(str, DTYPES))}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"ssm_scan: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("log_a", log_a), ("u", u), ("s0", s0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} is {t.dtype}; it must be "
                            f"torch.float32")
    for name, t in (("q", q), ("k", k), ("v", v), ("log_a", log_a)):
        if t.dim() != 4:
            raise ValueError(f"ssm_scan: {name} has rank {t.dim()}, expected "
                             f"(B, T, H, D)")
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    if (tuple(k.shape) != tuple(q.shape)
            or tuple(log_a.shape) != tuple(q.shape)
            or tuple(v.shape[:3]) != (B, T, H)):
        raise ValueError(f"ssm_scan: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_a "
                         f"{tuple(log_a.shape)} disagree")
    if u is not None and tuple(u.shape) != (H, Dk):
        raise ValueError(f"ssm_scan: u has shape {tuple(u.shape)}, expected "
                         f"{(H, Dk)}")
    if s0 is not None and tuple(s0.shape) != (B, H, Dk, Dv):
        raise ValueError(f"ssm_scan: s0 has shape {tuple(s0.shape)}, "
                         f"expected {(B, H, Dk, Dv)}")
    if chunk not in DIMS:
        raise ValueError(f"ssm_scan: chunk {chunk} unsupported; the kernel "
                         f"takes {DIMS}")
    if Dk not in DIMS:
        raise ValueError(f"ssm_scan: Dk {Dk} unsupported; the kernel takes "
                         f"{DIMS}")
    if Dv % SLAB or Dv == 0:
        raise ValueError(f"ssm_scan: Dv {Dv} is not a positive multiple of "
                         f"{SLAB}")
    if not (1 <= B <= MAX_GRID_YZ and 1 <= H <= MAX_GRID_YZ):
        raise ValueError(f"ssm_scan: B={B}, H={H} outside the grid's "
                         f"[1, {MAX_GRID_YZ}]")
    for name, t in (("q", q), ("k", k), ("v", v), ("log_a", log_a),
                    ("u", u), ("s0", s0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} is not contiguous")


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, u: Optional[torch.Tensor] = None,
             chunk: int = 64, s0: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """q/k (B, T, H, Dk) and v (B, T, H, Dv), one dtype (bf16 or f32);
    log_a (B, T, H, Dk) f32, the per-channel log-decay; u (H, Dk) f32 bonus
    (RWKV6: the strict mask) or None (Mamba2: the inclusive mask); s0
    (B, H, Dk, Dv) f32 or None (zeros); all contiguous.  Any T (the kernel
    treats rows past T as a decay of 1 and no kv).  Returns y (B, T, H, Dv)
    in v's dtype and, with ``return_state``, the final state (B, H, Dk, Dv)
    f32.  The kernels take Dk and chunk in (16, 32, 64), Dv a multiple of
    16, and B, H >= 1 (T = 0 returns s0 as the state); ``uses_sm90`` says
    which kernel serves a call."""
    if q.device.type == "cpu":
        return ssm_scan_ref(q, k, v, log_a, u=u, chunk=chunk, s0=s0,
                            return_state=return_state)
    if q.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {q.device}")
    _check(q, k, v, log_a, u, chunk, s0)
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    y = torch.empty_like(v)
    state = (torch.empty((B, H, Dk, Dv), dtype=torch.float32,
                         device=q.device) if return_state else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    sm90 = uses_sm90(q.dtype, Dk, Dv, chunk)
    if sm90:
        for name, t in (("q", q), ("k", k), ("v", v), ("log_a", log_a)):
            if t.data_ptr() % ALIGN:
                raise ValueError(f"ssm_scan_sm90: {name} is not {ALIGN}-byte "
                                 f"aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if sm90:
            err = _launcher_sm90()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   log_a.data_ptr(), ptr(u), ptr(s0),
                                   y.data_ptr(), ptr(state), B, T, H, Dv,
                                   DTYPES[q.dtype], stream)
        else:
            err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              log_a.data_ptr(), ptr(u), ptr(s0), y.data_ptr(),
                              ptr(state), B, T, H, Dk, Dv, chunk,
                              DTYPES[q.dtype], stream)
    if err:
        kernel = "ssm_scan_sm90" if sm90 else "ssm_scan"
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    global launches, launches_sm90
    launches += 1
    launches_sm90 += int(sm90)
    return (y, state) if return_state else y
