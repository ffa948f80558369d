"""Launch wrapper of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the counterpart of
``repro.kernels.flash_attention.flash_attention_bhsd``: causal (or full)
attention with GQA in the (B, H, S, Dh) layout.

A CPU tensor goes to the plain version (``ref.flash_attention_ref``); a
CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build
from .ref import flash_attention_ref

launches = 0

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535          # heads and batch are the grid's y and z


@functools.cache
def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bhsd: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bhsd: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bhsd: dtype {q.dtype}; the kernel "
                        f"takes {sorted(map(str, DTYPES))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention_bhsd: {name} has rank "
                             f"{t.dim()}, expected (B, H, S, Dh)")
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention_bhsd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_bhsd: {Hq} query heads are not a "
                         f"multiple of {Hkv} KV heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: head dim {Dh} unsupported; "
                         f"the kernel takes {HEAD_DIMS}")
    if Hq > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bhsd: B={B}, Hq={Hq} exceed the "
                         f"grid's {MAX_GRID_YZ}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bhsd: {name} is not "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bhsd: {name} is not 16-byte "
                             f"aligned (the kernel loads 16 bytes at a time)")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, Dh); k/v: (B, Hkv, Sk, Dh), Hq a multiple of Hkv, the
    same dtype (bf16 or f32), contiguous.  Any Sq and Sk (the kernel masks
    the ragged edge).  Returns (B, Hq, Sq, Dh) in q's dtype."""
    if q.device.type == "cpu":
        if sm_scale is not None and sm_scale != 1.0 / math.sqrt(q.shape[-1]):
            raise ValueError("flash_attention_bhsd: the plain version takes "
                             "only sm_scale = 1/sqrt(Dh)")
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device "
                         f"{q.device}")
    _check(q, k, v)
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Sk, _ = k.shape
    scale = 1.0 / math.sqrt(Dh) if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, Hq, Hkv, Sq, Sk, Dh,
                          DTYPES[q.dtype], int(causal), scale, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
