"""Launch wrappers of the Hopper flash-attention kernels, the counterparts
of ``repro.kernels.flash_attention.flash_attention_bhsd``: causal (or full)
attention with GQA.

Two kernels serve a CUDA tensor, chosen from its dtype and head dim alone:

- ``csrc/flash_attention_sm90.cu`` (wgmma, TMA, P as bf16 hi + lo) takes
  bf16 at Dh 64, 128 and 256.  It reads q, k, v and writes o through 4-D
  tensor maps with byte strides, so it serves (B, H, S, Dh) and the
  model's (B, S, H, Dh) alike, with no copy;
- ``csrc/flash_attention.cu`` (f32 on the CUDA cores) takes f32, and bf16
  at Dh 32, in (B, H, S, Dh) only.

Anything else raises; nothing falls back from one kernel to the other or
to the plain version.  ``flash_attention_padded`` serves the other head
dims up to 256 as the JAX package's wrapper does: zeros pad Dh up to the
next size the kernel takes (``padded_head_dim``) and the scale stays
1/sqrt of the unpadded Dh.  A CPU tensor goes to the plain version
(``ref.flash_attention_ref``).  ``launches`` counts every kernel launch,
``launches_sm90`` those of the sm90 kernel alone.
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
launches_sm90 = 0

HEAD_DIMS = (32, 64, 128, 256)
SM90_HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535          # heads and batch are the grid's y and z
TMA_ALIGN = 16               # bytes: TMA's rule for base pointers and strides
# the sm90 launcher's own error codes (csrc/flash_attention_sm90.cu)
ENCODE_UNAVAILABLE, ENCODE_FAILED = 9999, 10000


@functools.cache
def _launcher():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher_sm90():
    lib = build.load("flash_attention_sm90")
    fn = lib.flash_attention_sm90_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bhsd(t: torch.Tensor, layout: str):
    """(B, H, S, Dh) and their element strides, from either layout."""
    if layout == "bhsd":
        return tuple(t.shape), t.stride()
    B, S, H, Dh = t.shape
    sb, ss, sh, sd = t.stride()
    return (B, H, S, Dh), (sb, sh, ss, sd)


def tensor_map_args(t: torch.Tensor, layout: str):
    """The sm90 kernel's tensor-map arguments for ``t`` in ``layout``
    ("bhsd" or "bshd"): dims (Dh, S, H, B) and the byte strides of S, H and
    B.  Raises unless the head dim is contiguous and, as TMA requires, the
    base pointer and the strides are multiples of 16 bytes."""
    name = f"flash_attention_{layout}"
    (B, H, S, Dh), (sb, sh, ss, sd) = _bhsd(t, layout)
    if sd != 1 and Dh > 1:
        raise ValueError(f"{name}: the head dim is not contiguous (stride "
                         f"{sd})")
    size = t.element_size()
    strides = (ss * size, sh * size, sb * size)
    for dim, stride in zip("SHB", strides):
        if stride % TMA_ALIGN:
            raise ValueError(f"{name}: the {dim} stride of {stride} bytes is "
                             f"not a multiple of {TMA_ALIGN} (TMA)")
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name}: not {TMA_ALIGN}-byte aligned (TMA)")
    return (Dh, S, H, B), strides


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           layout: str) -> None:
    name = f"flash_attention_{layout}"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    for n, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {n} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype}; the kernels take "
                        f"{sorted(map(str, DTYPES))}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: {n} has rank {t.dim()}, expected "
                             f"({', '.join(layout.upper())})")
    B, Hq, Sq, Dh = _bhsd(q, layout)[0]
    Bk, Hkv, Sk, Dk = _bhsd(k, layout)[0]
    if Bk != B or Dk != Dh or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads are not a multiple of "
                         f"{Hkv} KV heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} unsupported; the kernels "
                         f"take {HEAD_DIMS}")


def padded_head_dim(dtype: torch.dtype, Dh: int) -> int:
    """The head dim a kernel serves ``Dh`` at: Dh itself where a kernel
    takes it, else the next size that the kernel for ``dtype`` takes (bf16:
    the sm90 kernel's 64/128/256; f32: 32/64/128/256).  Raises above 256."""
    if Dh in HEAD_DIMS:
        return Dh
    sizes = SM90_HEAD_DIMS if dtype == torch.bfloat16 else HEAD_DIMS
    for size in sizes:
        if Dh < size:
            return size
    raise ValueError(f"flash_attention: head dim {Dh} exceeds the kernels' "
                     f"limit of {sizes[-1]}")


def flash_attention_padded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           attend=None) -> torch.Tensor:
    """The model's layout at any head dim up to 256: q, k, v padded with
    zeros along Dh to ``padded_head_dim`` (zero channels add nothing to
    q . k, and the padded output channels are dropped), ``attend`` (by
    default ``flash_attention_bshd``) called with sm_scale = 1/sqrt of the
    unpadded Dh, and the result sliced back to Dh.  A head dim that a
    kernel takes is passed through unchanged, with no copy."""
    attend = flash_attention_bshd if attend is None else attend
    Dh = q.shape[-1]
    size = padded_head_dim(q.dtype, Dh)
    if size == Dh:
        return attend(q, k, v, causal=causal)
    pad = lambda t: torch.nn.functional.pad(t, (0, size - Dh))
    out = attend(pad(q), pad(k), pad(v), causal=causal,
                 sm_scale=1.0 / math.sqrt(Dh))
    return out[..., :Dh]


def _uses_sm90(q: torch.Tensor) -> bool:
    return q.dtype == torch.bfloat16 and q.shape[-1] in SM90_HEAD_DIMS


def _launch_sm90(q, k, v, layout, causal, scale):
    B, Hq, Sq, Dh = _bhsd(q, layout)[0]
    Hkv, Sk = _bhsd(k, layout)[0][1:3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    geom = []
    for t in (q, k, v, out):
        dims, strides = tensor_map_args(t, layout)
        geom += [*dims, *strides]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher_sm90()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), (ctypes.c_longlong * 28)(*geom),
                               B, Hq, Hkv, Sq, Sk, Dh, int(causal), scale,
                               stream)
    if err >= ENCODE_FAILED:
        raise RuntimeError(f"flash_attention_sm90: cuTensorMapEncodeTiled "
                           f"failed with CUresult {err - ENCODE_FAILED}")
    if err == ENCODE_UNAVAILABLE:
        raise RuntimeError("flash_attention_sm90: cuTensorMapEncodeTiled is "
                           "not available")
    if err:
        raise RuntimeError(f"flash_attention_sm90 kernel launch failed: CUDA "
                           f"error {err}")
    global launches, launches_sm90
    launches += 1
    launches_sm90 += 1
    return out


def _launch_f32(q, k, v, causal, scale):
    """The CUDA-core kernel, (B, H, S, Dh) contiguous."""
    B, Hq, Sq, Dh = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bhsd: B={B}, Hq={Hq} exceed the "
                         f"grid's {MAX_GRID_YZ}")
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


def _plain(q, k, v, causal, sm_scale, layout):
    if sm_scale is not None and sm_scale != 1.0 / math.sqrt(q.shape[-1]):
        raise ValueError(f"flash_attention_{layout}: the plain version takes "
                         f"only sm_scale = 1/sqrt(Dh)")
    if layout == "bhsd":
        return flash_attention_ref(q, k, v, causal=causal)
    t = lambda a: a.transpose(1, 2)
    return t(flash_attention_ref(t(q), t(k), t(v), causal=causal))


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, Dh); k/v: (B, Hkv, Sk, Dh), Hq a multiple of Hkv, the
    same dtype (bf16 or f32), contiguous.  Any Sq and Sk (the kernels mask
    the ragged edge).  Returns (B, Hq, Sq, Dh) in q's dtype."""
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, sm_scale, "bhsd")
    _check(q, k, v, "bhsd")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bhsd: {n} is not contiguous")
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention_bhsd: {n} is not 16-byte "
                             f"aligned (the kernels load 16 bytes at a time)")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if _uses_sm90(q):
        return _launch_sm90(q, k, v, "bhsd", causal, scale)
    return _launch_f32(q, k, v, causal, scale)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """The model's layout: q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh), Hq a
    multiple of Hkv, the same dtype.  Returns (B, Sq, Hq, Dh) in q's dtype.

    bf16 at Dh 64/128/256 (the models' prefill) goes to the sm90 kernel,
    which reads the tensors where they lie and writes the (B, Sq, Hq, Dh)
    output itself: the head dim must be contiguous, the pointers and the
    other strides multiples of 16 bytes (the model's contiguous tensors
    are).  f32, or Dh 32, is off the main path: it is transposed to
    (B, H, S, Dh) with copies, served by the CUDA-core kernel, and
    returned as a transposed view."""
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, sm_scale, "bshd")
    _check(q, k, v, "bshd")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    if _uses_sm90(q):
        return _launch_sm90(q, k, v, "bshd", causal, scale)
    t = lambda a: a.transpose(1, 2).contiguous()
    return flash_attention_bhsd(t(q), t(k), t(v), causal=causal,
                                sm_scale=sm_scale).transpose(1, 2)
