"""Pig relay aggregation: the counterpart of
``repro.kernels.pig_aggregate``.

``pig_aggregate`` is the launch wrapper of the Hopper kernel
(``csrc/pig_aggregate.cu``): the fused dequantize + sum of the int8 shards
that the G pods send the relay.  A CPU tensor goes to the plain version
(``ref.pig_aggregate_ref``); a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and nothing else.

``quantize_blockwise`` is plain PyTorch, as the reference's is plain jnp.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import pig_aggregate_ref

launches = 0

PER_THREAD = 16          # outputs a thread owns: one 16-byte int8 load a row
THREADS = 256
MAX_BLOCKS = 132 * 32    # 132 SMs; the grid-stride loop covers the rest


@functools.cache
def _launcher():
    lib = build.load("pig_aggregate")
    fn = lib.pig_aggregate_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_blockwise(x: torch.Tensor, block: int = 1024) -> tuple:
    """Symmetric per-block int8 quantization, as the reference's: x (N,) ->
    (int8 (N,), f32 scales (N // block,)), scale = max(amax, 1e-12) / 127,
    q = clip(round(x / scale), -127, 127) with ties to even.  The divisor
    127 is a tensor: PyTorch's CUDA division by a Python scalar multiplies
    by its rounded reciprocal, which would make the card's scales differ
    from the CPU's (and from the reference's jnp division) by an ulp."""
    N = x.shape[0]
    xb = x.reshape(N // block, block).to(torch.float32)
    amax = xb.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(
        torch.int8)
    return q.reshape(N), scale


def _check(shards: torch.Tensor, scales: torch.Tensor, block: int) -> None:
    if scales.device != shards.device:
        raise ValueError(f"pig_aggregate: scales on {scales.device}, shards "
                         f"on {shards.device}")
    if shards.dtype != torch.int8:
        raise TypeError(f"pig_aggregate: shards must be torch.int8, got "
                        f"{shards.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"pig_aggregate: scales must be torch.float32, got "
                        f"{scales.dtype}")
    if shards.dim() != 2 or shards.shape[0] < 1:
        raise ValueError(f"pig_aggregate: shards has shape "
                         f"{tuple(shards.shape)}, expected (G, N), G >= 1")
    G, N = shards.shape
    if block < 1 or N % block:
        raise ValueError(f"pig_aggregate: N={N} is not a multiple of "
                         f"block={block}")
    if tuple(scales.shape) != (G, N // block):
        raise ValueError(f"pig_aggregate: scales has shape "
                         f"{tuple(scales.shape)}, expected {(G, N // block)}")
    for name, t in (("shards", shards), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"pig_aggregate: {name} is not contiguous")


def pig_aggregate(shards: torch.Tensor, scales: torch.Tensor,
                  block: int = 1024) -> torch.Tensor:
    """shards: (G, N) int8 with N % block == 0; scales: (G, N // block) f32,
    both contiguous.  Returns (N,) f32: the dequantized sum across the G
    shards.  The kernel also needs block % 16 == 0 and 16-byte aligned
    shards."""
    if shards.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pig_aggregate: unsupported device "
                         f"{shards.device}")
    _check(shards, scales, block)
    if shards.device.type == "cpu":
        return pig_aggregate_ref(shards, scales, block)
    if block % PER_THREAD:
        raise ValueError(f"pig_aggregate: block={block} is not a multiple "
                         f"of {PER_THREAD} (the kernel's outputs a thread)")
    if shards.data_ptr() % 16:
        raise ValueError("pig_aggregate: shards is not 16-byte aligned (the "
                         "kernel loads 16 bytes at a time)")
    G, N = shards.shape
    out = torch.empty(N, dtype=torch.float32, device=shards.device)
    if N == 0:
        return out
    blocks = min(MAX_BLOCKS, -(-(N // PER_THREAD) // THREADS))
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(shards.data_ptr(), scales.data_ptr(),
                          out.data_ptr(), G, N, block, blocks, THREADS,
                          stream)
    if err:
        raise RuntimeError(f"pig_aggregate kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
