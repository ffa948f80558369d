"""Counter-based random draws that reproduce ``jax.random`` bit for bit.

The batch model is specified by its random stream: the reference draws
every link jitter and relay choice from ``jax.random`` (threefry2x32 with
``jax_threefry_partitionable=True``).  Reproducing those bits in torch
makes port-vs-reference parity a per-cell comparison instead of a
statistical one.

Keys are int64 tensors of shape ``(..., 2)`` (e.g. one key per grid cell
and scan step) whose entries hold uint32 values; every intermediate is masked back to 32 bits.
torch's ``uint32`` dtype supports only part of the arithmetic, and int64
add/xor/shift are exact on the CPU and on the card alike, so the bits are
identical on both.

What each draw computes (the partitionable threefry layout):

* ``PRNGKey(s)``      -> ``[s >> 32, s & 0xFFFFFFFF]``
* ``fold_in(k, d)``   -> ``threefry(k, (0, d))``
* ``split(k, n)[j]``  -> ``threefry(k, (0, j))``
* ``bits(k, shape)``  -> ``x0 ^ x1`` of ``threefry(k, (0, i))`` over the
  row-major flat index ``i``
* ``uniform``         -> ``((bits >> 9) | 0x3F800000)`` read as f32, minus 1
* ``exponential``     -> ``-log1p(-uniform)``, with ``log1p`` evaluated in
  float64 and rounded to f32 (XLA's f32 ``log1p`` is not correctly
  rounded either way; the float64 detour makes the CPU and the card agree
  with each other, and both agree with XLA to 1 ulp)
* ``randint(k, shape, lo, hi)`` -> ``k1, k2 = split(k)``; with
  ``span = hi - lo`` (1 where ``hi <= lo``) and
  ``mult = ((2**16 % span)**2 mod 2**32) % span`` (0 for spans above
  2**16, where the square wraps),
  ``lo + ((bits(k1) % span) * mult + bits(k2) % span) % span``, every
  product and sum wrapping at 2**32 as JAX's uint32 arithmetic does
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 values.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``(2,)`` tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of every key in ``keys`` (..., 2) with ``data``: a
    Python int or an int64 tensor broadcastable against ``keys[..., 0]``
    (the result then has the broadcast shape plus the key axis)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split`` of every key in ``keys`` (..., 2) -> (..., num, 2)."""
    j = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(j), j)
    return torch.stack((y0, y1), dim=-1)


def bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element for every key in ``keys`` (..., 2):
    int64 tensor of shape ``(..., *shape)`` holding uint32 values."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("draws of 2**32 or more elements per key need the "
                         "high counter word, which is not ported")
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(i), i)
    return (y0 ^ y1).reshape(keys.shape[:-1] + tuple(shape))


def uniform(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32 in [0, 1)) per key."""
    fb = (bits(keys, shape) >> 9) | 0x3F800000
    return torch.clamp_min(fb.to(torch.int32).view(torch.float32) - 1.0, 0.0)


def exponential(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.exponential(key, shape)`` (f32) per key, to 1 ulp."""
    u = uniform(keys, shape).to(torch.float64)
    return (-torch.log1p(-u)).to(torch.float32)


def randint(keys: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 dtype, as
    JAX draws it without x64) per key, bit for bit: an int64 tensor of
    shape ``(..., *shape)``.  Spans up to 2**31 - 1."""
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    if span >= 2 ** 31:
        raise ValueError(f"randint: span {span} exceeds int32's range")
    ks = split(keys)
    hi, lo = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return minval + off % span
