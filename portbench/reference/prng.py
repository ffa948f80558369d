"""Threefry-2x32 counter-based draws, written from the cipher's
specification (Salmon et al., SC 2011) in the layout that
``jax.random`` uses with ``jax_threefry_partitionable=True``.

The batch model is defined by its random stream: every link jitter, relay
choice, coordinator and key of a cell is a function of the cell's key and
the scan step.  The reference draws the same stream, so the program and
the reference can be compared cell by cell.

Keys are int64 tensors ``(..., 2)`` holding uint32 words; every
intermediate is masked back to 32 bits, which is exact on any device.

* ``key(s)``          -> ``[s >> 32, s & 0xFFFFFFFF]``
* ``fold_in(k, d)``   -> ``threefry(k, (0, d))``
* ``split(k, n)[j]``  -> ``threefry(k, (0, j))``
* ``bits(k, shape)``  -> ``x0 ^ x1`` of ``threefry(k, (0, i))`` over the
  row-major flat index ``i``
* ``uniform``         -> ``((bits >> 9) | 0x3F800000)`` read as f32, minus 1
* ``exponential``     -> ``-log1p(-uniform)``, ``log1p`` taken in float64
  and rounded once to f32
* ``randint(k, shape, lo, hi)`` -> with ``k1, k2 = split(k)``,
  ``span = hi - lo`` and ``mult = ((2**16 % span)**2 mod 2**32) % span``:
  ``lo + ((bits(k1) % span) * mult + bits(k2) % span) % span``, products
  and sums wrapping at 2**32
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32 on broadcastable int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(keys, data):
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(keys, num=2):
    j = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(j), j)
    return torch.stack((y0, y1), dim=-1)


def bits(keys, shape):
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(i), i)
    return (y0 ^ y1).reshape(keys.shape[:-1] + tuple(shape))


def uniform(keys, shape):
    fb = (bits(keys, shape) >> 9) | 0x3F800000
    return torch.clamp_min(fb.to(torch.int32).view(torch.float32) - 1.0, 0.0)


def exponential(keys, shape):
    u = uniform(keys, shape).to(torch.float64)
    return (-torch.log1p(-u)).to(torch.float32)


def randint(keys, shape, lo, hi):
    span = hi - lo if hi > lo else 1
    ks = split(keys)
    a, b = bits(ks[..., 0, :], shape), bits(ks[..., 1, :], shape)
    mult = (((2 ** 16 % span) ** 2) & M32) % span
    off = ((((a % span) * mult) & M32) + (b % span)) & M32
    return lo + off % span
