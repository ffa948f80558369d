"""Segmented scans over flat group-contiguous layouts (port of
``repro.core.segscan``).

torch has no ``associative_scan``, so the (value, start-flag) scan is a
log-step Hillis-Steele doubling: at distance d every slot combines with
the slot d to its left, and the start flag stops the carry at segment
boundaries.  Max is exact, so the result equals the reference bit for
bit.  ``seg_cumsum`` serves only the fault-mask path and is not ported
yet.
"""
from __future__ import annotations

import torch


def seg_cummax(x: torch.Tensor, first: torch.Tensor, dim: int = -1
               ) -> torch.Tensor:
    """Within-segment inclusive cumulative max along ``dim``; ``first``
    (bool, broadcastable against ``x``) marks segment starts."""
    dim = dim % x.dim()
    v = x
    f = torch.broadcast_to(first, x.shape)
    n = x.shape[dim]
    d = 1
    while d < n:
        vl = v.narrow(dim, 0, n - d)
        fl = f.narrow(dim, 0, n - d)
        vr = v.narrow(dim, d, n - d)
        fr = f.narrow(dim, d, n - d)
        v = torch.cat((v.narrow(dim, 0, d),
                       torch.where(fr, vr, torch.maximum(vl, vr))), dim=dim)
        f = torch.cat((f.narrow(dim, 0, d), fl | fr), dim=dim)
        d *= 2
    return v


def seg_start_index(first: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of each slot's segment start, from the start flags alone."""
    dim = dim % first.dim()
    n = first.shape[dim]
    shape = [1] * first.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.float32,
                        device=first.device).reshape(shape)
    iota = torch.broadcast_to(iota, first.shape)
    start = torch.where(first, iota, torch.full_like(iota, -torch.inf))
    return seg_cummax(start, first, dim=dim).to(torch.int32)
