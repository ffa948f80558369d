"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what the card's kernels are held against bit for bit."""
from __future__ import annotations

import torch

from ..core.segscan import seg_cummax, seg_start_index


def _fanin_plain(vals, coef, segid, kcap, vcoef, md1, c, anchor):
    """vals/coef (..., B, F); segid/kcap (..., F); vcoef/md1/c/anchor
    broadcastable against (..., B, 1)."""
    f32 = torch.float32
    F = vals.shape[-1]
    vals = vals.to(f32)
    segid = segid.to(torch.int64)
    kcap = kcap.to(torch.int64)
    sid_b = segid.unsqueeze(-2).expand(vals.shape)
    # two-key stable sort as two stable passes, value first and then the
    # segment: segment blocks stay in place with their values ascending,
    # ties in slot order (the reference's lexicographic lax.sort)
    v1, o1 = torch.sort(vals, dim=-1, stable=True)
    _, o2 = torch.sort(torch.gather(sid_b, -1, o1), dim=-1, stable=True)
    arr_s = torch.gather(v1, -1, o2)
    first = torch.ones_like(segid, dtype=torch.bool)
    first[..., 1:] = segid[..., 1:] != segid[..., :-1]
    gsl = seg_start_index(first).to(torch.int64)               # (..., F)
    iota = torch.arange(F, device=vals.device)
    last = torch.ones_like(first)
    last[..., :-1] = first[..., 1:]
    # each slot's segment end: reverse running min of the end indices
    gel = torch.where(last, iota, F).flip(-1).cummin(-1).values.flip(-1)
    posf = (iota - gsl).to(f32).unsqueeze(-2)
    y = arr_s + torch.clamp_min(coef.to(f32) + vcoef * (arr_s - anchor),
                                0.0) + md1 - posf * c
    # masked (+inf) slots never enter the max: an empty set gives -inf
    y = torch.where(arr_s < torch.inf, y, -torch.inf)
    pref = seg_cummax(y, first.unsqueeze(-2))
    idx = torch.minimum(gsl + kcap, gel).unsqueeze(-2).expand(vals.shape)
    return torch.gather(pref, -1, idx)


def seg_fanin_ref(vals, coef, segid, kcap, vcoef, md1, c, anchor):
    """Segmented quorum fan-in, the plain version (port of
    ``repro.kernels.ref.seg_fanin_ref``, with the kernel's semantics outside
    its preconditions: +inf slots are excluded and an empty admissible set
    gives -inf).

    vals/coef: (..., B, F) f32, +inf = masked slot; segid/kcap: (..., F)
    per-slot segment id and order-statistic cap, both segment-constant, in
    contiguous segments; vcoef/md1/c: scalars or (...,) per leading index;
    anchor: (..., B).  Returns (..., B, F): each slot's capped segment max.
    """
    lead = vals.shape[:-2]

    def col(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=vals.device)
        return x.reshape(lead + (1, 1)) if x.dim() else x

    anchor = torch.as_tensor(anchor, dtype=torch.float32,
                             device=vals.device).unsqueeze(-1)
    return _fanin_plain(vals, coef, segid, kcap, col(vcoef), col(md1),
                        col(c), anchor)


def seg_fanin_rows_ref(vals, coef, segid, kcap, scal, rows_per_cell: int):
    """The plain version in the kernel's own layout: vals/coef (R, F) with
    R = cells x rows_per_cell, segid/kcap (C, F) once per cell, scal (R, 4)
    rows of [vcoef, md1, c, anchor]."""
    C, F = segid.shape
    shape = (C, rows_per_cell)
    s = scal.reshape(shape + (4,))
    out = _fanin_plain(vals.reshape(shape + (F,)), coef.reshape(shape + (F,)),
                       segid, kcap, s[..., 0:1], s[..., 1:2], s[..., 2:3],
                       s[..., 3:4])
    return out.reshape(vals.shape)
