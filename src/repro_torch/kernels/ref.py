"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what the card's kernels are held against (bit for bit where the kernel
keeps the plain version's order of operations, else within a stated
tolerance)."""
from __future__ import annotations

import torch

from typing import Optional

from .. import prng
from ..core.segscan import seg_cummax, seg_start_index
from ..models.layers import attention_ref
from ..models.ssm import chunked_linear_scan


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B,Hq,Sq,Dh); k/v: (B,Hkv,Sk,Dh) -> (B,Hq,Sq,Dh), through the
    model's ``attention_ref`` (port of ``repro.kernels.ref
    .flash_attention_ref``).  Non-causal: every query sits at position
    Sk - 1, so it sees every key."""
    B, Hq, Sq, Dh = q.shape
    Sk = k.shape[2]
    dev = q.device
    q_pos = torch.arange(Sq, device=dev).expand(B, Sq)
    if not causal:
        q_pos = torch.full((B, Sq), Sk - 1, device=dev)
    k_pos = torch.arange(Sk, device=dev).expand(B, Sk)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), q_pos, k_pos)
    return out.transpose(1, 2)


def ssm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, u: Optional[torch.Tensor] = None,
                 chunk: int = 64, s0: Optional[torch.Tensor] = None,
                 return_state: bool = False):
    """The chunked linear recurrence in the model layout, the plain version
    of the ``ssm_scan`` kernel: q/k/log_a (B,T,H,Dk), v (B,T,H,Dv), u (H,Dk)
    bonus or None, s0 (B,H,Dk,Dv) or None.  Returns y (B,T,H,Dv) in v's
    dtype and, with ``return_state``, the final f32 state.

    Delegates to the port's ``chunked_linear_scan`` in its per-channel form
    (as ``repro.kernels.ref.ssm_scan_ref`` does).  T is padded to a
    multiple of ``chunk`` with zeros: a log_a of 0 is a decay of 1 and a kv
    of 0 adds nothing, so the padded steps leave the state unchanged."""
    T = q.shape[1]
    pad = (-T) % chunk
    if pad:
        q, k, v, log_a = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (q, k, v, log_a))
    out = chunked_linear_scan(q, k, v, log_a, chunk, bonus=u, s0=s0,
                              return_state=return_state)
    if not return_state:
        return out[:, :T]
    y, state = out
    return y[:, :T], state


def ssm_scan_bhtd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_a: torch.Tensor, u: Optional[torch.Tensor] = None,
                      chunk: int = 64) -> torch.Tensor:
    """``repro.kernels.ssm_scan.ssm_scan_bhtd``'s signature: q/k/log_a
    (BH, T, Dk), v (BH, T, Dv), u (BH, Dk) or None; returns (BH, T, Dv).
    The BH rows are independent heads of one batch row, so each row's u is
    its head's bonus."""
    heads = lambda a: a.transpose(0, 1)[None]      # (BH,T,D) -> (1,T,BH,D)
    y = ssm_scan_ref(heads(q), heads(k), heads(v), heads(log_a), u=u,
                     chunk=chunk)
    return y[0].transpose(0, 1)


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


def seg_fanin_groups_ref(arr_back, peer_mask, B_r, grp, gstart, kg, vcoef,
                         md1, c, anchor):
    """The step loop's grouped fan-in, the plain version: the per-slot
    fan-in of ``vals = where(peer_mask, arr_back, +inf)`` with
    ``coef = B_r[grp]``, segment ids grp and caps ``kg[grp]``, read at each
    group's slot clamp(gstart, 0, F - 1) (as ``repro.core.vectorsim``
    reads it).  arr_back (C, B, F) f32, peer_mask (C, B, F) bool, B_r
    (C, B, G) f32, grp (C, F), gstart and kg (C, G); vcoef/md1/c (C,) or
    scalars, anchor (C, B).  Returns (C, B, G)."""
    C, B, F = arr_back.shape
    G = gstart.shape[-1]
    grp = grp.to(torch.int64)
    vals = torch.where(peer_mask, arr_back, torch.inf)
    coef = torch.gather(B_r, 2, grp[:, None, :].expand(C, B, F))
    kcap = torch.gather(kg.to(torch.int64), 1, grp)
    m = seg_fanin_ref(vals, coef, grp, kcap, vcoef, md1, c, anchor)
    gread = torch.clamp(gstart.to(torch.int64), 0, F - 1)
    return torch.gather(m, 2, gread[:, None, :].expand(C, B, G))


def pig_aggregate_ref(shards: torch.Tensor, scales: torch.Tensor,
                      block: int = 1024) -> torch.Tensor:
    """The relay's dequantize-and-sum, the plain version (port of
    ``repro.kernels.ref.pig_aggregate_ref``): shards (G, N) int8, scales
    (G, N // block) f32 -> (N,) f32 = sum_g shards[g] * scales[g, n // block].

    The sum runs over g in ascending order from 0.0, each product rounded
    on its own, which fixes the order of operations so that the card's
    kernel can be held to it bit for bit."""
    G, N = shards.shape
    acc = torch.zeros(N // block, block, dtype=torch.float32,
                      device=shards.device)
    for g in range(G):
        acc = acc + shards[g].view(-1, block).float() * scales[g, :, None]
    return acc.view(N)


def group_draws_ref(key: torch.Tensor, i0: int, n: int, B: int, n_draw: int,
                    G: int, read: bool = False):
    """The group step loop's draw block, the plain version: for the cells'
    keys (C, 2) and the steps s in [i0, i0 + n), ``k1, k2 =
    split(fold_in(key, s))`` and the draws ``exponential(k1, (B, n_draw))``
    (C, n, B, n_draw), ``uniform(k2, (B, G))`` (C, n, B, G) and, with
    ``read``, ``uniform(fold_in(k2, 1), (B,))`` (C, n, B), else None; f32,
    through ``prng``'s threefry on int64."""
    idx = torch.arange(i0, i0 + n, device=key.device)
    ks = prng.split(prng.fold_in(key[:, None, :], idx))     # (C, n, 2, 2)
    e = prng.exponential(ks[:, :, 0], (B, n_draw))
    u = prng.uniform(ks[:, :, 1], (B, G))
    r = (prng.uniform(prng.fold_in(ks[:, :, 1], 1), (B,)) if read
         else None)
    return e, u, r


def epaxos_draws_ref(key: torch.Tensor, i0: int, b: int, n: int):
    """The EPaxos step loop's draw block, the plain version: for the cells'
    keys (C, 2) and the steps s in [i0, i0 + b), ``split(fold_in(key, s),
    5)`` and the reference's five draws in its order: the coordinator
    ``randint(k0, (), 0, n)`` (C, b) int64, ``exponential(k1, (2,))`` (C,
    b, 2), ``exponential(k2, (n,))`` and ``exponential(k3, (n,))`` (C, b,
    n) and ``uniform(k4, ())`` (C, b); f32 draws, through ``prng``'s
    threefry on int64."""
    idx = torch.arange(i0, i0 + b, device=key.device)
    ks = prng.split(prng.fold_in(key[:, None, :], idx), 5)    # (C, b, 5, 2)
    return (prng.randint(ks[:, :, 0], (), 0, n),
            prng.exponential(ks[:, :, 1], (2,)),
            prng.exponential(ks[:, :, 2], (n,)),
            prng.exponential(ks[:, :, 3], (n,)),
            prng.uniform(ks[:, :, 4], ()))
