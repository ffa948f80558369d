"""Mixture-of-Experts sublayer: shared experts + routed top-k experts.  The
port of ``repro.models.moe``.

Dispatch is sort-based, as in the JAX package: per sequence (a token
group), a stable sort of the (token, choice) pairs by expert gives each
pair its position in its expert's queue; pairs past the capacity C go to
a trash slot E*C that is never read.  Only int index buffers are
scattered; the D-wide rows move by gathers.  The expert products are
batched ``torch.einsum``s in the activations' type.  The JAX package's
sharding constraints stand at the same sites (``shard.constrain``); its
remat name is left out.  On a mesh the dispatch indices and the two row
gathers, which DTensor has no sharding rule for, run per batch shard
(``shard.local_over``): a sequence is a token group, so each is
independent per row.

Parameters live in an ``MoE`` module named as the JAX dict's keys
(``router`` in f32, ``w1``, ``w3``, ``w2``, ``shared``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..shard import constrain, local_over
from .config import ModelConfig
from .layers import (GatedMLP, _act, _normal, _param, gated_mlp,
                     generator_device, init_mlp, target_device)


class MoE(nn.Module):
    """The router (D, E) in f32, the expert stacks w1/w3 (E, D, f) and w2
    (E, f, D), and (when the config has shared experts) one ``GatedMLP``
    of width n_shared * f."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        device = target_device(device)
        self.router = _param((d, E), torch.float32, device)
        self.w1 = _param((E, d, f), dtype, device)
        self.w3 = _param((E, d, f), dtype, device)
        self.w2 = _param((E, f, d), dtype, device)
        if cfg.n_shared_experts:
            self.shared = GatedMLP(d, cfg.n_shared_experts * f, dtype, device)


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert takes from one group of S tokens."""
    return max(1, int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts))


def _group_dispatch_indices(topi: torch.Tensor, E: int, C: int) -> tuple:
    """topi: (..., S, k) expert choices of each token group (the JAX
    function takes one group and is vmapped; here leading dims are
    groups).  Returns (slot (..., S, k) int64 into a flat (E*C) buffer,
    keep (..., S, k) bool): a pair's slot is expert * C + its rank among
    the group's pairs that chose that expert, in (token, choice) order;
    ranks from C on are dropped to the trash slot E*C."""
    *lead, S, k = topi.shape
    flat_e = topi.reshape(*lead, S * k).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, device=topi.device).expand(*lead, E)
    start = torch.searchsorted(sorted_e, experts.contiguous())   # left
    pos_sorted = (torch.arange(S * k, device=topi.device)
                  - torch.gather(start, -1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    return slot.reshape(*lead, S, k), keep.reshape(*lead, S, k)


def route(p: MoE, x: torch.Tensor, k: int) -> tuple:
    """The f32 router: softmax gates (B,S,E), the top-k choices and their
    weights renormalised to sum to one (+1e-9)."""
    gates = torch.softmax(x.to(torch.float32) @ p.router.to(torch.float32),
                          dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    return gates, topv, topi


def _dispatch(topi: torch.Tensor, E: int, C: int) -> tuple:
    """topi (B, S, k) -> (slot, keep, buf_idx (B, E*C + 1)): each kept
    pair writes its token index into its slot; dropped pairs all write the
    trash column E*C (any of them may win: it is never read); an empty
    slot keeps S, the zero row appended to x."""
    B, S, k = topi.shape
    slot, keep = _group_dispatch_indices(topi, E, C)       # (B,S,k)
    tok = torch.arange(S, device=topi.device)[None, :, None].expand(B, S, k)
    bidx = torch.arange(B, device=topi.device)[:, None, None].expand(B, S, k)
    buf_idx = torch.full((B, E * C + 1), S, dtype=torch.long,
                         device=topi.device)
    buf_idx.index_put_((bidx.reshape(B, -1), slot.reshape(B, -1)),
                       tok.reshape(B, -1))
    return slot, keep, buf_idx


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (B, R, D), idx (B, N) -> (B, N, D): src[b, idx[b, n]]."""
    B, N = idx.shape
    return torch.gather(src, 1, idx[..., None].expand(B, N, src.shape[-1]))


def _experts(ex_in, w1, w3, w2, cfg: ModelConfig) -> torch.Tensor:
    """The expert products, (B, E, C, D) -> (B, E, C, D); on a mesh, per
    shard of batch and experts (DTensor's einsum cannot split the batched
    products' operands here)."""
    h = _act(cfg.mlp_act)(torch.einsum("becd,edf->becf", ex_in, w1))
    h = h * torch.einsum("becd,edf->becf", ex_in, w3)
    h = constrain(h, "batch", "experts", None, None)
    return torch.einsum("becf,efd->becd", h, w2)


def moe_block(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Each sequence is a token group with C =
    ``capacity(cfg, S)`` slots an expert."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    _, topv, topi = route(p, x, k)
    rows3, rows2 = ("batch", None, None), ("batch", None)
    ex4 = ("batch", "experts", None, None)
    slot, keep, buf_idx = local_over(
        lambda t: _dispatch(t, E, C), (topi,), (rows3,),
        (rows3, rows3, rows2))
    buf_idx = constrain(buf_idx, "batch", None)
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    ex_in = local_over(_gather_rows, (x_pad, buf_idx[:, :E * C]),
                       (rows3, rows2), rows3).reshape(B, E, C, D)
    ex_in = constrain(ex_in, "batch", "experts", None, None)   # a2a -> EP

    ex_out = local_over(lambda x, w1, w3, w2: _experts(x, w1, w3, w2, cfg),
                        (ex_in, p.w1, p.w3, p.w2),
                        (ex4,) + (("experts", None, None),) * 3, ex4)
    ex_out = constrain(ex_out, "batch", "experts", None, None)

    flat_out = torch.cat([ex_out.reshape(B, E * C, D),
                          ex_out.new_zeros((B, 1, D))], dim=1)  # trash: 0
    flat_out = constrain(flat_out, "batch", None, None)
    y = local_over(_gather_rows, (flat_out, slot.reshape(B, S * k)),
                   (rows3, rows2), rows3).reshape(B, S, k, D)
    w = (topv * keep).to(y.dtype)
    y = torch.einsum("bskd,bsk->bsd", y, w)
    if cfg.n_shared_experts:
        y = y + gated_mlp(p.shared, x, cfg.mlp_act)
    return y


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device=None) -> MoE:
    """Random weights with the JAX package's scales (router /sqrt(D) in
    f32, w1/w3 /sqrt(D), w2 /sqrt(f)), drawn from ``gen``, which lives on
    ``device``, one expert at a time: no f32 copy of a whole expert stack
    is held."""
    d, f = cfg.d_model, cfg.moe_d_ff
    p = MoE(cfg, dtype, generator_device(gen, device))
    with torch.no_grad():
        p.router.copy_(_normal(gen, p.router.shape) / math.sqrt(d))
        for w, fan_in in ((p.w1, d), (p.w3, d), (p.w2, f)):
            for e in range(cfg.n_experts):
                w[e].copy_(_normal(gen, w.shape[1:]) / math.sqrt(fan_in))
    if cfg.n_shared_experts:
        p.shared = init_mlp(gen, d, cfg.n_shared_experts * f, dtype,
                            p.router.device)
    return p


def aux_load_balance_loss(gates: torch.Tensor, k: int) -> torch.Tensor:
    """Switch-style auxiliary loss (mean fraction * mean gate per expert).
    gates: (T, E)."""
    T, E = gates.shape
    topi = torch.topk(gates, k, dim=-1).indices
    counts = F.one_hot(topi, E).to(torch.float32).sum(dim=(0, 1))
    frac = counts / max(1.0, T * k)
    imp = gates.mean(dim=0)
    return E * torch.sum(frac * imp)
