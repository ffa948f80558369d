"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full, sliding
window, KV-cached decode), gated MLPs.  The port of ``repro.models.layers``.

Weight layout conventions (the JAX package's, so parameters carry across
by name and shape):
  wq: (d_model, n_heads*dh)    wk/wv: (d_model, n_kv*dh)   wo: (n_heads*dh, d_model)
  w1/w3: (d_model, d_ff)       w2: (d_ff, d_model)
Activations are x @ w, as in JAX (not ``nn.Linear``'s transposed layout).
The JAX package's sharding constraints stand at the same sites
(``shard.constrain``): no-ops outside a rules context.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..shard import (constrain, flatten, is_dtensor, is_split, local_call,
                     local_heads, sum_over, unflatten, write_slots)
from .config import ModelConfig

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope_tables(positions: torch.Tensor, dh: int, theta: float) -> tuple:
    """positions: (...,) int -> cos/sin of shape (..., dh/2)."""
    exponent = torch.arange(0, dh, 2, dtype=torch.float32,
                            device=positions.device) / dh
    inv = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B?, S, Dh/2) broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(dt)


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """Causal (+ sliding window) mask: (..., Sq, Sk) boolean, True = keep."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  window: Optional[int] = None,
                  k_valid: Optional[torch.Tensor] = None,
                  dh: Optional[int] = None, dh_sum=None) -> torch.Tensor:
    """Reference GQA attention.  q: (B,Sq,Hq,Dh), k/v: (B,Sk,Hkv,Dh).
    q_pos: (B,Sq) absolute positions; k_pos: (B,Sk).  O(Sq*Sk) memory.
    On a rank's slice of the head dim (``_decode_attention``): ``dh`` is
    the whole head dim and ``dh_sum`` completes the logits' sum over it."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    qf = q.float() / math.sqrt(Dh if dh is None else dh)
    kf = k.float()
    vf = v.float()
    qf = unflatten(qf, 2, (Hkv, rep))
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf)
    if dh_sum is not None:
        logits = dh_sum(logits)
    mask = _attn_mask(q_pos, k_pos, window)[:, None, None]   # (B,1,1,Sq,Sk)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      window: Optional[int] = None,
                      k_valid: Optional[torch.Tensor] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Flash-style online-softmax attention over key chunks, a Python loop
    where the JAX package scans: O(Sq * chunk) live memory instead of
    O(Sq * Sk)."""
    B, Sq, Hq, Dh = q.shape
    Sk = k.shape[1]
    Hkv = k.shape[2]
    rep = Hq // Hkv
    pad = (-Sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)
        if k_valid is not None:
            k_valid = F.pad(k_valid, (0, pad))
        Sk += pad
    qf = unflatten(q.float() / math.sqrt(Dh), 2, (Hkv, rep))
    dev = q.device
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), device=dev)
    acc = torch.zeros((B, Sq, Hkv, rep, Dh), device=dev)
    qp = q_pos[:, None, None, :, None]
    for c0 in range(0, Sk, chunk):
        kj = k[:, c0:c0 + chunk].float()
        vj = v[:, c0:c0 + chunk].float()
        pj = k_pos[:, c0:c0 + chunk][:, None, None, None, :]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kj)   # (B,Hkv,rep,Sq,ck)
        mask = pj <= qp
        if window is not None:
            mask &= pj > (qp - window)
        if k_valid is not None:
            mask &= k_valid[:, c0:c0 + chunk][:, None, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        upd = torch.einsum("bhrqk,bkhd->bqhrd", pexp, vj)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + upd
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def _decode_attention(q, ck, cv, positions, cpos, window):
    """Attention of a decode step over the cache.  On a mesh the cache is
    not moved: q takes the cache's splits of batch, KV heads (GQA's query
    heads follow them in contiguous blocks) and head dim, each rank
    attends over its slice, and a head-dim split sums the logits over its
    ranks (``shard.sum_over``).  Where the cache's keys themselves are
    split (a long context's sequence), DTensor's own operations run,
    softmax over the split key axis included."""
    plain = lambda q, k, v, qp, kp, **kw: attention_ref(
        q, k, v, qp, kp, window=window, k_valid=kp >= 0, **kw)
    if not is_dtensor(ck) or is_split(ck, 1):
        return plain(q, ck, cv, positions, cpos)
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = ck.device_mesh, list(ck.placements)
    qpl = [p if isinstance(p, Shard) and p.dim in (0, 2, 3) else Replicate()
           for p in pl]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    split = [mesh.get_group(i) for i, p in enumerate(pl) if p == Shard(3)]
    kw = (dict(dh=q.shape[-1], dh_sum=lambda t: sum_over(t, split))
          if split else {})
    return local_call(lambda *a: plain(*a, **kw), mesh, qpl,
                      (qpl, pl, pl, rows, rows), (q, ck, cv, positions, cpos))


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def gated_mlp(p: "GatedMLP", x: torch.Tensor, act: str = "silu"
              ) -> torch.Tensor:
    h = _act(act)(x @ p.w1) * (x @ p.w3)
    h = constrain(h, "batch", "seq", "ff")
    return h @ p.w2


# ----------------------------------------------------------------- modules
def target_device(device=None) -> torch.device:
    """Where new weights or caches go: ``None`` is the CUDA device and
    raises without one (``device.resolve_device``); ``"meta"`` is kept for
    modules that are filled in afterwards."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def generator_device(gen: torch.Generator, device=None) -> torch.device:
    """The target device of a random init, which ``gen`` must live on:
    a CPU generator does not quietly put the weights on the CPU."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the weights go "
                         f"on {dev}; pass a torch.Generator on {dev} (and "
                         f"device='cpu' for the CPU)")
    return dev


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """The attention sublayer's weights, named as the JAX dict's keys."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = cfg.d_model
        device = target_device(device)
        self.wq = _param((d, cfg.q_dim), dtype, device)
        self.wk = _param((d, cfg.kv_dim), dtype, device)
        self.wv = _param((d, cfg.kv_dim), dtype, device)
        self.wo = _param((cfg.q_dim, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((cfg.q_dim,), dtype, device)
            self.bk = _param((cfg.kv_dim,), dtype, device)
            self.bv = _param((cfg.kv_dim,), dtype, device)


class GatedMLP(nn.Module):
    """SwiGLU / GeGLU weights: w1 (gate), w3 (up), w2 (down)."""

    def __init__(self, d: int, d_ff: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = target_device(device)
        self.w1 = _param((d, d_ff), dtype, device)
        self.w3 = _param((d, d_ff), dtype, device)
        self.w2 = _param((d_ff, d), dtype, device)


# ----------------------------------------------------------------- attention
def attention_block(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    cache: Optional[dict] = None,
                    impl: str = "ref") -> tuple:
    """Full attention sublayer (projections + rope + attention + out-proj).

    cache=None            : training/prefill over the whole sequence.
    cache={'k','v','pos'} : cached mode; writes current k/v at ``positions``
                            and attends over the cache (decode or prefill).
                            The write is in place: the JAX package returns
                            new cache arrays, the port updates the caller's
                            tensors and returns the same dict.
    Returns (y, cache).
    """
    B, S, D = x.shape
    dh = cfg.dh
    q = unflatten(x @ p.wq, -1, (cfg.n_heads, dh))
    k = unflatten(x @ p.wk, -1, (cfg.n_kv_heads, dh))
    v = unflatten(x @ p.wv, -1, (cfg.n_kv_heads, dh))
    if cfg.qkv_bias:
        q = q + unflatten(p.bq, 0, (cfg.n_heads, dh))
        k = k + unflatten(p.bk, 0, (cfg.n_kv_heads, dh))
        v = v + unflatten(p.bv, 0, (cfg.n_kv_heads, dh))
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    cos, sin = rope_tables(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    win = cfg.sliding_window

    def _uncached_attention():
        if impl == "flash" and win is None:
            from ..kernels.ops import flash_attention
            return flash_attention(q, k, v, causal=True)
        # linear-memory path: required at 4k+ sequence lengths
        core = (attention_chunked if impl == "chunked"
                or (impl in ("ref", "auto") and S > 1024) else attention_ref)
        # on a mesh: per shard of batch and query heads (shard.local_heads)
        return local_heads(lambda q, k, v, pos: core(q, k, v, pos, pos,
                                                     window=win),
                           q, k, v, positions)

    if cache is None:
        y = _uncached_attention()
    else:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        W = ck.shape[1]
        # ring-buffer slots (full cache: W >= max_len so slot == position)
        slots = positions % W
        write_slots(ck, slots, k)
        write_slots(cv, slots, v)
        write_slots(cpos, slots, positions)
        if S > 1:
            # prefill: attention over the freshly written sequence itself
            # (prefill starts from an empty cache, so causal attention over
            # the current chunk == attention over the cache)
            y = _uncached_attention()
        else:
            y = _decode_attention(q, ck, cv, positions, cpos, win)

    y = flatten(y, 2, 2) @ p.wo
    return constrain(y, "batch", "seq", "embed"), cache


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.bfloat16, device=None) -> Attention:
    """Random attention weights with the JAX package's scales, drawn from
    ``gen``, which lives on ``device``."""
    d = cfg.d_model
    p = Attention(cfg, dtype, generator_device(gen, device))
    s = 1.0 / math.sqrt(d)
    with torch.no_grad():
        p.wq.copy_(_normal(gen, p.wq.shape) * s)
        p.wk.copy_(_normal(gen, p.wk.shape) * s)
        p.wv.copy_(_normal(gen, p.wv.shape) * s)
        p.wo.copy_(_normal(gen, p.wo.shape) * (1.0 / math.sqrt(cfg.q_dim)))
        if cfg.qkv_bias:
            for b in (p.bq, p.bk, p.bv):
                b.zero_()
    return p


def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype=torch.bfloat16, device=None) -> GatedMLP:
    p = GatedMLP(d, d_ff, dtype, generator_device(gen, device))
    with torch.no_grad():
        p.w1.copy_(_normal(gen, p.w1.shape) / math.sqrt(d))
        p.w3.copy_(_normal(gen, p.w3.shape) / math.sqrt(d))
        p.w2.copy_(_normal(gen, p.w2.shape) / math.sqrt(d_ff))
    return p


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal f32 draws (cast to the parameter's type on copy)."""
    return torch.randn(shape, generator=gen, device=gen.device)


def empty_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                   n_layers: Optional[int] = None, dtype=torch.bfloat16,
                   device=None) -> dict:
    """Stacked per-layer KV cache.  Sliding-window models only keep W slots."""
    device = target_device(device)
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, W, cfg.n_kv_heads, cfg.dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((L, batch, W), -1, dtype=torch.int32,
                          device=device),
    }
