"""The chunked linear-recurrence scan shared by Mamba2 and RWKV6: the port
of ``repro.models.ssm``'s ``chunked_linear_scan`` and ``linear_scan_step``.

The recurrence (matrix-valued state S in R^{Dk x Dv} per head):
    S_t = a_t * S_{t-1} + k_t v_t^T          (a_t scalar or diag per channel)
    y_t = q_t^T S_t (+ bonus u: q_t^T (u ⊙ k_t) v_t for RWKV)

``chunked_linear_scan`` evaluates it chunk-parallel in f32 (the algorithm
the ``ssm_scan`` kernel implements; ``kernels/ref.py`` delegates here).

The Mamba2 (SSD) block (``SSMBlock``, ``ssm_block``, ``init_ssm``,
``empty_ssm_cache``) runs its prefill through the scan's scalar-decay
branch at chunk 64, as the JAX package does: the decay is evaluated
unfactored, exp(A_t - A_s), so no ``ssm_scan`` kernel serves it (the
kernel's factored form would overflow f32 at Mamba2's unclamped decays).
Its parameters are named as the JAX dict's keys; a cache is updated in
place, each call writing its layer's slice and returning the same dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..shard import (constrain, flatten, is_dtensor, local_call, local_over,
                     sum_over, unflatten)
from .config import ModelConfig
from .layers import _normal, _param, generator_device, target_device


def chunked_linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_a: torch.Tensor, chunk: int = 64,
                        bonus: Optional[torch.Tensor] = None,
                        s0: Optional[torch.Tensor] = None,
                        return_state: bool = False):
    """q,k: (B,T,H,Dk); v: (B,T,H,Dv); log_a: (B,T,H) scalar decay or
    (B,T,H,Dk) per-channel decay; bonus: (H,Dk) current-token bonus (RWKV);
    s0: initial state (B,H,Dk,Dv).  Returns y: (B,T,H,Dv) in v's dtype and,
    when return_state, the final f32 state.  T must be divisible by chunk.

    The per-channel branch folds the decay into q and k (q e^{A})(k e^{-A})
    and so needs chunk * max|log_a| well under log(f32 max) ~ 88; the
    scalar branch evaluates exp(A_t - A_s) unfactored.

    On a mesh (DTensors) the reference's constraint holds: the recurrence
    is split over the state feature dim Dk ('state_dk', where it divides;
    head counts often do not) and over batch.  Each rank scans its shard
    (``shard.local_over``) and, since every term of y is linear in one
    product over Dk, sums its slice's part of y over the Dk shards once a
    call (``shard.sum_over``), instead of gathering the state.  (The
    reference's GSPMD program sums the scores and then the inter-chunk
    output once a chunk: the same result, more collectives.)"""
    if is_dtensor(q):
        return _scan_on_mesh(q, k, v, log_a, chunk, bonus, s0, return_state)
    return _scan(q, k, v, log_a, chunk, bonus, s0, return_state)


def _scan_on_mesh(q, k, v, log_a, chunk, bonus, s0, return_state):
    from torch.distributed.tensor import Shard
    q = constrain(q, "batch", None, None, "state_dk")
    k = constrain(k, "batch", None, None, "state_dk")
    mesh = q.device_mesh
    groups = [mesh.get_group(i) for i, p in enumerate(q.placements)
              if p == Shard(3)]
    x4 = ("batch", None, None, "state_dk")
    v4 = ("batch", None, None, None)
    st = ("batch", None, "state_dk", None)
    names = (x4, x4, v4, x4 if log_a.dim() == 4 else ("batch", None, None),
             None if bonus is None else (None, "state_dk"),
             None if s0 is None else st)
    y, S = local_over(
        lambda q, k, v, a, u, s: _scan(q, k, v, a, chunk, u, s, True,
                                       lambda t: sum_over(t, groups)),
        (q, k, v, log_a, bonus, s0), names, (v4, st))
    return (y, S) if return_state else y


def _scan(q, k, v, log_a, chunk, bonus, s0, return_state,
          dk_sum=lambda t: t):
    """The scan on local tensors.  ``dk_sum`` completes the output where
    Dk is split (identity otherwise): every term of y is linear in one
    product over Dk (the scores, the bonus, q . S), so each rank computes
    its Dk slice's part of y and one sum completes it."""
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    nc = T // chunk
    diag = log_a.dim() == 4
    f32 = torch.float32
    qc = q.to(f32).reshape(B, nc, chunk, H, Dk)
    kc = k.to(f32).reshape(B, nc, chunk, H, Dk)
    vc = v.to(f32).reshape(B, nc, chunk, H, Dv)
    la = log_a.to(f32).reshape((B, nc, chunk, H, Dk) if diag
                               else (B, nc, chunk, H))

    A = torch.cumsum(la, dim=2)                    # inclusive cumulative decay
    Atot = A[:, :, -1]                             # (B,nc,H[,Dk])

    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
    causal = torch.tril(ones)
    strict = torch.tril(ones, diagonal=-1)

    if diag:
        # per-channel decay: fold decays into q/k
        q_in = qc * torch.exp(A)                   # q_t e^{A_t}
        k_in = kc * torch.exp(-A)                  # k_s e^{-A_s}
        mask = strict if bonus is not None else causal
        scores = torch.einsum("bcthd,bcshd->bchts", q_in, k_in)
        scores = torch.where(mask, scores, 0.0)
        y_intra = torch.einsum("bchts,bcshv->bcthv", scores, vc)
        if bonus is not None:
            # RWKV current-token bonus: y_t += (q_t . (u ⊙ k_t)) v_t
            s_diag = torch.einsum("bcthd,bcthd->bcth", qc * bonus.to(f32),
                                  kc)
            y_intra = y_intra + s_diag[..., None] * vc
        k_state = kc * torch.exp(Atot[:, :, None] - A)   # k_s e^{A_c - A_s}
        q_i, kst, decay = q_in, k_state, torch.exp(Atot)[..., None]
    else:
        decay_qk = torch.exp(A[:, :, :, None, :] - A[:, :, None, :, :])
        scores = torch.einsum("bcthd,bcshd->bchts", qc, kc)
        scores = scores * torch.where(causal, decay_qk.permute(0, 1, 4, 2, 3),
                                      0.0)
        y_intra = torch.einsum("bchts,bcshv->bcthv", scores, vc)
        kst = kc * torch.exp(Atot[:, :, None] - A)[..., None]
        q_i = qc * torch.exp(A)[..., None]
        decay = torch.exp(Atot)[..., None, None]

    # the JAX package's lax.scan over chunks, as a loop
    S = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=q.device)
         if s0 is None else s0.to(f32))
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bthd,bhdv->bthv", q_i[:, c], S))
        S = S * decay[:, c] + torch.einsum("bthd,bthv->bhdv", kst[:, c],
                                           vc[:, c])
    y = dk_sum(y_intra + torch.stack(y_inter, dim=1))
    y = y.reshape(B, T, H, Dv).to(v.dtype)
    if return_state:
        return y, S
    return y


def linear_scan_step(S: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, log_a: torch.Tensor,
                     bonus: Optional[torch.Tensor] = None):
    """Single-token recurrence for decode.  S: (B,H,Dk,Dv); q/k: (B,H,Dk);
    v: (B,H,Dv); log_a: (B,H) or (B,H,Dk).  Returns (S', y: (B,H,Dv)).

    On a mesh (a DTensor state, split as the cache is: batch, and heads or
    else Dk) each rank steps its shard of the state through ``local_map``
    and the output, linear in its Dk products, is summed over the Dk
    shards."""
    if is_dtensor(S):
        return _step_on_mesh(S, q, k, v, log_a, bonus)
    return _step(S, q, k, v, log_a, bonus)


def _step_on_mesh(S, q, k, v, log_a, bonus):
    from torch.distributed.tensor import Replicate, Shard
    mesh = S.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim < 3 else Replicate()
            for p in S.placements]
    groups = [mesh.get_group(i) for i, p in enumerate(keep) if p == Shard(2)]

    def on(nd, to):     # S's splits of (B, H, Dk) moved to a tensor's dims
        return [Shard(to[p.dim]) if isinstance(p, Shard)
                and to.get(p.dim) is not None and to[p.dim] < nd
                else Replicate() for p in keep]

    bhd = on(3, {0: 0, 1: 1, 2: 2})
    bh = on(3, {0: 0, 1: 1})
    run = lambda S, q, k, v, a, u: _step(S, q, k, v, a, u,
                                         lambda t: sum_over(t, groups))
    return local_call(run, mesh, (keep, bh), (
        keep, bhd, bhd, bh, bhd if log_a.dim() == 3 else on(2, {0: 0, 1: 1}),
        None if bonus is None else on(2, {1: 0, 2: 1})),
        (S, q, k, v, log_a, bonus))


def _step(S, q, k, v, log_a, bonus, dk_sum=lambda t: t):
    f32 = torch.float32
    Sf = S.to(f32)
    a = torch.exp(log_a.to(f32))
    a = a[..., None, None] if a.dim() == 2 else a[..., None]
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    kv = torch.einsum("bhd,bhv->bhdv", kf, vf)
    S_new = Sf * a + kv
    if bonus is None:
        # matches the inclusive (s<=t) chunked mask: current kv attended
        y = torch.einsum("bhd,bhdv->bhv", qf, S_new)
    else:
        # RWKV: attend decayed previous state + u-weighted current token
        y = torch.einsum("bhd,bhdv->bhv", qf, Sf * a)
        y = y + torch.einsum("bhd,bhd->bh", qf,
                             bonus.to(f32)[None] * kf)[..., None] * vf
    return S_new.to(S.dtype), dk_sum(y).to(v.dtype)


# --------------------------------------------------------------- Mamba2 block
def _ssm_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    P = 64                                   # head dim
    H = cfg.ssm_heads or d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


class SSMBlock(nn.Module):
    """Mamba2 weights: ``in_proj`` (D, 2 d_inner + 2N + H) gives z, x, B, C
    and dt; ``conv_w`` (W, d_inner) the depthwise causal conv; ``dt_bias``,
    ``A_log`` and ``D`` (H,) in f32; ``out_proj`` (d_inner, D)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        d = cfg.d_model
        d_inner, H, P, N = _ssm_dims(cfg)
        device = target_device(device)
        self.in_proj = _param((d, 2 * d_inner + 2 * N + H), dtype, device)
        self.conv_w = _param((cfg.conv_width, d_inner), dtype, device)
        for name in ("dt_bias", "A_log", "D"):
            setattr(self, name, _param((H,), torch.float32, device))
        self.out_proj = _param((d_inner, d), dtype, device)


def causal_conv(xs: torch.Tensor, conv_w: torch.Tensor,
                prev: Optional[torch.Tensor]) -> tuple:
    """The depthwise causal conv over the last W = ``conv_w.shape[0]``
    positions of xs (B,T,d_inner), behind ``prev`` (B,W-1,d_inner) (zeros
    without a cache).  In f32, as the JAX package's gather and sum over W:
    here one shifted slice a tap, summed in tap order, with no (B,T,W,d)
    gather and no convolution routine (cuDNN would round f32 to TF32).
    Returns (silu(conv) in xs's dtype, the last W-1 rows of the padded
    input: the next call's ``prev``)."""
    B, T, _ = xs.shape
    W = conv_w.shape[0]
    if prev is None:
        prev = xs.new_zeros((B, W - 1, xs.shape[-1]))
    xpad = torch.cat([prev, xs], dim=1)
    w = conv_w.to(torch.float32)
    acc = xpad[:, :T].to(torch.float32) * w[0]
    for i in range(1, W):
        acc = acc + xpad[:, i:i + T].to(torch.float32) * w[i]
    return F.silu(acc).to(xs.dtype), xpad[:, T:]


def ssm_block(p: SSMBlock, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[dict] = None, chunk: int = 64) -> tuple:
    """Mamba2 (SSD) block.  x: (B,T,D).  cache: this layer's {'conv':
    (B,W-1,d_inner), 'state': (B,H,N,P)}, written in place, or None.
    Returns (y, cache).

    The prefill (T > 1, or no cache) runs ``chunked_linear_scan``'s scalar
    branch from the cached state, T padded on the right to a multiple of
    ``chunk`` with zeros (a decay of e^0 = 1 and k = v = 0 leave the final
    state exact); decode (T == 1 with a cache) runs ``linear_scan_step``."""
    B, T, D = x.shape
    d_inner, H, P, N = _ssm_dims(cfg)
    f32 = torch.float32
    z, xs, B_, C_, dt = torch.split(x @ p.in_proj,
                                    [d_inner, d_inner, N, N, H], dim=-1)
    xs, conv = causal_conv(xs, p.conv_w,
                           None if cache is None else cache["conv"])

    dt = F.softplus(dt.to(f32) + p.dt_bias.to(f32))               # (B,T,H)
    log_a = -torch.exp(p.A_log.to(f32)) * dt                      # (B,T,H)
    xh = unflatten(xs, -1, (H, P))
    v = (xh.to(f32) * dt[..., None]).to(x.dtype)
    k = B_[:, :, None, :].expand(B, T, H, N).to(x.dtype)
    q = C_[:, :, None, :].expand(B, T, H, N).to(x.dtype)

    if cache is None or T > 1:
        pad = (-T) % chunk
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            log_a = F.pad(log_a, (0, 0, 0, pad))
        y, state = chunked_linear_scan(
            q, k, v, log_a, chunk,
            s0=None if cache is None else cache["state"], return_state=True)
        y = y[:, :T]
    else:
        state, y1 = linear_scan_step(cache["state"], q[:, 0], k[:, 0],
                                     v[:, 0], log_a[:, 0])
        y = y1[:, None]
    y = y + p.D.to(f32)[:, None] * xh
    y = flatten(y, 2, 2).to(x.dtype) * F.silu(z)
    y = constrain(y, "batch", "seq", "ff")
    out = y @ p.out_proj
    if cache is not None:
        cache["conv"].copy_(conv)
        cache["state"].copy_(state)
    return constrain(out, "batch", "seq", "embed"), cache


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device=None) -> SSMBlock:
    """Random block weights with the JAX package's scales (in_proj
    /sqrt(D), conv x0.5, out_proj /sqrt(d_inner); dt_bias and A_log zero,
    so A = -1; D one), drawn from ``gen``, which lives on ``device``."""
    d_inner = _ssm_dims(cfg)[0]
    p = SSMBlock(cfg, dtype, generator_device(gen, device))
    with torch.no_grad():
        p.in_proj.copy_(_normal(gen, p.in_proj.shape) / math.sqrt(cfg.d_model))
        p.conv_w.copy_(_normal(gen, p.conv_w.shape) * 0.5)
        p.dt_bias.zero_()
        p.A_log.zero_()
        p.D.fill_(1.0)
        p.out_proj.copy_(_normal(gen, p.out_proj.shape) / math.sqrt(d_inner))
    return p


def empty_ssm_cache(cfg: ModelConfig, batch: int,
                    n_layers: Optional[int] = None, dtype=torch.bfloat16,
                    device=None) -> dict:
    """Stacked per-layer Mamba2 cache: the conv's last W-1 inputs in
    ``dtype``, the state (L,B,H,N,P) in f32."""
    device = target_device(device)
    d_inner, H, P, N = _ssm_dims(cfg)
    L = cfg.n_layers if n_layers is None else n_layers
    return {
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, d_inner),
                            dtype=dtype, device=device),
        "state": torch.zeros((L, batch, H, N, P), dtype=torch.float32,
                             device=device),
    }
