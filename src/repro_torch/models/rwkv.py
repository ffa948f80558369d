"""RWKV6 "Finch" blocks: time-mix with data-dependent per-channel decay and
matrix-valued state, plus squared-ReLU channel-mix.  Attention-free.  The
port of ``repro.models.rwkv``, with its simplifications (static
token-shift mixing, the low-rank data-dependent part folded into the decay
LoRA only; GroupNorm replaced by a per-head RMSNorm).

Parameters live in ``nn.Module``s named as the JAX dict's keys
(``time.mu_r`` ... ``time.ln_x``, ``chan.mu_ck`` ... ``chan.w_recv``,
``ln1``, ``ln2``), so ``convert`` maps one to the other by name.  Elementwise
work follows the source op by op, each op rounding to the activations'
type.  A cache is updated in place: each function writes its layer's
slice and returns the same dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..shard import constrain, flatten, unflatten
from .config import ModelConfig
from .layers import _normal, _param, generator_device, rmsnorm, target_device
from .ssm import linear_scan_step

HEAD_SIZE = 64
LORA = 64
CHUNK = 16       # the scan's chunk: the factored decay overflows at 64


def _dims(cfg: ModelConfig):
    H = cfg.ssm_heads or cfg.d_model // HEAD_SIZE
    return H, HEAD_SIZE


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros or the cached last token for t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


# ----------------------------------------------------------------- modules
class TimeMix(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D = cfg.d_model
        H, N = _dims(cfg)
        device = target_device(device)
        f32 = torch.float32
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "ln_x"):
            setattr(self, name, _param((D,), f32, device))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _param((D, D), dtype, device))
        self.w_lora_a = _param((D, LORA), dtype, device)
        self.w_lora_b = _param((LORA, D), dtype, device)
        self.u = _param((H, N), f32, device)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D = cfg.d_model
        device = target_device(device)
        self.mu_ck = _param((D,), torch.float32, device)
        self.mu_cr = _param((D,), torch.float32, device)
        self.w_in = _param((D, cfg.d_ff), dtype, device)
        self.w_out = _param((cfg.d_ff, D), dtype, device)
        self.w_recv = _param((D, D), dtype, device)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = target_device(device)
        self.time = TimeMix(cfg, dtype, device)
        self.chan = ChannelMix(cfg, dtype, device)
        self.ln1 = _param((cfg.d_model,), torch.float32, device)
        self.ln2 = _param((cfg.d_model,), torch.float32, device)


# ----------------------------------------------------------------- blocks
def log_decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    """The per-step, per-channel log-decay from the token-shift mix
    ``xw`` (B,T,D), in f32: data-dependent through the LoRA,
    log w_t = -exp(w0 + tanh(xw A) B), clamped to [-2.3, -1e-4] so that the
    factored chunk form (q e^{A}) (k e^{-A}) stays inside f32
    (chunk * 2.3 << 88)."""
    f32 = torch.float32
    wx = torch.tanh(xw.to(f32) @ p.w_lora_a.to(f32))
    logw = -torch.exp(p.w0.to(f32) + wx @ p.w_lora_b.to(f32))
    return torch.clamp(logw, -2.3, -1e-4)


def time_mix(p: TimeMix, x: torch.Tensor, cfg: ModelConfig,
             cache: Optional[dict] = None, chunk: int = CHUNK,
             impl: str = "ref") -> tuple:
    """x: (B,T,D).  cache: this layer's {'shift_t', 'state'} (and
    'shift_c'), written in place, or None.  Returns (out, cache).

    The prefill (T > 1, or no cache) runs the chunked scan: through
    ``kernels.ops.ssm_scan`` (the ``ssm_scan`` kernel on the card) for
    every ``impl`` but ``"ref"``, which runs its plain version
    ``kernels.ref.ssm_scan_ref`` (``ssm.chunked_linear_scan``) on any
    device.  The JAX ``time_mix`` has no ``impl``: both routes compute
    its ``chunked_linear_scan`` call.  Decode (T == 1 with a cache) runs
    ``linear_scan_step``, no kernel, as in the JAX package."""
    B, T, D = x.shape
    H, N = _dims(cfg)
    xx = _shift(x, None if cache is None else cache.get("shift_t"))

    def mix(mu):
        return x + (xx - x) * mu.to(x.dtype)

    r = unflatten(mix(p.mu_r) @ p.wr, -1, (H, N))
    k = unflatten(mix(p.mu_k) @ p.wk, -1, (H, N))
    v = unflatten(mix(p.mu_v) @ p.wv, -1, (H, N))
    g = F.silu(mix(p.mu_g) @ p.wg)
    logw = unflatten(log_decay(p, mix(p.mu_w)), -1, (H, N))

    if cache is None or T > 1:
        s0 = None if cache is None else cache["state"]
        from ..kernels import ops
        from ..kernels.ref import ssm_scan_ref
        scan = ssm_scan_ref if impl == "ref" else ops.ssm_scan
        y, state = scan(r, k, v, logw, u=p.u, chunk=chunk, s0=s0,
                        return_state=True)
    else:
        state, y1 = linear_scan_step(cache["state"], r[:, 0], k[:, 0],
                                     v[:, 0], logw[:, 0], bonus=p.u)
        y = y1[:, None]
    # per-head norm (GroupNorm stand-in), gate, output projection
    y = rmsnorm(y.reshape(B, T, H, N), unflatten(p.ln_x, 0, (H, N)),
                cfg.norm_eps)
    y = flatten(y, 2, 2) * g
    out = y @ p.wo
    if cache is not None:
        cache["shift_t"].copy_(x[:, -1:])
        cache["state"].copy_(state)
    return constrain(out, "batch", "seq", "embed"), cache


def channel_mix(p: ChannelMix, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None) -> tuple:
    xx = _shift(x, None if cache is None else cache.get("shift_c"))
    xk = x + (xx - x) * p.mu_ck.to(x.dtype)
    xr = x + (xx - x) * p.mu_cr.to(x.dtype)
    h = torch.square(torch.relu(xk @ p.w_in))
    h = constrain(h, "batch", "seq", "ff")
    out = torch.sigmoid(xr @ p.w_recv) * (h @ p.w_out)
    if cache is not None:
        cache["shift_c"].copy_(x[:, -1:])
    return out, cache


def rwkv_block(p: RWKVBlock, x: torch.Tensor, cfg: ModelConfig,
               cache: Optional[dict] = None, chunk: int = CHUNK,
               impl: str = "ref") -> tuple:
    y, _ = time_mix(p.time, rmsnorm(x, p.ln1, cfg.norm_eps), cfg,
                    cache=cache, chunk=chunk, impl=impl)
    x = x + y
    y, _ = channel_mix(p.chan, rmsnorm(x, p.ln2, cfg.norm_eps), cfg,
                       cache=cache)
    return x + y, cache


# ----------------------------------------------------------------- init
def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig,
                    dtype=torch.bfloat16, device=None) -> RWKVBlock:
    """Random block weights with the JAX package's scales (mixing
    coefficients 0.5, w0 0.5, LoRA-B zero, u x0.1, norms zero), drawn from
    ``gen``, which lives on ``device``."""
    D = cfg.d_model
    p = RWKVBlock(cfg, dtype, generator_device(gen, device))
    s = 1.0 / math.sqrt(D)
    t, c = p.time, p.chan
    with torch.no_grad():
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0"):
            getattr(t, name).fill_(0.5)
        for name in ("wr", "wk", "wv", "wg", "wo", "w_lora_a"):
            w = getattr(t, name)
            w.copy_(_normal(gen, w.shape) * s)
        t.w_lora_b.zero_()
        t.u.copy_(_normal(gen, t.u.shape) * 0.1)
        t.ln_x.zero_()
        c.mu_ck.fill_(0.5)
        c.mu_cr.fill_(0.5)
        c.w_in.copy_(_normal(gen, c.w_in.shape) * s)
        c.w_out.copy_(_normal(gen, c.w_out.shape) / math.sqrt(cfg.d_ff))
        c.w_recv.copy_(_normal(gen, c.w_recv.shape) * s)
        p.ln1.zero_()
        p.ln2.zero_()
    return p


def empty_rwkv_cache(cfg: ModelConfig, batch: int,
                     n_layers: Optional[int] = None, dtype=torch.bfloat16,
                     device=None) -> dict:
    """Stacked per-layer RWKV cache: token shifts in ``dtype``, the state
    in f32."""
    device = target_device(device)
    H, N = _dims(cfg)
    L = cfg.n_layers if n_layers is None else n_layers
    return {
        "shift_t": torch.zeros((L, batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((L, batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "state": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                             device=device),
    }
