"""Device dispatch for the port's kernels: model code calls these.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to
the hand-written kernel.  There is no fallback between the two.  With
grad enabled and an input that requires grad, ``ssm_scan`` on the card
goes through ``autograd.ssm_scan`` (the kernel forward, the plain
version's gradient) and ``flash_attention`` on the card raises (no
backward; see ``autograd``)."""
from __future__ import annotations

from typing import Optional

import torch

from . import autograd
from . import ssm_scan as _ssm_scan
from .flash_attention import flash_attention_bshd, flash_attention_padded
from .pig_aggregate import pig_aggregate as _pig_aggregate_kernel
from .pig_aggregate import quantize_blockwise  # noqa: F401 (re-export)
from .segfanin import FaninGroups, seg_fanin_rows


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout entry point: q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh) ->
    (B,S,Hq,Dh) in q's dtype.  The kernel reads the model's tensors where
    they lie (no transpose, no copy).  Unlike the TPU wrapper it pads
    neither S (the kernel masks the ragged edge) nor a head dim that a
    kernel takes; on a CUDA tensor any other head dim up to 256 (zamba2's
    112, h2o-danube's 80) is padded with zeros to the next one and scaled
    by 1/sqrt of its own Dh, as the TPU wrapper pads to 128
    (``flash_attention.flash_attention_padded``).  A CPU tensor runs the
    plain version, which takes any Dh.  On a CUDA tensor that requires
    grad, with grad enabled, it raises a ``ValueError``
    (``autograd.FLASH_NO_GRAD``)."""
    if q.device.type == "cpu":
        return flash_attention_bshd(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        raise ValueError(autograd.FLASH_NO_GRAD)
    return flash_attention_padded(q, k, v, causal=causal)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, u: Optional[torch.Tensor] = None,
             chunk: int = 64, s0: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Model-layout entry point with ``repro.kernels.ops.ssm_scan``'s
    signature plus a state: q/k/log_a (B,T,H,Dk), v (B,T,H,Dv), u (H,Dk) or
    None, s0 (B,H,Dk,Dv) or None.  Returns y (B,T,H,Dv) in v's dtype and,
    with ``return_state``, the final f32 state.

    A CPU tensor runs ``ref.ssm_scan_ref``, a CUDA tensor the kernel.
    Unlike the TPU wrapper it neither folds (B, H) into rows (the kernel
    reads the model layout by strides) nor pads T (rows past T are a decay
    of 1 and no kv).  log_a, u and s0 go to f32, and the inputs are made
    contiguous (a no-op for the model's own tensors).

    Overflow: the kernel folds the decay into q e^{A} and k e^{-A} inside a
    chunk, so ``chunk * max|log_a|`` must stay well under log(f32 max) ~ 88.
    RWKV6 clamps log_a to [-2.3, -1e-4] and passes ``chunk=16`` (e^36.8 at
    most); at the default chunk of 64 its decays overflow, here and in the
    TPU kernel.

    Gradients: on a CUDA tensor, with grad enabled and any input that
    requires grad, the call goes through ``autograd.ssm_scan`` after the
    casts above: the kernel's output forward, the plain version's exact
    gradient backward (the JAX package differentiates its plain scan)."""
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    args = (q.contiguous(), k.contiguous(), v.contiguous(), f32(log_a))
    kw = dict(u=f32(u), chunk=chunk, s0=f32(s0), return_state=return_state)
    if q.device.type == "cuda" and _needs_grad(*args, kw["u"], kw["s0"]):
        return autograd.ssm_scan(_ssm_scan.ssm_scan, *args, **kw)
    return _ssm_scan.ssm_scan(*args, **kw)


def pig_aggregate(shards: torch.Tensor, scales: torch.Tensor,
                  block: int = 1024) -> torch.Tensor:
    """shards (G, N) int8 + scales (G, N//block) f32 -> (N,) f32 sum."""
    return _pig_aggregate_kernel(shards, scales, block=block)


def seg_fanin(vals: torch.Tensor, coef: torch.Tensor, segid: torch.Tensor,
              kcap: torch.Tensor, vcoef, md1, c, anchor) -> torch.Tensor:
    """Segmented quorum fan-in with ``repro.kernels.ops.seg_fanin``'s
    signature, batched over optional leading cell dims: vals/coef
    (..., B, F) f32 (+inf = masked slot); segid/kcap (..., F) segment id and
    order-statistic cap per slot (segment-constant, contiguous segments);
    vcoef/md1/c scalars or (...,) per cell; anchor (..., B).  Returns
    (..., B, F): each slot's capped segment max, -inf where the admissible
    set is empty."""
    f32 = torch.float32
    lead = vals.shape[:-2]
    B, F = vals.shape[-2:]
    C = 1
    for d in lead:
        C *= d
    dev = vals.device

    def per_row(x):
        x = torch.as_tensor(x, dtype=f32, device=dev)
        return (x.reshape(lead + (1,)) if x.dim() else x).expand(lead + (B,))

    anchor = torch.as_tensor(anchor, dtype=f32, device=dev).expand(lead + (B,))
    scal = torch.stack((per_row(vcoef), per_row(md1), per_row(c), anchor),
                       dim=-1).reshape(C * B, 4)
    out = seg_fanin_rows(
        vals.to(f32).reshape(C * B, F).contiguous(),
        coef.to(f32).reshape(C * B, F).contiguous(),
        segid.to(torch.int32).expand(lead + (F,)).reshape(C, F).contiguous(),
        kcap.to(torch.int32).expand(lead + (F,)).reshape(C, F).contiguous(),
        scal.contiguous(), B)
    return out.reshape(vals.shape)


def seg_fanin_groups(grp: torch.Tensor, gstart: torch.Tensor,
                     sizes: torch.Tensor, kg: torch.Tensor, B: int,
                     plain: bool = False) -> FaninGroups:
    """The step loop's fan-in, prepared once per grid: grp (C, F) slot ->
    group, gstart/sizes (C, G) the contiguous group layout, kg (C, G) each
    group's order-statistic cap, B burst rows a cell.  The returned callable
    takes one step's (arr_back, peer_mask, B_r, rho - 1, md1, c_repl, L1)
    and returns mg (C, B, G), each group's capped segment max read at its
    slot clamp(gstart, 0, F - 1): on the card one launch of
    ``csrc/seg_fanin_sm90.cu``, on the CPU (or with ``plain``) the plain
    version ``ref.seg_fanin_groups_ref``."""
    return FaninGroups(grp, gstart, sizes, kg, B, plain=plain)
