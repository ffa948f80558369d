"""Device dispatch for the port's kernels: model code calls these.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to
the hand-written kernel.  There is no fallback between the two."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bhsd
from .pig_aggregate import pig_aggregate as _pig_aggregate_kernel
from .pig_aggregate import quantize_blockwise  # noqa: F401 (re-export)
from .segfanin import seg_fanin_rows


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout entry point: q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh) ->
    (B,S,Hq,Dh) in q's dtype.  Unlike the TPU wrapper it pads neither Dh
    (to 128, a TPU MXU rule) nor S (the kernel masks the ragged edge)."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = flash_attention_bhsd(qt, kt, vt, causal=causal)
    return out.transpose(1, 2).to(q.dtype)


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
