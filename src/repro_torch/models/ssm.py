"""The chunked linear-recurrence scan shared by Mamba2 and RWKV6: the port
of ``repro.models.ssm``'s ``chunked_linear_scan`` and ``linear_scan_step``.

The recurrence (matrix-valued state S in R^{Dk x Dv} per head):
    S_t = a_t * S_{t-1} + k_t v_t^T          (a_t scalar or diag per channel)
    y_t = q_t^T S_t (+ bonus u: q_t^T (u ⊙ k_t) v_t for RWKV)

``chunked_linear_scan`` evaluates it chunk-parallel in f32 (the algorithm
the ``ssm_scan`` kernel implements; ``kernels/ref.py`` delegates here).
The Mamba2 block (``ssm_block``, ``init_ssm``, ``empty_ssm_cache``) comes
with the Mamba2/hybrid serving slice (ROADMAP queue 1, item 11c).
"""
from __future__ import annotations

from typing import Optional

import torch


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
    scalar branch evaluates exp(A_t - A_s) unfactored."""
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
    y = y_intra + torch.stack(y_inter, dim=1)
    y = y.reshape(B, T, H, Dv).to(v.dtype)
    if return_state:
        return y, S
    return y


def linear_scan_step(S: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, log_a: torch.Tensor,
                     bonus: Optional[torch.Tensor] = None):
    """Single-token recurrence for decode.  S: (B,H,Dk,Dv); q/k: (B,H,Dk);
    v: (B,H,Dv); log_a: (B,H) or (B,H,Dk).  Returns (S', y: (B,H,Dv))."""
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
    return S_new.to(S.dtype), y.to(v.dtype)
