"""Device dispatch for the port's kernels: model code calls these.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to
the hand-written kernel.  There is no fallback between the two.  With
grad enabled and an input that requires grad, ``ssm_scan`` on the card
goes through ``autograd.ssm_scan`` (the kernel forward, the plain
version's gradient) and ``flash_attention`` on the card raises (no
backward; see ``autograd``).

DTensors (a sharded model, ``shard.sharding_rules``): ``flash_attention``
runs the kernel (on the CPU or the meta device, its plain version) on each
rank's local shard through ``local_map``, split over batch and heads
only, and so does ``ssm_scan`` on the card: neither kernel can run on a
shard of a dimension it sums over (keys and head dim; the scan's Dk), so
the inputs are first redistributed to that layout.  On the CPU or the
meta device ``ssm_scan`` keeps the reference's split of Dk over 'model'
(``ssm.chunked_linear_scan``).
``pig_aggregate``, the fan-ins and the draws are on no sharded path: a
DTensor there raises a ``ValueError``."""
from __future__ import annotations

from typing import Optional

import torch

from .. import shard
from . import autograd
from . import ssm_scan as _ssm_scan
from .draws import epaxos_draws as _epaxos_draws
from .draws import group_draws as _group_draws
from .flash_attention import flash_attention_bshd, flash_attention_padded
from .pig_aggregate import pig_aggregate as _pig_aggregate_kernel
from .pig_aggregate import quantize_blockwise  # noqa: F401 (re-export)
from .ref import flash_attention_ref, ssm_scan_ref
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
    (``autograd.FLASH_NO_GRAD``).  DTensors: per shard of batch and query
    heads (``shard.local_heads``: GQA's KV heads follow their query
    heads)."""
    if shard.is_dtensor(q):
        return shard.local_heads(
            lambda q, k, v: flash_attention(q, k, v, causal=causal), q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bshd(q, k, v, causal=causal)
    if q.device.type == "meta":          # a dry-run's trace: no data
        t = lambda a: a.transpose(1, 2)
        return t(flash_attention_ref(t(q), t(k), t(v), causal=causal))
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
    gradient backward (the JAX package differentiates its plain scan).

    DTensors: on the card, the kernel per shard of batch and heads
    (``_ssm_scan_local``); on the CPU or the meta device, the plain version
    on the mesh as the reference runs it (``ssm.chunked_linear_scan``:
    split over Dk on 'model', so that a dry-run counts the reference's
    program)."""
    if shard.is_dtensor(q) and q.device.type == "cuda":
        return _ssm_scan_local(q, k, v, log_a, u, chunk, s0, return_state)
    if shard.is_dtensor(q) or q.device.type == "meta":
        return ssm_scan_ref(q, k, v, log_a, u=u, chunk=chunk, s0=s0,
                            return_state=return_state)
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    args = (q.contiguous(), k.contiguous(), v.contiguous(), f32(log_a))
    kw = dict(u=f32(u), chunk=chunk, s0=f32(s0), return_state=return_state)
    if q.device.type == "cuda" and _needs_grad(*args, kw["u"], kw["s0"]):
        return autograd.ssm_scan(_ssm_scan.ssm_scan, *args, **kw)
    return _ssm_scan.ssm_scan(*args, **kw)


def _ssm_scan_local(q, k, v, log_a, u, chunk, s0, return_state):
    """``ssm_scan`` on each rank's shard through ``local_map``: q's splits
    of batch (dim 0) and heads (dim 2) are kept, every other mesh dimension
    is replicated (the chunk's sums run over T and Dk), and the state and
    ``u`` follow the same splits."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in q.placements]
    H = q.shape[2]
    hs = 1
    for i, p in enumerate(keep):
        if p == Shard(2):
            hs *= mesh.size(i)
    if H % hs:
        keep = [Replicate() if p == Shard(2) else p for p in keep]
    moved = lambda to: [Shard(to[p.dim]) if isinstance(p, Shard)
                        and to.get(p.dim) is not None else Replicate()
                        for p in keep]
    x_pl = list(keep)
    u_pl = moved({0: None, 2: 0})                  # (H, Dk)
    s_pl = moved({0: 0, 2: 1})                     # (B, H, Dk, Dv)
    run = lambda q, k, v, a, u, s0: ssm_scan(
        q, k, v, a, u=u, chunk=chunk, s0=s0, return_state=return_state)
    out = (x_pl, s_pl) if return_state else x_pl
    return shard.local_call(run, mesh, out, (
        x_pl, x_pl, x_pl, x_pl, None if u is None else u_pl,
        None if s0 is None else s_pl), (q, k, v, log_a, u, s0))


def _no_dtensor(name: str, *ts) -> None:
    if any(shard.is_dtensor(t) for t in ts):
        raise ValueError(f"{name} is on no sharded path: pass local "
                         f"tensors, not DTensors")


def pig_aggregate(shards: torch.Tensor, scales: torch.Tensor,
                  block: int = 1024) -> torch.Tensor:
    """shards (G, N) int8 + scales (G, N//block) f32 -> (N,) f32 sum."""
    _no_dtensor("pig_aggregate", shards, scales)
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
    _no_dtensor("seg_fanin", vals, coef, segid, kcap, anchor)
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
    _no_dtensor("seg_fanin_groups", grp, gstart, sizes, kg)
    return FaninGroups(grp, gstart, sizes, kg, B, plain=plain)


def group_draws(key: torch.Tensor, i0: int, n: int, B: int, n_draw: int,
                G: int, read: bool = False, plain: bool = False):
    """The group step loop's draw block for steps [i0, i0 + n): for every
    cell's key (C, 2) int64, ``k1, k2 = split(fold_in(key, s))`` and the
    f32 draws exponential(k1, (B, n_draw)) (C, n, B, n_draw), uniform(k2,
    (B, G)) (C, n, B, G) and, with ``read``, uniform(fold_in(k2, 1), (B,))
    (C, n, B) (else None).  On the card one launch of
    ``csrc/threefry_draws_sm90.cu``; on the CPU (or with ``plain``) the
    plain version ``ref.group_draws_ref``, a composition of ``prng`` calls,
    which the kernel equals bit for bit."""
    _no_dtensor("group_draws", key)
    return _group_draws(key, i0, n, B, n_draw, G, read=read, plain=plain)


def epaxos_draws(key: torch.Tensor, i0: int, b: int, n: int,
                 plain: bool = False):
    """The EPaxos step loop's draw block for steps [i0, i0 + b) at n nodes:
    for every cell's key (C, 2) int64, ``k0 .. k4 = split(fold_in(key, s),
    5)`` and the coordinator ``randint(k0, (), 0, n)`` (C, b) int64 with
    the f32 draws exponential(k1, (2,)) (C, b, 2), exponential(k2, (n,))
    and exponential(k3, (n,)) (C, b, n) and uniform(k4, ()) (C, b).  On
    the card one launch of ``csrc/threefry_draws_sm90.cu``'s EPaxos entry;
    on the CPU (or with ``plain``) the plain version
    ``ref.epaxos_draws_ref``, a composition of ``prng`` calls, which the
    kernel equals bit for bit."""
    _no_dtensor("epaxos_draws", key)
    return _epaxos_draws(key, i0, b, n, plain=plain)
