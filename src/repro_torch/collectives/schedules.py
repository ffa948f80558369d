"""Pig collective schedules on ``torch.distributed``: the port of
``repro.collectives.schedules``, the paper's primitive moved onto
accelerators.

Paper -> accelerator mapping: the leader's fan-out/fan-in over a cluster
becomes cross-pod gradient synchronization; a relay group becomes a pod;
the rotating relay becomes the shard owner after an in-group
reduce-scatter (every rank relays 1/G of the payload); aggregated
piggybacked acks become int8-compressed cross-pod payloads with error
feedback, which the relay reduces with the ``pig_aggregate`` kernel.

Process groups stand in for the reference's named mesh axes
(``launch.mesh.Mesh``): ``group`` for ``data`` (the in-pod axis), ``pod``
for ``pod``.  Every function runs on every rank of the mesh, in the same
order, as the reference's run inside one ``shard_map``.

Cross-pod byte accounting per rank for payload P bytes, G ranks per group,
npods pods:
  direct  : flat all-reduce over ('pod','group') ~ 2 P (pods-1)/pods
  pig     : RS(group) -> AR(pod) -> AG(group)    ~ 2 (P/G) (pods-1)/pods
  pig+q8  : int8 payload + f32 block scales      ~ direct / G / 2 (vs bf16)
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.ops import pig_aggregate as pig_aggregate_op
from ..kernels.pig_aggregate import quantize_blockwise


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated in group-rank order (the reference's
    ``all_gather(..., axis=0, tiled=False).reshape(-1)``)."""
    x = x.contiguous()
    out = x.new_empty(dist.get_world_size(group) * x.numel())
    # torch 2.13 deprecates this name for all_gather_single, which older
    # releases lack; this one is in every release the port runs on
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(flat: torch.Tensor, group) -> torch.Tensor:
    """Group rank d gets the sum over the group of row d of
    ``flat.reshape(G, -1)`` (``psum_scatter(..., tiled=False)``)."""
    out = flat.new_empty(flat.numel() // dist.get_world_size(group))
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


def _flatten(x: torch.Tensor, mult: int):
    """Flatten to 1-D and pad to a multiple of ``mult``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % mult
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def direct_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Baseline: flat sum over every rank of ``group`` (the world when
    None).  Returns a new tensor; ``x`` is left as it was."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def pig_allreduce(x: torch.Tensor, group, pod, rotation: int = 0
                  ) -> torch.Tensor:
    """Hierarchical grouped all-reduce (bf16/f32 path).

    1. reduce-scatter within the group: each rank becomes the *relay* for a
       1/G shard;
    2. all-reduce across pods on the scattered shard only (the cross-pod
       hop carries 1/G of the bytes);
    3. all-gather within the group.

    ``rotation`` (e.g. the step counter) rotates which rank owns which
    shard across steps."""
    G = dist.get_world_size(group)
    flat, pad = _flatten(x, G)
    n = flat.numel()
    if rotation:
        flat = torch.roll(flat, (rotation % G) * (n // G))
    shard = _reduce_scatter(flat, group)
    dist.all_reduce(shard, group=pod)
    out = _all_gather(shard, group)
    if rotation:
        out = torch.roll(out, -(rotation % G) * (n // G))
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def pig_allreduce_quantized(x: torch.Tensor, residual: Optional[torch.Tensor],
                            group, pod, block: int = 1024,
                            rotation: int = 0):
    """Pig schedule with an int8-compressed cross-pod hop and error
    feedback: the in-group reduce-scatter in full precision, the shard
    block-quantized, its int8 values and f32 scales all-gathered across
    pods and summed by ``pig_aggregate``; the local quantization error is
    returned as the next step's residual.

    Returns (synced, new_residual), both shaped like x, in x's dtype.

    Two quirks of the reference are kept.  ``rotation`` is accepted and
    unused (``repro/collectives/schedules.py:92``).  The reference pads the
    flat leaf to a multiple of G*block and adds the *unpadded* residual
    (``:105-107``), which fails for every leaf that needs padding (a
    TypeError there); such a residual is refused here with a ValueError.
    """
    G = dist.get_world_size(group)
    npods = dist.get_world_size(pod)
    flat, pad = _flatten(x, G * block)
    if residual is not None:
        if pad:
            raise ValueError(
                f"pig_allreduce_quantized: a residual on a leaf of "
                f"{x.numel()} elements, not a multiple of G*block = "
                f"{G * block} (the reference adds the unpadded residual to "
                f"the padded leaf and fails the same way)")
        flat = flat + residual.reshape(-1)
    # 1) in-group reduce-scatter (full precision inside the pod)
    shard = _reduce_scatter(flat, group)                         # (P/G,)
    # 2) quantize the shard, exchange across pods, fused dequant-accumulate
    q, scales = quantize_blockwise(shard.to(torch.float32), block)
    q_all = _all_gather(q, pod).view(npods, -1)                  # int8
    s_all = _all_gather(scales, pod).view(npods, -1)             # f32
    agg = pig_aggregate_op(q_all, s_all, block=block)            # (P/G,) f32
    # error feedback: what the other pods saw vs what we contributed
    my_deq = (q.view(-1, block).to(torch.float32)
              * scales[:, None]).reshape(-1)
    local_err = shard.to(torch.float32) - my_deq
    # 3) in-group all-gather of the aggregated shard and of the error
    out = _all_gather(agg.to(x.dtype), group)
    err_full = _all_gather(local_err.to(x.dtype), group)
    if pad:
        out = out[:-pad]
        err_full = err_full[:-pad]
    return out.reshape(x.shape), err_full.reshape(x.shape)


def tree_map(fn: Callable, tree: Mapping, *rest: Mapping) -> dict:
    """``fn`` over the leaves of nested dicts of one structure, in sorted key
    order (``jax.tree.map``'s order, so every rank issues its collectives
    in the same order)."""
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            if isinstance(tree[k], Mapping) else
            fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def sync_grads(grads: Mapping, mesh, schedule: str = "pig", residuals=None,
               rotation: int = 0, block: int = 1024):
    """Synchronize a gradient tree (nested dicts of tensors) across the
    mesh's ``(pod, data)`` axes (``launch.mesh.make_mesh``).

    schedule: 'direct' | 'pig' | 'pig_q8'.  Returns (grads, residuals)."""
    if schedule == "direct":
        return tree_map(lambda g: direct_allreduce(g, mesh.world),
                         grads), residuals
    if schedule == "pig":
        return tree_map(lambda g: pig_allreduce(g, mesh.group, mesh.pod,
                                                 rotation), grads), residuals
    if schedule == "pig_q8":
        if residuals is None:
            residuals = tree_map(torch.zeros_like, grads)
        pairs = tree_map(
            lambda g, r: pig_allreduce_quantized(g, r, mesh.group, mesh.pod,
                                                 block, rotation),
            grads, residuals)
        synced = tree_map(lambda p: p[0], pairs)
        res = tree_map(lambda p: p[1], pairs)
        return synced, res
    raise ValueError(schedule)


def dcn_bytes_per_chip(param_bytes: int, group_size: int, npods: int,
                       schedule: str) -> float:
    """Closed-form cross-pod traffic model (the byte analogue of the paper's
    Eq. 1-3)."""
    f = 2.0 * (npods - 1) / npods
    if schedule == "direct":
        return f * param_bytes
    if schedule == "pig":
        return f * param_bytes / group_size
    if schedule == "pig_q8":
        # int8 payload + f32 scale per 1024 block, vs bf16 wire dtype
        return f * (param_bytes / group_size) * (1.0 + 4.0 / 1024) / 2.0
    raise ValueError(schedule)
