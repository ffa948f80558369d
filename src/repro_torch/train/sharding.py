"""Mesh sharding rules: logical-axis rules for activations and a
``PartitionSpec`` a leaf for parameters, optimizer state, caches and
batches.  The port of ``repro.train.sharding``.

Strategy (the reference's):
  * batch over ('pod','data'): DP across pods and the in-pod data axis;
  * TP/EP over 'model' (attention heads, ffn dim, experts, vocab);
  * FSDP: weight matrices additionally sharded over 'data' on their non-TP
    dim, so params + Adam moments scale 1/(data*model) per rank.  The
    backward pass then reduce-scatters gradients within the pod and
    all-reduces only the 1/G shard across pods: the Pig schedule, which
    DTensor emits once the placements express it.
  * Params are replicated across pods (FSDP domain = one pod).

Specs are decided on the reference's leaf path and stacked shape (every
``layers`` leaf with its leading L axis, ``models.param_tree_shapes``).
The port keeps a module a layer, so a per-layer parameter takes its
leaf's spec without the L entry, which is always ``None`` (``fit_spec``
never places an axis on dim 0 of a stacked leaf).  The AdamW moments are
stacked already (``optim.adamw_init``) and take the stacked spec, as do
the caches (``models.make_cache``).  The rules read only axis names and
sizes (a ``DeviceMesh`` or a ``shard.MeshShape``); ``place`` puts tensors
on a real mesh.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..models.model import reference_leaf
from ..shard import MeshShape, P, as_axes, axis_sizes, spec_to_placements

__all__ = ["MeshShape", "activation_rules", "fit_spec", "param_shardings",
           "opt_shardings", "batch_sharding", "cache_shardings", "place",
           "place_params"]


def activation_rules(multi_pod: bool, shard_kv_seq: bool = False) -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "tokens": batch,          # flattened token dim in MoE dispatch
        "seq": None,
        "kv_seq": "data" if shard_kv_seq else None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "vocab": "model",
        "state_dk": "model",
    }


# leaf name -> (spec with fsdp, spec without)
_MATRIX_RULES = {
    # (L, in, out) projections: out dim on 'model'
    "wq": (P(None, "data", "model"), P(None, None, "model")),
    "wk": (P(None, "data", "model"), P(None, None, "model")),
    "wv": (P(None, "data", "model"), P(None, None, "model")),
    "w1": (P(None, "data", "model"), P(None, None, "model")),
    "w3": (P(None, "data", "model"), P(None, None, "model")),
    "in_proj": (P(None, "data", "model"), P(None, None, "model")),
    "w_in": (P(None, "data", "model"), P(None, None, "model")),
    "wr": (P(None, "data", "model"), P(None, None, "model")),
    "wg": (P(None, "data", "model"), P(None, None, "model")),
    "w_recv": (P(None, "data", "model"), P(None, None, "model")),
    "router": (P(None, "data", "model"), P(None, None, "model")),
    # (L, in, out) with in on 'model'
    "wo": (P(None, "model", "data"), P(None, "model", None)),
    "w2": (P(None, "model", "data"), P(None, "model", None)),
    "out_proj": (P(None, "model", "data"), P(None, "model", None)),
    "w_out": (P(None, "model", "data"), P(None, "model", None)),
}

_MOE_RULES = {
    "w1": (P(None, "model", "data", None), P(None, "model", None, None)),
    "w3": (P(None, "model", "data", None), P(None, "model", None, None)),
    "w2": (P(None, "model", None, "data"), P(None, "model", None, None)),
}


def _leaf_spec(names: Sequence[str], shape: tuple, fsdp: bool) -> P:
    """The spec of the reference leaf at path ``names`` (``("layers",
    "attn", "wq")``) with its stacked ``shape``, before ``fit_spec``."""
    leaf = names[-1]
    in_moe = "moe" in names and "shared" not in names
    in_shared_attn = "shared_attn" in names   # single block: no leading L axis

    if leaf == "embed":
        return P("model", "data") if fsdp else P("model", None)
    if leaf == "head":
        return P("data", "model") if fsdp else P(None, "model")
    if in_moe and leaf in _MOE_RULES and len(shape) == 4:
        return _MOE_RULES[leaf][0 if fsdp else 1]
    if leaf in _MATRIX_RULES and len(shape) == 3:
        return _MATRIX_RULES[leaf][0 if fsdp else 1]
    if in_shared_attn and leaf in _MATRIX_RULES and len(shape) == 2:
        full = _MATRIX_RULES[leaf][0 if fsdp else 1]
        return P(*full[1:])               # drop the (absent) layer axis
    if leaf == "conv_w":
        return P(None, None, "model") if len(shape) == 3 else P(None, "model")
    return P()                            # norms, biases, scalars: replicate


def fit_spec(spec: Sequence, shape: tuple, mesh) -> P:
    """Argument placements must divide the dim exactly: drop axes that
    don't, then try to re-place them on another (non-layer) dim so the leaf
    stays fully sharded (e.g. 60 experts can't split 16 ways -> fold
    'model' onto the 'data' dim instead)."""
    sizes = axis_sizes(mesh)
    dims = list(shape)
    entries = list(spec) + [None] * (len(dims) - len(spec))

    def prod(axes):
        n = 1
        for x in axes:
            n *= sizes[x]
        return n

    new = []
    dropped = []
    for dim, a in zip(dims, entries):
        axes = as_axes(a)
        if axes and dim % prod(axes) != 0:
            keep = []
            for x in axes:   # keep a divisible prefix if possible
                if dim % prod(keep + [x]) == 0:
                    keep.append(x)
                else:
                    dropped.append(x)
            new.append(tuple(keep) if len(keep) > 1
                       else (keep[0] if keep else None))
        else:
            new.append(a)
    used = {x for a in new for x in as_axes(a)}
    for ax in dropped:
        if ax in used:
            continue
        for i in range(len(dims) - 1, -1, -1):
            if len(dims) >= 3 and i == 0:
                continue            # dim 0 is the stacked-layers axis
            cur = as_axes(new[i])
            if ax in cur:
                continue
            if dims[i] % (prod(list(cur)) * sizes[ax]) == 0:
                new[i] = tuple(list(cur) + [ax])
                used.add(ax)
                break
    return P(*new)


def _stacked(params: nn.Module):
    """(port name, reference leaf path, stacked shape, layer or None) of
    every parameter."""
    L = len(params.layers)
    for name, p in params.named_parameters():
        leaf, layer = reference_leaf(name)
        shape = ((L,) if layer is not None else ()) + tuple(p.shape)
        yield name, leaf, shape, layer


def param_shardings(params: nn.Module, mesh, fsdp: bool = True
                    ) -> Dict[str, P]:
    """Port parameter name -> its spec: the reference leaf's fitted spec,
    without the L entry for a per-layer parameter."""
    out = {}
    for name, leaf, shape, layer in _stacked(params):
        spec = fit_spec(_leaf_spec(leaf.split("/"), shape, fsdp), shape, mesh)
        if layer is not None:
            if spec and spec[0] is not None:
                raise AssertionError(f"{leaf}: {spec} shards the L axis")
            spec = P(*spec[1:])
        out[name] = spec
    return out


def opt_shardings(opt, mesh, fsdp: bool = True) -> dict:
    """The AdamW moments' specs ({"mu": {leaf: spec}, "nu": ...}; stacked
    as the reference's ``_opt_shardings``) and the step's, P()."""
    def tree(moments):
        return {leaf: fit_spec(_leaf_spec(leaf.split("/"), tuple(t.shape),
                                          fsdp), tuple(t.shape), mesh)
                for leaf, t in moments.items()}
    return {"mu": tree(opt.mu), "nu": tree(opt.nu), "step": P()}


def batch_sharding(batch: dict, mesh, multi_pod: bool) -> dict:
    """Every batch entry split over the DP axes on its first dimension;
    ``batch`` maps names to tensors, or to (shape, dtype) as
    ``data.make_batch_specs`` gives them."""
    axes = ("pod", "data") if multi_pod else ("data",)
    ndim = lambda x: len(x[0]) if isinstance(x, tuple) else x.dim()
    return {n: P(axes) if ndim(x) >= 1 else P() for n, x in batch.items()}


def cache_shardings(cache: dict, mesh, multi_pod: bool,
                    shard_kv_seq: bool = False) -> dict:
    """KV/state caches: batch over DP axes; kv heads over 'model', else
    head dim, else seq; optionally seq over 'data' for long context.
    ``cache``: ``models.make_cache``'s nested dict (tensors or shapes)."""
    axes = ("pod", "data") if multi_pod else ("data",)
    sizes = axis_sizes(mesh)

    def one(leafname, shape):
        nd = len(shape)
        if leafname in ("k", "v"):        # (L, B, W, Hkv, Dh)
            seq = "data" if shard_kv_seq else None
            bat = None if shard_kv_seq else axes
            # model-axis placement priority: kv heads, else head_dim, else seq
            hkv, dh, w = shape[3], shape[4], shape[2]
            m = sizes["model"]
            if hkv % m == 0:
                spec = P(None, bat, seq, "model", None)
            elif dh % m == 0:
                spec = P(None, bat, seq, None, "model")
            elif seq is None and w % m == 0:
                spec = P(None, bat, "model", None, None)
            else:
                spec = P(None, bat, seq, None, None)
            return fit_spec(spec, shape, mesh)
        if leafname == "pos":             # (L, B, W)
            seq = "data" if shard_kv_seq else None
            bat = None if shard_kv_seq else axes
            return fit_spec(P(None, bat, seq), shape, mesh)
        if leafname == "state" and nd == 5:   # (L, B, H, Dk, Dv)
            h = shape[2]
            m = sizes["model"]
            spec = (P(None, axes, "model", None, None) if h % m == 0
                    else P(None, axes, None, "model", None))
            return fit_spec(spec, shape, mesh)
        if nd >= 2:                        # conv/shift caches: (L, B, ...)
            return fit_spec(P(None, axes), shape, mesh)
        return P()

    shape = lambda x: tuple(x[0] if isinstance(x, tuple) else x.shape)
    return {g: {n: one(n, shape(x)) for n, x in leaves.items()}
            for g, leaves in cache.items()}


# ----------------------------------------------------------------- placing
def distribute(t: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """``t`` (the global tensor, the same on every rank) as a DTensor with
    ``spec``'s placements.  On a mesh of one rank the tensor is its own
    shard and is wrapped without a copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = spec_to_placements(spec, mesh)
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements, run_check=False)
    return distribute_tensor(t, mesh, placements)


def place(tree, specs, mesh):
    """A nested dict of tensors as DTensors with the matching specs."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    return distribute(tree, mesh, specs)


def place_params(params: nn.Module, mesh, specs: Dict[str, P]) -> nn.Module:
    """Replace every parameter of ``params`` by a DTensor parameter with
    its spec (``param_shardings``), in place; returns ``params``."""
    mods = dict(params.named_modules())
    for name, p in list(params.named_parameters()):
        owner, _, attr = name.rpartition(".")
        d = distribute(p.detach(), mesh, specs[name])
        mods[owner]._parameters[attr] = nn.Parameter(
            d, requires_grad=p.requires_grad)
    return params
