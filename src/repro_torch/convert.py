"""Carry the reference's state across to the port: the batch backend's
stacked cell state, and the model zoo's parameters and KV cache.

``repro.core.vectorsim._stack_cells`` (and the port's own copy of it)
lowers a grid to a dict of numpy arrays, one leading cell axis per field.
``cells_from_numpy`` turns that dict into the tensors the port's group
kernel reads, so both sides can run from identical state: for the batch
model this stacked dict is what weights are to a model.

``params_from_jax`` and ``cache_from_jax`` take the JAX package's
``init_params`` pytree and ``make_cache`` dict as numpy arrays (stacked L
axis) and give the port's model and cache, bit for bit, for every family:
``DenseModel`` (``dense``, ``vlm``, ``audio``, and ``moe`` with its
``layers.moe.*`` leaves: the f32 router, the expert stacks, the shared
experts), ``RWKVModel``, ``SSMModel`` (``layers.ssm.*``, ``layers.ln``)
and ``HybridModel`` (the same plus the one unstacked ``shared_attn.*``
block); caches ``{"kv"}``, ``{"rwkv"}``, ``{"ssm": {conv, state}}`` or
the hybrid's ``{"ssm", "kv"}``.
``tree_from_jax`` carries any nested dict of arrays (gradients, residuals)
across as the same nested dict of tensors.

``train_state_from_jax`` carries a JAX ``TrainState`` (parameters, AdamW
moments and step) across, bit for bit; ``stacked_params`` is the inverse
of the parameters' map (the reference's stacked layout, which the
checkpoint writer uses).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.model import model_class, reference_leaf


def cells_from_numpy(batch: Dict[str, np.ndarray], device
                     ) -> Dict[str, torch.Tensor]:
    """float32 stays float32, every integer type (incl. the uint32 PRNG
    ``key``) becomes int64, bool stays bool.  Any other dtype raises: a
    float64 field would silently promote the kernel's f32 arithmetic."""
    out = {}
    for name, v in batch.items():
        a = np.asarray(v)
        if a.dtype == np.float32 or a.dtype == np.bool_:
            t = torch.from_numpy(np.ascontiguousarray(a))
        elif a.dtype.kind in "iu":
            t = torch.from_numpy(a.astype(np.int64))
        else:
            raise TypeError(f"cell field {name!r} has dtype {a.dtype}; "
                            f"expected float32, bool or an integer type")
        out[name] = t.to(device)
    return out


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit.  A bfloat16 array (JAX's,
    whose numpy dtype ``torch.from_numpy`` rejects) goes through its uint16
    bits."""
    a = np.array(a)    # a writable, contiguous copy (JAX's are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def tree_from_jax(tree: Mapping, device) -> Dict[str, object]:
    """A JAX pytree of nested dicts of arrays (e.g. ``init_params``-shaped
    gradients, with the layer axis stacked) -> the same nested dict of
    tensors on ``device``, each leaf bit for bit in its own dtype."""
    return {k: tree_from_jax(v, device) if isinstance(v, Mapping)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def _flatten(tree: Mapping, prefix: str = "", sep: str = "."
             ) -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}{sep}", sep))
        else:
            out[f"{prefix}{k}"] = v
    return out


def leaf_order(names) -> list:
    """JAX's flattening order of a tree of nested dicts, given its leaves'
    "/"-joined names: keys sorted at every level."""
    return sorted(names, key=lambda n: n.split("/"))


def params_from_jax(tree: Mapping, cfg, device):
    """The JAX ``init_params`` pytree -> the port's model for
    ``cfg.family`` (``models.model_class``) on ``device``, each leaf
    keeping its dtype.  ``layers`` leaves carry a leading L axis, which
    becomes ``layers.<l>.``; other leaves (``embed``, ``shared_attn.*``)
    map by name as they are; every leaf must map to exactly one parameter
    and back (a strict load)."""
    state = {}
    for name, a in _flatten(tree).items():
        a = np.asarray(a)
        if name.startswith("layers."):
            sub = name[len("layers."):]
            if a.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {a.shape[0]} != "
                                 f"{cfg.n_layers} layers")
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{sub}"] = tensor_from_numpy(a[i], device)
        else:
            state[name] = tensor_from_numpy(a, device)
    model = model_class(cfg)(cfg, device="meta")
    # strict: every leaf maps to one parameter and back, shapes equal
    model.load_state_dict(state, strict=True, assign=True)
    return model


def stack_leaves(named) -> Dict[str, torch.Tensor]:
    """(port parameter name, tensor) pairs (parameters, or gradients keyed
    by the parameters' names) -> the JAX ``init_params`` layout, flat:
    keyed by the JAX leaf names (``embed``, ``layers/time/wr``,
    ``shared_attn/attn/wq``) in JAX's leaf order, each a host copy in its
    own dtype, the per-layer tensors stacked on a leading L axis.  The
    inverse of ``params_from_jax``'s map."""
    leaves: Dict[str, object] = {}
    for name, p in named:
        leaf, layer = reference_leaf(name)
        t = p.detach().to("cpu", copy=True)
        if layer is None:
            leaves[leaf] = t
        else:
            leaves.setdefault(leaf, {})[layer] = t
    return {leaf: (torch.stack([v[i] for i in sorted(v)])
                   if isinstance(v, dict) else v)
            for leaf, v in ((n, leaves[n]) for n in leaf_order(leaves))}


def stacked_params(model) -> Dict[str, torch.Tensor]:
    """The port's model's parameters in the JAX layout (``stack_leaves``):
    what a checkpoint writes."""
    return stack_leaves(model.named_parameters())


def train_state_from_jax(state, cfg, device):
    """A JAX ``repro.train.TrainState`` (``params``, ``opt`` =
    ``OptState(mu, nu, step)``, as numpy or JAX arrays) -> the port's
    ``TrainState`` on ``device``, bit for bit: the model through
    ``params_from_jax``, the f32 moments keyed by the JAX leaf names (L
    axis stacked, as the port's ``optim`` keeps them), the int32 step."""
    from .optim import OptState
    from .train import TrainState
    moments = lambda tree: {n: tensor_from_numpy(a, device) for n, a in
                            _flatten(tree, sep="/").items()}
    opt = OptState(mu=moments(state.opt.mu), nu=moments(state.opt.nu),
                   step=tensor_from_numpy(np.asarray(state.opt.step,
                                                     np.int32), device))
    return TrainState(params_from_jax(state.params, cfg, device), opt)


def cache_from_jax(cache: Mapping, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``make_cache`` dict ({'kv': {'k', 'v', 'pos'}},
    {'rwkv': {'shift_t', 'shift_c', 'state'}}, {'ssm': {'conv', 'state'}}
    or the hybrid's {'ssm': ..., 'kv': ...}) -> the port's, bit for
    bit."""
    return {group: {name: tensor_from_numpy(a, device)
                    for name, a in arrays.items()}
            for group, arrays in cache.items()}
