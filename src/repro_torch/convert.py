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
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.model import model_class


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


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


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


def cache_from_jax(cache: Mapping, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``make_cache`` dict ({'kv': {'k', 'v', 'pos'}},
    {'rwkv': {'shift_t', 'shift_c', 'state'}}, {'ssm': {'conv', 'state'}}
    or the hybrid's {'ssm': ..., 'kv': ...}) -> the port's, bit for
    bit."""
    return {group: {name: tensor_from_numpy(a, device)
                    for name, a in arrays.items()}
            for group, arrays in cache.items()}
