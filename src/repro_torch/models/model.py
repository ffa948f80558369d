"""Top-level model zoo API for the dense families (``dense``, ``vlm``,
``audio``) and ``rwkv``: init_params / forward / prefill / decode_step.
The port of ``repro.models.model``.

Parameters live in ``nn.Module``s whose names mirror the JAX dict's keys
(``embed``, ``final_norm``, ``head``, ``layers.<l>.attn.wq``,
``layers.<l>.ln1``, ``layers.<l>.mlp.w1``, ``layers.<l>.time.wr``, ...),
so ``convert`` maps one to the other by name.  The JAX package stacks
per-layer parameters on a leading L axis and runs ``lax.scan`` over it;
here the L axis is a ``ModuleList`` and the scan a loop.  The caches keep
the stacked (L, ...) layout (``{"kv": ...}`` or ``{"rwkv": ...}``), and
each layer updates its slice in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import (Attention, GatedMLP, attention_block, empty_kv_cache,
                     gated_mlp, generator_device, init_attention, init_mlp,
                     rmsnorm, target_device)
from .rwkv import RWKVBlock, empty_rwkv_cache, init_rwkv_block, rwkv_block

DENSE_FAMILIES = ("dense", "vlm", "audio")
# the ROADMAP item (queue 1) that will port each other family
NOT_PORTED = {"moe": "item 11b (MoE serving)",
              "ssm": "item 11c (Mamba2 ssm / zamba2 hybrid serving)",
              "hybrid": "item 11c (Mamba2 ssm / zamba2 hybrid serving)"}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"queue 1, {NOT_PORTED[cfg.family]})")
    if cfg.family not in DENSE_FAMILIES + ("rwkv",):
        raise ValueError(f"unknown family {cfg.family}")


# ================================================================== modules
class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D = cfg.d_model
        device = target_device(device)
        self.attn = Attention(cfg, dtype, device)
        self.ln1 = nn.Parameter(torch.zeros(D, device=device))
        self.ln2 = nn.Parameter(torch.zeros(D, device=device))
        self.mlp = GatedMLP(D, cfg.d_ff, dtype, device)


class DenseModel(nn.Module):
    """Embedding, the stack of ``DenseBlock``s (``RWKVBlock``s for the
    ``rwkv`` family: ``RWKVModel``), the final norm and (unless tied to the
    embedding) the head.  Norm weights are f32, the rest in ``dtype``, as
    in the JAX package.  ``device=None`` is the CUDA device."""

    block = DenseBlock

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        if model_class(cfg) is not type(self):
            raise ValueError(f"{cfg.name}: family {cfg.family!r} needs "
                             f"{model_class(cfg).__name__}")
        D, V = cfg.d_model, cfg.vocab
        device = target_device(device)
        self.embed = nn.Parameter(torch.empty((V, D), dtype=dtype,
                                              device=device))
        self.final_norm = nn.Parameter(torch.zeros(D, device=device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty((D, V), dtype=dtype,
                                                 device=device))
        self.layers = nn.ModuleList(self.block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))


class RWKVModel(DenseModel):
    """The ``rwkv`` family: the same embedding, final norm and head around
    a stack of ``RWKVBlock``s."""

    block = RWKVBlock


def model_class(cfg: ModelConfig) -> type:
    _require_ported(cfg)
    return RWKVModel if cfg.family == "rwkv" else DenseModel


# ================================================================== init
def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None) -> DenseModel:
    """Random parameters with the JAX package's scales (embed x0.02, head
    /sqrt(D), norms zero) on ``device`` (``None``: the CUDA device), drawn
    from ``gen``, which must live there.  The bits differ from
    ``jax.random``'s; tests carry JAX's parameters across with
    ``convert.params_from_jax`` instead."""
    dev = generator_device(gen, device)
    D, V = cfg.d_model, cfg.vocab
    model = model_class(cfg)(cfg, dtype, device="meta")
    with torch.no_grad():
        model.embed = nn.Parameter(
            (torch.randn((V, D), generator=gen, device=dev) * 0.02
             ).to(dtype))
        model.final_norm = nn.Parameter(torch.zeros(D, device=dev))
        if not cfg.tie_embeddings:
            model.head = nn.Parameter(
                (torch.randn((D, V), generator=gen, device=dev)
                 / math.sqrt(D)).to(dtype))
        for i in range(cfg.n_layers):
            if cfg.family == "rwkv":
                model.layers[i] = init_rwkv_block(gen, cfg, dtype, dev)
                continue
            blk = model.layers[i]
            blk.attn = init_attention(gen, cfg, dtype, dev)
            blk.ln1 = nn.Parameter(torch.zeros(D, device=dev))
            blk.ln2 = nn.Parameter(torch.zeros(D, device=dev))
            blk.mlp = init_mlp(gen, D, cfg.d_ff, dtype, dev)
    return model


def param_tree_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The layout of the JAX ``init_params`` tree for a ported config:
    nested dicts of (shape, dtype), each ``layers`` leaf with its leading L
    axis stacked.  It is the layout ``convert.params_from_jax`` reads and
    the layout of the gradient tree that ``collectives.sync_grads``
    synchronizes."""
    tree: dict = {}
    one = model_class(cfg)(cfg.replace(n_layers=1), dtype, device="meta")
    for name, p in one.named_parameters():
        shape = tuple(p.shape)
        if name.startswith("layers.0."):
            name = "layers." + name[len("layers.0."):]
            shape = (cfg.n_layers,) + shape
        *parents, leaf = name.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = (shape, p.dtype)
    return tree


# ================================================================== blocks
def _dense_block(lp: DenseBlock, x, cfg: ModelConfig, positions, cache, impl):
    h, nc = attention_block(lp.attn, rmsnorm(x, lp.ln1, cfg.norm_eps),
                            cfg, positions, cache, impl)
    x = x + h
    h = gated_mlp(lp.mlp, rmsnorm(x, lp.ln2, cfg.norm_eps), cfg.mlp_act)
    return x + h, nc


def _block(lp, x, cfg: ModelConfig, positions, cache, impl):
    if cfg.family == "rwkv":
        return rwkv_block(lp, x, cfg, cache=cache, impl=impl)
    return _dense_block(lp, x, cfg, positions, cache, impl)


def _embed(params: DenseModel, tokens=None, embeds=None):
    if embeds is not None:
        return embeds
    return F.embedding(tokens, params.embed)


# ================================================================== forward
def forward_hidden(params: DenseModel, cfg: ModelConfig, tokens=None,
                   embeds=None, positions=None, impl: str = "ref"
                   ) -> torch.Tensor:
    """Evaluation forward pass -> final hidden states (B,S,D)."""
    x = _embed(params, tokens, embeds)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    for lp in params.layers:
        x, _ = _block(lp, x, cfg, positions, None, impl)
    return rmsnorm(x, params.final_norm, cfg.norm_eps)


def logits_from_hidden(params: DenseModel, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.head


def forward(params, cfg, tokens=None, embeds=None, positions=None,
            impl="ref"):
    x = forward_hidden(params, cfg, tokens, embeds, positions, impl)
    return logits_from_hidden(params, cfg, x)


# ================================================================== serving
def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """An empty cache on ``device`` (``None``: the CUDA device): the KV
    cache of a dense family, the token shifts and states of ``rwkv``."""
    _require_ported(cfg)
    if cfg.family == "rwkv":
        return {"rwkv": empty_rwkv_cache(cfg, batch, dtype=dtype,
                                         device=device)}
    return {"kv": empty_kv_cache(cfg, batch, max_len, dtype=dtype,
                                 device=device)}


def _run_cached(params: DenseModel, cfg, x, positions, cache, impl):
    """The cached-mode layer stack (prefill T>=1 and decode T==1); each
    layer writes its slice of the stacked cache in place."""
    (stacked,) = cache.values()
    for i, lp in enumerate(params.layers):
        layer_cache = {name: t[i] for name, t in stacked.items()}
        x, _ = _block(lp, x, cfg, positions, layer_cache, impl)
    return x, cache


@torch.no_grad()
def prefill(params: DenseModel, cfg: ModelConfig, tokens=None, embeds=None,
            cache: Optional[dict] = None, impl: str = "ref"):
    """Process a prompt, filling the cache.  Returns (last_logits, cache)."""
    x = _embed(params, tokens, embeds)
    B, S = x.shape[:2]
    if cache is None:
        cache = make_cache(cfg, B, max_len=S, device=x.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, cache = _run_cached(params, cfg, x, positions, cache, impl)
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor, impl: str = "ref"):
    """One decode step.  tokens: (B,) int; pos: (B,) absolute positions.
    Returns (logits (B,V), cache)."""
    x = F.embedding(tokens[:, None], params.embed)
    x, cache = _run_cached(params, cfg, x, pos[:, None], cache, impl)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache
