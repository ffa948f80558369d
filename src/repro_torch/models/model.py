"""Top-level model zoo API: init_params / forward / prefill / decode_step
for every family of the zoo (``dense``, ``vlm``, ``audio``, ``moe``,
``rwkv``, ``ssm``, ``hybrid``).  The port of ``repro.models.model``.

Parameters live in ``nn.Module``s whose names mirror the JAX dict's keys
(``embed``, ``final_norm``, ``head``, ``layers.<l>.attn.wq``,
``layers.<l>.ln1``, ``layers.<l>.mlp.w1``, ``layers.<l>.moe.w1``,
``layers.<l>.time.wr``, ``layers.<l>.ssm.in_proj``, ``shared_attn.attn.wq``,
...), so ``convert`` maps one to the other by name.  The JAX package
stacks per-layer parameters on a leading L axis and runs ``lax.scan`` over
it; here the L axis is a ``ModuleList`` and the scan a loop.  The hybrid's
one shared attention block (``shared_attn``) is not stacked: the JAX
package scans super-blocks of ``attn_every`` Mamba2 layers, each followed
by the shared block, then the tail layers (``_hybrid_split``); here one
loop over ``layers`` runs the shared block after layer i when
(i + 1) % attn_every == 0 and i < n_super * attn_every.  The caches keep
the stacked (L, ...) layout (``{"kv": ...}``, ``{"rwkv": ...}``,
``{"ssm": ...}``, or ``{"ssm": ..., "kv": ...}`` for the hybrid, whose KV
cache has one layer a super-block), and each layer updates its slice in
place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..shard import (constrain, fsdp_gather, gathered, is_dtensor, is_split,
                     local_call, shard_index, sum_over)
from .config import ModelConfig
from .layers import (Attention, GatedMLP, attention_block, empty_kv_cache,
                     gated_mlp, generator_device, init_attention, init_mlp,
                     rmsnorm, target_device)
from .moe import MoE, init_moe, moe_block
from .rwkv import RWKVBlock, empty_rwkv_cache, init_rwkv_block, rwkv_block
from .ssm import SSMBlock, empty_ssm_cache, init_ssm, ssm_block

ATTENTION_FAMILIES = ("dense", "vlm", "audio", "moe")


# ================================================================== modules
class DenseBlock(nn.Module):
    """Attention and a gated MLP (``mlp``), or the ``moe`` family's MoE
    sublayer (``moe``) in its place."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D = cfg.d_model
        device = target_device(device)
        self.attn = Attention(cfg, dtype, device)
        self.ln1 = nn.Parameter(torch.zeros(D, device=device))
        self.ln2 = nn.Parameter(torch.zeros(D, device=device))
        if cfg.family == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = GatedMLP(D, cfg.d_ff, dtype, device)


class SSMLayer(nn.Module):
    """A Mamba2 block behind its pre-norm (``ssm``, ``ln``)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = target_device(device)
        self.ssm = SSMBlock(cfg, dtype, device)
        self.ln = nn.Parameter(torch.zeros(cfg.d_model, device=device))


class SharedAttnBlock(nn.Module):
    """The hybrid's one shared attention + MLP block (``attn``, ``mlp``,
    ``ln1``, ``ln2``)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D = cfg.d_model
        device = target_device(device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = GatedMLP(D, cfg.d_ff, dtype, device)
        self.ln1 = nn.Parameter(torch.zeros(D, device=device))
        self.ln2 = nn.Parameter(torch.zeros(D, device=device))


class DenseModel(nn.Module):
    """Embedding, the stack of ``DenseBlock``s (``RWKVBlock``s for the
    ``rwkv`` family: ``RWKVModel``; ``SSMLayer``s for ``ssm``:
    ``SSMModel``), the final norm and (unless tied to the embedding) the
    head.  Norm weights are f32, the rest in ``dtype``, as in the JAX
    package.  ``device=None`` is the CUDA device."""

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


class SSMModel(DenseModel):
    """The ``ssm`` family: a stack of Mamba2 ``SSMLayer``s."""

    block = SSMLayer


class HybridModel(SSMModel):
    """The ``hybrid`` family (zamba2): the Mamba2 stack and one
    ``SharedAttnBlock`` (``shared_attn``), applied after every
    ``attn_every``-th layer of the first n_super * attn_every."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
        super().__init__(cfg, dtype, device)
        self.shared_attn = SharedAttnBlock(cfg, dtype, target_device(device))


def model_class(cfg: ModelConfig) -> type:
    if cfg.family in ATTENTION_FAMILIES:
        return DenseModel
    classes = {"rwkv": RWKVModel, "ssm": SSMModel, "hybrid": HybridModel}
    if cfg.family not in classes:
        raise ValueError(f"unknown family {cfg.family}")
    return classes[cfg.family]


def n_super(cfg: ModelConfig) -> int:
    """The hybrid's super-blocks: shared-block applications, KV-cache
    layers."""
    return cfg.n_layers // cfg.attn_every


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared block follows layer i (super-block
    (i + 1) // attn_every - 1 ends there; the tail has none)."""
    k = cfg.attn_every
    return (cfg.family == "hybrid" and (i + 1) % k == 0
            and i < n_super(cfg) * k)


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
    zeros = lambda: nn.Parameter(torch.zeros(D, device=dev))
    with torch.no_grad():
        model.embed = nn.Parameter(
            (torch.randn((V, D), generator=gen, device=dev) * 0.02
             ).to(dtype))
        model.final_norm = zeros()
        if not cfg.tie_embeddings:
            model.head = nn.Parameter(
                (torch.randn((D, V), generator=gen, device=dev)
                 / math.sqrt(D)).to(dtype))
        for i in range(cfg.n_layers):
            blk = model.layers[i]
            if cfg.family == "rwkv":
                model.layers[i] = init_rwkv_block(gen, cfg, dtype, dev)
            elif cfg.family in ("ssm", "hybrid"):
                blk.ssm = init_ssm(gen, cfg, dtype, dev)
                blk.ln = zeros()
            else:
                blk.attn = init_attention(gen, cfg, dtype, dev)
                blk.ln1, blk.ln2 = zeros(), zeros()
                if cfg.family == "moe":
                    blk.moe = init_moe(gen, cfg, dtype, dev)
                else:
                    blk.mlp = init_mlp(gen, D, cfg.d_ff, dtype, dev)
        if cfg.family == "hybrid":
            sp = model.shared_attn
            sp.attn = init_attention(gen, cfg, dtype, dev)
            sp.mlp = init_mlp(gen, D, cfg.d_ff, dtype, dev)
            sp.ln1, sp.ln2 = zeros(), zeros()
    return model


def param_tree_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The layout of the JAX ``init_params`` tree: nested dicts of (shape,
    dtype), each ``layers`` leaf with its leading L axis stacked (the
    hybrid's ``shared_attn`` is one block, not stacked).  It is the layout
    ``convert.params_from_jax`` reads and the layout of the gradient tree
    that ``collectives.sync_grads`` synchronizes."""
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


def reference_leaf(name: str) -> tuple:
    """A parameter's name in the port (``layers.3.time.wr``) -> its leaf
    in the JAX ``init_params`` tree (``layers/time/wr``) and its index on
    that leaf's stacked L axis (``None`` for a leaf that is not stacked:
    ``embed``, ``final_norm``, ``shared_attn/...``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:]), int(parts[1])
    return "/".join(parts), None


# ================================================================== blocks
def _dense_block(lp: DenseBlock, x, cfg: ModelConfig, positions, cache, impl):
    h, nc = attention_block(lp.attn, rmsnorm(x, lp.ln1, cfg.norm_eps),
                            cfg, positions, cache, impl)
    x = x + h
    xn = rmsnorm(x, lp.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        h = moe_block(lp.moe, xn, cfg)
    else:
        h = gated_mlp(lp.mlp, xn, cfg.mlp_act)
    return x + h, nc


def _ssm_layer(lp: SSMLayer, x, cfg: ModelConfig, cache, chunk=64):
    h, nc = ssm_block(lp.ssm, rmsnorm(x, lp.ln, cfg.norm_eps), cfg,
                      cache=cache, chunk=chunk)
    return x + h, nc


def _shared_attn_block(sp: SharedAttnBlock, x, cfg: ModelConfig, positions,
                       cache, impl):
    sp = gathered(sp)
    h, nc = attention_block(sp.attn, rmsnorm(x, sp.ln1, cfg.norm_eps),
                            cfg, positions, cache, impl)
    x = x + h
    x = x + gated_mlp(sp.mlp, rmsnorm(x, sp.ln2, cfg.norm_eps), cfg.mlp_act)
    return _carry(x), nc


def _block(lp, x, cfg: ModelConfig, positions, cache, impl):
    lp = gathered(lp)                   # on a mesh: FSDP-gathered weights
    if cfg.family == "rwkv":
        x, nc = rwkv_block(lp, x, cfg, cache=cache, impl=impl)
    elif cfg.family in ("ssm", "hybrid"):
        x, nc = _ssm_layer(lp, x, cfg, cache)
    else:
        x, nc = _dense_block(lp, x, cfg, positions, cache, impl)
    return _carry(x), nc


def _carry(x):
    """The residual stream between blocks, laid out as the JAX package's
    layer scan keeps its carry: GSPMD gives a loop carry one layout, so a
    block's partial sums (the out-projections' products over a split
    'model' dim) are reduced at the layer boundary.  Without this DTensor
    carries them as ``Partial`` into the next block, whose products then
    run on whole weights on every 'model' rank.  A no-op off a mesh."""
    return constrain(x, "batch", "seq", "embed")


def _layers(params: DenseModel, cfg: ModelConfig, x, positions,
            cache: Optional[dict], impl):
    """The layer stack, with the hybrid's shared block after each
    super-block.  ``cache``: None, or the stacked cache, whose slices each
    layer (and each shared-block application) writes in place."""
    group = {"rwkv": "rwkv", "ssm": "ssm", "hybrid": "ssm"}.get(cfg.family,
                                                               "kv")
    for i, lp in enumerate(params.layers):
        lc = None if cache is None else {n: t[i]
                                         for n, t in cache[group].items()}
        x, _ = _block(lp, x, cfg, positions, lc, impl)
        if _shared_after(cfg, i):
            j = i // cfg.attn_every
            kv = None if cache is None else {n: t[j]
                                             for n, t in cache["kv"].items()}
            x, _ = _shared_attn_block(params.shared_attn, x, cfg, positions,
                                      kv, impl)
    return x


def _embed(params: DenseModel, tokens=None, embeds=None):
    """The token embedding.  On a mesh the table is gathered over its FSDP
    axis and stays split over the vocab: each rank looks up the tokens its
    block holds (zeros elsewhere) and the blocks are summed (DTensor's own
    lookup rule cannot be differentiated here)."""
    if embeds is not None:
        return embeds
    table = constrain(params.embed, "vocab", "embed")
    if not is_split(table, 0):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    rows = [Replicate()] * mesh.ndim
    if is_dtensor(tokens):                # keep the tokens' batch split
        rows = [Shard(0) if p == Shard(0) and i not in vocab else
                Replicate() for i, p in enumerate(tokens.placements)]

    def run(tab, t):
        rel = t - shard_index(mesh, vocab) * tab.shape[0]
        hit = (rel >= 0) & (rel < tab.shape[0])
        x = F.embedding(rel.clamp(0, tab.shape[0] - 1), tab)
        return sum_over(torch.where(hit[..., None], x, 0.0),
                        [mesh.get_group(i) for i in vocab])

    return local_call(run, mesh, rows, (list(table.placements), rows),
                      (table, tokens))


# ================================================================== forward
def _segments(params: DenseModel, cfg: ModelConfig, positions, impl):
    """The uncached layer stack as the functions x -> x that the JAX
    package wraps in ``jax.checkpoint`` (``repro.models.model.
    forward_hidden``): one a layer for the dense, vlm, audio, moe, rwkv
    and ssm families; for the hybrid one a super-block (``attn_every``
    Mamba2 layers and the shared block), then one a tail layer."""
    def layer(lp):
        return lambda x: _block(lp, x, cfg, positions, None, impl)[0]

    if cfg.family != "hybrid":
        return [layer(lp) for lp in params.layers]
    k, ns = cfg.attn_every, n_super(cfg)

    def super_block(j):
        def run(x):
            for lp in params.layers[j * k:(j + 1) * k]:
                x = _block(lp, x, cfg, positions, None, impl)[0]
            return _shared_attn_block(params.shared_attn, x, cfg, positions,
                                      None, impl)[0]
        return run
    return ([super_block(j) for j in range(ns)]
            + [layer(lp) for lp in params.layers[ns * k:]])


def forward_hidden(params: DenseModel, cfg: ModelConfig, tokens=None,
                   embeds=None, positions=None, impl: str = "ref",
                   remat: bool = False) -> torch.Tensor:
    """Training / evaluation forward pass -> final hidden states (B,S,D).
    ``remat``: each segment of ``_segments`` runs under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes
    its activations instead of keeping them, as ``jax.checkpoint`` does;
    the results are bit-identical either way."""
    x = _embed(params, tokens, embeds)
    B, S = x.shape[:2]
    x = constrain(x, "batch", "seq", "embed")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    for seg in _segments(params, cfg, positions, impl):
        x = checkpoint(seg, x, use_reentrant=False) if remat else seg(x)
    return rmsnorm(x, params.final_norm, cfg.norm_eps)


def logits_from_hidden(params: DenseModel, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ fsdp_gather(params.embed).T
    else:
        logits = x @ fsdp_gather(params.head)
    return constrain(logits, "batch", "seq", "vocab")


def forward(params, cfg, tokens=None, embeds=None, positions=None,
            impl="ref", remat=False):
    x = forward_hidden(params, cfg, tokens, embeds, positions, impl, remat)
    return logits_from_hidden(params, cfg, x)


# ================================================================== loss
def lm_loss(params: DenseModel, cfg: ModelConfig, batch: dict,
            impl: str = "ref", remat: bool = True) -> torch.Tensor:
    """Next-token CE, f32 accumulation; labels < 0 are masked: the sum of
    logsumexp minus the label's logit over the mask, over max(sum(mask),
    1).  ``batch``: ``tokens`` (or ``embeds``) and ``labels`` (B,S).
    ``impl="flash"`` raises a ``ValueError`` on every device before any
    work: the flash kernels have no backward (``kernels.autograd``)."""
    if impl == "flash":
        from ..kernels.autograd import FLASH_NO_GRAD
        raise ValueError(FLASH_NO_GRAD)
    x = forward_hidden(params, cfg, tokens=batch.get("tokens"),
                       embeds=batch.get("embeds"), impl=impl, remat=remat)
    logits = logits_from_hidden(params, cfg, x).to(torch.float32)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = _label_logits(logits, torch.clamp_min(labels, 0).long())
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def _gather_last(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def _label_logits(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits[b, s, labels[b, s]].  On a mesh with the vocab split, each
    rank reads the labels its block holds (0 elsewhere) and the blocks are
    summed (DTensor has no gather along a split dimension)."""
    if not is_split(logits, 2):
        return _gather_last(logits, labels)
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    keep = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in logits.placements]
    vocab = [i for i, p in enumerate(keep) if p == Shard(2)]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in keep]

    def run(lg, lab):
        off = shard_index(mesh, vocab) * lg.shape[-1]
        rel = lab - off
        hit = (rel >= 0) & (rel < lg.shape[-1])
        got = _gather_last(lg, rel.clamp(0, lg.shape[-1] - 1))
        return sum_over(torch.where(hit, got, 0.0),
                        [mesh.get_group(i) for i in vocab])

    return local_call(run, mesh, rows, (keep, rows), (logits, labels))


# ================================================================== serving
def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """An empty cache on ``device`` (``None``: the CUDA device): the KV
    cache of an attention family, the token shifts and states of
    ``rwkv``, the conv shifts and states of ``ssm``, both for
    ``hybrid`` (its KV cache one layer a super-block)."""
    model_class(cfg)                           # refuses an unknown family
    fam = cfg.family
    if fam == "rwkv":
        return {"rwkv": empty_rwkv_cache(cfg, batch, dtype=dtype,
                                         device=device)}
    if fam in ("ssm", "hybrid"):
        cache = {"ssm": empty_ssm_cache(cfg, batch, dtype=dtype,
                                        device=device)}
        if fam == "hybrid":
            cache["kv"] = empty_kv_cache(cfg, batch, max_len,
                                         n_layers=n_super(cfg), dtype=dtype,
                                         device=device)
        return cache
    return {"kv": empty_kv_cache(cfg, batch, max_len, dtype=dtype,
                                 device=device)}


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
    x = constrain(x, "batch", "seq", "embed")
    x = _layers(params, cfg, x, positions, cache, impl)
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor, impl: str = "ref"):
    """One decode step.  tokens: (B,) int; pos: (B,) absolute positions.
    Returns (logits (B,V), cache)."""
    x = _embed(params, tokens[:, None])
    x = constrain(x, "batch", "seq", "embed")
    x = _layers(params, cfg, x, pos[:, None], cache, impl)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache
