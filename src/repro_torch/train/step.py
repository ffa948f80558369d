"""Train / prefill / serve step constructors, the port of
``repro.train.step``.

``build_train_step`` returns a (state, batch) -> (state, metrics)
function; microbatching (gradient accumulation), remat and the attention
choice are knobs.  The JAX package hands these functions to ``jax.jit``
and gets a new state back; PyTorch runs them eagerly and the train step
updates the state in place (``optim.adamw_update``), returning it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..models import decode_step, init_params, lm_loss, prefill
from ..models.config import ModelConfig
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..shard import constrain, is_dtensor


@dataclass(frozen=True)
class TrainOptions:
    microbatch: int = 1          # gradient-accumulation splits
    remat: bool = True
    impl: str = "ref"            # 'ref' | 'chunked' | 'auto' attention
    adamw: AdamWConfig = field(default_factory=AdamWConfig)


class TrainState(NamedTuple):
    params: torch.nn.Module
    opt: OptState


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     device=None) -> TrainState:
    """Random parameters from ``gen`` (``models.init_params``) on
    ``device`` (``None``: the CUDA device) and zero AdamW moments."""
    params = init_params(cfg, gen, device=device)
    return TrainState(params=params, opt=adamw_init(params))


def loss_and_grads(params: torch.nn.Module, cfg: ModelConfig, batch: dict,
                   impl: str = "ref", remat: bool = True):
    """``lm_loss`` (detached) and its gradients keyed by parameter name, in
    the parameters' own type, as ``jax.value_and_grad`` gives them; a
    parameter the loss does not reach (a stub frontend's ``embed``) gets
    zeros, as in JAX.  On a mesh (DTensor parameters) each gradient is
    brought to its parameter's placements: the gradient sync (within the
    pod a reduce-scatter onto the FSDP shard, across pods the sum of that
    shard: the Pig schedule)."""
    named = list(params.named_parameters())
    loss = lm_loss(params, cfg, batch, impl=impl, remat=remat)
    got = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None
                           else _like(g, p)
                           for (n, p), g in zip(named, got)}


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_train_step(cfg: ModelConfig, opts: TrainOptions = TrainOptions()):
    """(state, batch) -> (state, metrics {loss, grad_norm, lr}), with
    ``loss_and_grads``; with ``microbatch`` k the batch splits as
    (k, B/k, ...) and each split's gradient (f32) / k and loss / k are
    summed in f32 in order, as the JAX package's scan does."""
    def value_and_grad(params, batch):
        return loss_and_grads(params, cfg, batch, opts.impl, opts.remat)

    def train_step(state: TrainState, batch: dict):
        if opts.microbatch > 1:
            k = opts.microbatch
            micro = {n: t.reshape((k, t.shape[0] // k) + t.shape[1:])
                     for n, t in batch.items()}
            dev = state.opt.step.device
            kt = torch.tensor(float(k), device=dev)
            loss = torch.zeros((), device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in state.params.named_parameters()}
            for i in range(k):
                li, gi = value_and_grad(state.params,
                                        {n: t[i] for n, t in micro.items()})
                for n, g in gi.items():
                    grads[n] = grads[n] + g.to(torch.float32) / kt
                del gi
                loss = loss + li / kt
        else:
            loss, grads = value_and_grad(state.params, batch)
        _, _, stats = adamw_update(grads, state.opt, state.params,
                                   opts.adamw)
        return state, {"loss": loss, **stats}

    return train_step


def build_prefill_step(cfg: ModelConfig, impl: str = "ref"):
    """(params, cache, tokens=None, embeds=None) -> (last_logits, cache).
    ``impl``: 'ref' | 'chunked' | 'flash' | 'auto' attention (see
    ``models.layers.attention_block``)."""
    def prefill_step(params, cache, tokens=None, embeds=None):
        return prefill(params, cfg, tokens=tokens, embeds=embeds,
                       cache=cache, impl=impl)
    return prefill_step


def build_serve_step(cfg: ModelConfig, impl: str = "ref"):
    """One batched greedy decode step: (params, cache, tokens, pos) ->
    (cache, next_tokens int32).  On a mesh the logits are gathered over
    the vocab before the argmax."""
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = decode_step(params, cfg, cache, tokens, pos,
                                        impl=impl)
        logits = constrain(logits, "batch", None)
        return new_cache, torch.argmax(logits, dim=-1).to(torch.int32)
    return serve_step
