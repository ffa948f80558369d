"""Prefill / serve step constructors: the serving half of
``repro.train.step``.  ``TrainOptions`` and ``build_train_step`` come with
the training slice (ROADMAP queue 1, item 11d).

The JAX package hands these functions to ``jax.jit``; PyTorch runs them
eagerly.
"""
from __future__ import annotations

import torch

from ..models import decode_step, prefill
from ..models.config import ModelConfig


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
    (cache, next_tokens int32)."""
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = decode_step(params, cfg, cache, tokens, pos,
                                        impl=impl)
        return new_cache, torch.argmax(logits, dim=-1).to(torch.int32)
    return serve_step
