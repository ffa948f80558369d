"""AdamW, the port of ``repro.optim.adamw``.

Moments are f32 whatever the parameter's type; the update is computed in
f32 and cast back (bf16 parameters and gradients plus f32 moments: 12
bytes a parameter).  The JAX package updates a pytree functionally; here
the parameters (an ``nn.Module``'s) and the moments are updated in place,
which keeps one copy of the training state on the card.

The moments are keyed by the JAX tree's leaf names (``embed``,
``layers/time/wr``, ...; ``models.reference_leaf``), each per-layer leaf
stacked on a leading L axis as there, so a checkpoint maps across leaf for
leaf; a layer's parameter updates its slice.

The schedule and the bias corrections are f32 tensors, as JAX computes
them from its weakly typed Python scalars.  Its f32 ``cos`` and ``pow``
round to nearest in all but rare cases (``pow``: every step checked;
``cos``: 2 arguments of 251 are an ulp off), which the port's f32 kernels
do not (16 of 251 for ``cos``); so both are evaluated in f64 and rounded
once to f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch
from torch import nn

from ..models.model import reference_leaf

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]     # JAX leaf name -> f32, L axis stacked
    nu: Dict[str, torch.Tensor]
    step: torch.Tensor              # () int32


def decayed(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to parameter ``name``: the JAX package
    decays every leaf of rank >= 2 of ITS tree (``adamw_update``: "matrices
    only"), and its per-layer leaves carry the stacked L axis, so every
    per-layer vector (``ln1``, ``ln2``, ``ln``, rwkv's ``mu_*``, ``w0``,
    ``ln_x``, ...) is decayed too and only the vectors outside ``layers``
    (``final_norm``, ``shared_attn``'s norms) are spared.  A fault of the
    reference, kept (ROADMAP §3): the rank counted is the JAX leaf's, the
    parameter's own plus one under ``layers.``."""
    return p.dim() + (reference_leaf(name)[1] is not None) >= 2


def _slots(params: nn.Module):
    """(name, parameter, JAX leaf name, layer index or None) per
    parameter."""
    for name, p in params.named_parameters():
        yield (name, p) + reference_leaf(name)


def adamw_init(params: nn.Module) -> OptState:
    """Zero f32 moments in the JAX tree's layout, on the parameters'
    device, and step 0."""
    L, dev = len(params.layers), params.final_norm.device
    shapes = {leaf: ((L,) if layer is not None else ()) + tuple(p.shape)
              for _, p, leaf, layer in _slots(params)}
    zeros = lambda: {leaf: torch.zeros(shape, dtype=F32, device=dev)
                     for leaf, shape in sorted(shapes.items())}
    return OptState(mu=zeros(), nu=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares;
    ``grads``: a dict of tensors (or any iterable of them)."""
    leaves = grads.values() if isinstance(grads, dict) else grads
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in leaves))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a half cosine to 0 at
    ``total_steps``; ``step`` an int32 tensor, the result f32."""
    c = lambda x: _f32(x, step)
    s = step.to(F32)
    warm = torch.minimum(s / c(max(cfg.warmup_steps, 1)), c(1.0))
    prog = torch.clamp((step - cfg.warmup_steps).to(F32)
                       / c(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = torch.cos((c(math.pi) * prog).double()).to(F32)
    return c(cfg.lr) * warm * c(0.5) * (c(1.0) + cos)


def bias_correction(beta: float, step: torch.Tensor) -> torch.Tensor:
    """1 - beta ** step in f32 (beta as its f32 value)."""
    b = _f32(beta, step).double()
    return _f32(1.0, step) - torch.pow(b, step.double()).to(F32)


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt: OptState,
                 params: nn.Module, cfg: AdamWConfig):
    """One AdamW step, in place: ``grads`` keyed by the parameters' names
    (their own type, or f32), clipped to ``cfg.clip_norm`` by the global
    norm; decoupled weight decay where ``decayed``.  Returns (params, opt,
    stats) with stats = {grad_norm, lr}, the same objects updated."""
    gnorm = global_norm(grads)
    c = lambda x: _f32(x, gnorm)
    scale = torch.minimum(c(1.0), c(cfg.clip_norm)
                          / torch.clamp_min(gnorm, 1e-12))
    opt.step.add_(1)
    lr = cosine_schedule(cfg, opt.step)
    b1c = bias_correction(cfg.b1, opt.step)
    b2c = bias_correction(cfg.b2, opt.step)
    b1, b2, eps, wd = c(cfg.b1), c(cfg.b2), c(cfg.eps), c(cfg.weight_decay)
    # 1 - b as the JAX package computes it: in Python, then to f32
    ob1, ob2 = c(1.0 - cfg.b1), c(1.0 - cfg.b2)
    for name, p, leaf, layer in _slots(params):
        m, v = opt.mu[leaf], opt.nu[leaf]
        if layer is not None:
            m, v = m[layer], v[layer]
        g = grads[name].to(F32) * scale
        m.copy_(b1 * m + ob1 * g)
        v.copy_(b2 * v + ob2 * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if decayed(name, p):
            delta = delta + wd * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
    return params, opt, {"grad_norm": gnorm, "lr": lr}
