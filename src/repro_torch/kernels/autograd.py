"""Gradients through the hand kernels.

The JAX package has no backward kernel: ``jax.grad`` differentiates the
model's plain ``chunked_linear_scan`` (its ``time_mix`` never calls the
Pallas scan), and through ``pallas_call`` it cannot differentiate at all
(``jax.grad`` of ``lm_loss(..., impl="flash")`` raises ``AssertionError``).
The port keeps both facts:

- ``ssm_scan`` wraps a scan launcher in a ``torch.autograd.Function``.
  Its forward is the launcher (on the card the ``ssm_scan`` kernel, whose
  launch counters count as ever); its backward rebuilds the plain version
  ``ref.ssm_scan_ref`` from the saved inputs and returns autograd's
  gradient of it.  So the gradient is exactly the plain version's at the
  same inputs, what ``jax.grad`` of ``chunked_linear_scan`` gives the
  reference.  It is not a backward kernel.
- The flash kernels have no backward: ``FLASH_NO_GRAD`` is the message of
  the ``ValueError`` that ``ops.flash_attention`` (on a CUDA tensor that
  requires grad) and ``models.lm_loss(impl="flash")`` raise.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .ref import ssm_scan_ref

FLASH_NO_GRAD = (
    "flash_attention: the hand-written kernels (csrc/flash_attention_sm90.cu,"
    " csrc/flash_attention.cu) have no backward, and the JAX package cannot"
    " differentiate its Pallas kernel either (jax.grad through pallas_call "
    "raises AssertionError); train with impl='auto', 'ref' or 'chunked'")


class _Scan(torch.autograd.Function):
    """(launch, chunk, return_state, q, k, v, log_a, u, s0) -> y or
    (y, state); see ``ssm_scan``."""

    @staticmethod
    def forward(ctx, launch, chunk, return_state, q, k, v, log_a, u, s0):
        ctx.chunk, ctx.return_state = chunk, return_state
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_a, u, s0)
        return launch(q, k, v, log_a, u=u, chunk=chunk, s0=s0,
                      return_state=return_state)

    @staticmethod
    def backward(ctx, gy, gstate=None):
        need = ctx.needs_input_grad[3:]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        pairs = [(o, g) for o, g in zip((0, 1), (gy, gstate))
                 if g is not None]
        wrt = [t for t in ins if t is not None and t.requires_grad]
        grads = {}
        if pairs and wrt:
            q, k, v, log_a, u, s0 = ins
            with torch.enable_grad():
                out = ssm_scan_ref(q, k, v, log_a, u=u, chunk=ctx.chunk,
                                   s0=s0, return_state=ctx.return_state)
            outs = out if ctx.return_state else (out,)
            got = torch.autograd.grad([outs[i] for i, _ in pairs], wrt,
                                      [g for _, g in pairs],
                                      allow_unused=True)
            grads = {id(t): g for t, g in zip(wrt, got)}
        return (None, None, None) + tuple(
            None if t is None else grads.get(id(t)) for t in ins)


def ssm_scan(launch: Callable, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, log_a: torch.Tensor,
             u: Optional[torch.Tensor] = None, chunk: int = 64,
             s0: Optional[torch.Tensor] = None, return_state: bool = False):
    """``launch(q, k, v, log_a, u=, chunk=, s0=, return_state=)`` with
    autograd: the forward is ``launch``'s output, the backward the plain
    version's gradient at the saved inputs (for those that require grad;
    a ``None`` gradient of an unused output is skipped).  ``ops.ssm_scan``
    passes the kernel's wrapper; the CPU tests pass the plain version
    itself, whose own autograd this must equal bit for bit."""
    return _Scan.apply(launch, chunk, return_state, q, k, v, log_a, u, s0)
