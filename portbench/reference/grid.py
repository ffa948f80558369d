"""A grid's cells through a step loop: the step budget, the cells' keys,
and the exhausted cells retried with twice the steps."""
from __future__ import annotations

import torch

from .lowering import budget, cell_key, lower
from .summary import merge, units


def run(dep, cells, grid_clients, warmup, duration, device, dtype,
        max_steps, step_loop):
    """Per-cell result dicts of (clients, seed) ``cells`` of a grid whose
    client counts are ``grid_clients``; an exhausted cell runs again with
    twice the steps, up to ``max_steps`` requests a cell."""
    low = lower(dep)
    steps, breq, kmax = budget(low, grid_clients, warmup, duration)
    k_all = torch.tensor([k for k, _ in cells], device=device)
    key_all = torch.tensor([cell_key(s) for _, s in cells],
                           dtype=torch.int64, device=device)
    args = (warmup + duration, warmup, duration, dtype, device)
    out = step_loop(low, k_all, key_all, -(-steps // breq), breq, kmax,
                    *args)
    while out["exhausted"].any() and steps < max_steps:
        steps = min(steps * 2, max_steps)
        idx = out["exhausted"].nonzero()[0]
        ti = torch.as_tensor(idx, device=device)
        sub = step_loop(low, k_all[ti], key_all[ti], -(-steps // breq), breq,
                        kmax, *args)
        out = merge(out, sub, idx)
    return units(out)
