"""A restore right after an asynchronous save reads that save.

``CheckpointManager.save`` writes in a background thread; ``restore`` in
the same process must wait for it, or it finds no manifest yet and
returns None (chip_smoke phase 29 met this: rwkv6-smoke's restart found
no checkpoint).  The write is slowed here so the race always shows."""
import time

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState


def test_restore_waits_for_a_pending_async_save(tmp_path, monkeypatch):
    cfg = get_smoke_config("rwkv6-3b")
    p = init_params(cfg, torch.Generator().manual_seed(0),
                    dtype=torch.float32, device="cpu")
    state = TrainState(p, adamw_init(p))
    slow_save = np.save

    def save(*a, **kw):
        time.sleep(0.01)
        slow_save(*a, **kw)
    monkeypatch.setattr(ckpt.np, "save", save)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    like = TrainState(init_params(cfg, torch.Generator().manual_seed(1),
                                  dtype=torch.float32, device="cpu"),
                      adamw_init(p))
    got = mgr.restore(like)
    assert got is not None and got[1] == 2
    want = ckpt.state_leaves(state)
    have = ckpt.state_leaves(got[0])
    assert all(torch.equal(have[n], want[n]) for n in want)
