"""End-to-end training driver, the port of ``repro.launch.train``: the
data stream, the train step (remat, impl ``"auto"`` as the JAX driver
hard-codes), AdamW and checkpoints, with the JAX driver's flags and
defaults plus ``--device`` (default: the CUDA device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --smoke --steps 5 [--device cpu]

Left out, all on the JAX driver's discrete-event side and not ported: the
``HeartbeatMonitor`` (straggler and dead-pod detection), the
``ElasticController`` (re-mesh decisions), and the commit of each
checkpoint through the PigPaxos ``CoordinationService``.  Here a
checkpoint counts once its manifest is written (``CheckpointManager`` with
``coord=None``), and ``--resume`` restores the newest such step.  Each
logged step prints its wall ms (the device synchronised) and tokens/s.
The default ``--ckpt-dir`` lies under the temporary directory
(``TMPDIR``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, SyntheticLMStream
from ..device import resolve_device
from ..optim import AdamWConfig
from ..train import TrainOptions, build_train_step, init_train_state


def main(argv=None) -> dict:
    """Runs the driver; returns {"start", "losses", "latest"}: the step
    it started from, each step's loss, the newest checkpoint's step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count() / 1e6:.1f}M device={device}")

    mgr = CheckpointManager(args.ckpt_dir, coord=None, async_save=True)
    data = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      seed=args.seed)
    stream = SyntheticLMStream(cfg, data, device=device)
    opts = TrainOptions(
        remat=True, impl="auto", microbatch=args.microbatch,
        adamw=AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps))
    step_fn = build_train_step(cfg, opts)

    state = init_train_state(cfg, torch.Generator(device).manual_seed(
        args.seed), device)
    start = 0
    if args.resume:
        got = mgr.restore(state)
        if got is not None:
            state, start = got
            print(f"resumed from step {start}")

    losses = []
    tokens = args.batch * args.seq
    for s in range(start, args.steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, stream.batch_at(s))
        loss = float(metrics["loss"])          # waits for the device
        dt = time.perf_counter() - t0
        losses.append(loss)
        if (s + 1) % 10 == 0 or s == start:
            print(f"step {s + 1:4d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f}ms "
                  f"{tokens / dt:.0f} tokens/s")
        if (s + 1) % args.ckpt_every == 0:
            mgr.save(s + 1, state)
    mgr.wait()
    latest = mgr.latest_step()
    if losses:
        print(f"final loss {np.mean(losses[-5:]):.4f} "
              f"(first 5: {np.mean(losses[:5]):.4f}); "
              f"latest checkpoint: step {latest}")
    return {"start": start, "losses": losses, "latest": latest}


if __name__ == "__main__":
    main()
