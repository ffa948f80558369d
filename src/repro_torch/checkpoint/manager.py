"""Checkpoints in the JAX package's layout, the port of
``repro.checkpoint.manager``.

Layout: ``<dir>/step_<n>/leaf_<i>.npy``, one file a leaf of the JAX
``TrainState`` in JAX's flattening order (bf16 stored as its uint16 bits),
and ``manifest.json`` = {"step", "dir", "files": {name: {file, shape,
dtype}}}.  Names are the JAX tree's: ``params/embed``,
``params/layers/time/wr``, ..., ``opt/mu/...``, ``opt/nu/...``,
``opt/step``; the port's per-layer parameters are stacked back to
(L, ...) on save (``convert.stacked_params``) and split on restore.  So a
checkpoint written by either package restores in the other.

A checkpoint counts once its manifest is written and, with a ``coord``
(any object with ``get(name)`` and ``put(name, obj)``; ``launch.train``
hands it the port's PigPaxos ``runtime.CoordinationService``), once
``ckpt/latest`` is committed there.  Without one,
``latest_step`` is the newest directory that has a manifest.  Saves copy
the state to the host at once and may write in a background thread.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import leaf_order, stacked_params
from ..models.model import reference_leaf

BF16 = "bfloat16"


def state_leaves(state) -> Dict[str, torch.Tensor]:
    """name -> host copy of every leaf of a port ``TrainState``, in JAX's
    flattening order (``TrainState(params, opt)``, ``OptState(mu, nu,
    step)``: fields in order, dict keys sorted)."""
    out = {f"params/{n}": t for n, t in stacked_params(state.params).items()}
    for field in ("mu", "nu"):
        moments = getattr(state.opt, field)
        for n in leaf_order(moments):
            out[f"opt/{field}/{n}"] = moments[n].detach().to("cpu", copy=True)
    out["opt/step"] = state.opt.step.detach().to("cpu", copy=True)
    return out


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array to write, logical dtype name)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), BF16
    a = t.numpy()
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, coord=None, async_save: bool = True):
        self.dir = directory
        self.coord = coord
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state) -> None:
        """Copy ``state`` (a port ``TrainState``) to the host, then write
        it (in a thread with ``async_save``) and commit it."""
        self.wait()                      # one outstanding save at a time
        host = state_leaves(state)

        def _write():
            d = os.path.join(self.dir, f"step_{step}")
            os.makedirs(d, exist_ok=True)
            files = {}
            for i, (name, t) in enumerate(host.items()):
                fn = f"leaf_{i}.npy"
                arr, dt = _to_numpy(t)
                np.save(os.path.join(d, fn), arr, allow_pickle=False)
                files[name] = {"file": fn, "shape": list(t.shape),
                               "dtype": dt}
            manifest = {"step": step, "dir": f"step_{step}", "files": files}
            with open(os.path.join(d, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if self.coord is not None:
                self.coord.put("ckpt/latest", {"step": step,
                                               "dir": f"step_{step}"})

        if self.async_save:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        if self.coord is not None:
            meta = self.coord.get("ckpt/latest")
            return None if meta is None else meta["step"]
        steps = [int(d.split("_")[1]) for d in os.listdir(self.dir)
                 if d.startswith("step_")
                 and os.path.exists(os.path.join(self.dir, d,
                                                 "manifest.json"))]
        return max(steps) if steps else None

    def restore(self, like, step: Optional[int] = None):
        """Restore step ``step`` (default: ``latest_step``) into ``like``, a
        port ``TrainState`` of the same config, in place (each leaf cast to
        ``like``'s dtype, on its device).  Returns (like, step), or None if
        there is no checkpoint.  A save still being written by this
        manager's thread is waited for first."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            files = json.load(f)["files"]

        def load(name: str) -> torch.Tensor:
            info = files[name]
            arr = np.load(os.path.join(d, info["file"]), allow_pickle=False)
            t = torch.from_numpy(np.array(arr))     # contiguous, writable
            return t.view(torch.bfloat16) if info["dtype"] == BF16 else t

        def put(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint step {step}: {name} has shape "
                                 f"{tuple(src.shape)}, the state "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        with torch.no_grad():
            stacked: Dict[str, torch.Tensor] = {}
            for name, p in like.params.named_parameters():
                leaf, layer = reference_leaf(name)
                if leaf not in stacked:
                    stacked[leaf] = load(f"params/{leaf}")
                src = stacked[leaf] if layer is None else stacked[leaf][layer]
                put(p, src, name)
            for field in ("mu", "nu"):
                for n, t in getattr(like.opt, field).items():
                    put(t, load(f"opt/{field}/{n}"), f"opt/{field}/{n}")
            put(like.opt.step, load("opt/step"), "opt/step")
        return like, step
