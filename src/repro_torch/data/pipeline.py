"""Deterministic synthetic data pipeline, the port of
``repro.data.pipeline``.

A reproducible token stream (per step, per host slice), so training
restarts bit for bit from a (step, seed) pair.  The draws are numpy's, as
in the JAX package, so both packages give the same tokens, labels and
embeddings bit for bit; the batch goes to an explicit device (``None``:
the CUDA device).  ``make_batch_specs`` gives shapes and dtypes where the
JAX package gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig

STOP_TIMEOUT_S = 10.0    # the thread checks the stop every 0.05 s, between draws


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLMStream:
    """Markov-ish synthetic token stream, deterministic in (seed, step).
    Yields host-local batches on ``device``; labels are the next tokens,
    -1 at the last position."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, prefetch: int = 2,
                 device=None):
        if data.global_batch % data.n_hosts:
            raise ValueError(f"global batch {data.global_batch} does not "
                             f"split over {data.n_hosts} hosts")
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self.host_batch = data.global_batch // data.n_hosts
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """``tokens`` (B, S) int32 (or, for a stub frontend, ``embeds``
        (B, S, D) bf16, rounded to nearest even from numpy's f32) and
        ``labels`` (B, S) int32."""
        rng = np.random.default_rng(
            (self.data.seed * 1_000_003 + step) * 4096 + self.data.host_id)
        B, S, V = self.host_batch, self.data.seq_len, self.cfg.vocab
        # cheap structured stream: a random walk over the vocab, so the LM
        # loss is learnable
        start = rng.integers(0, V, size=(B, 1))
        steps = rng.integers(-3, 4, size=(B, S))
        toks = ((start + np.cumsum(steps, axis=1)) % V).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                                axis=1)
        to = lambda a: torch.from_numpy(a).to(self.device)
        if self.cfg.frontend:
            emb_rng = np.random.default_rng(self.data.seed * 7 + step)
            emb = emb_rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32) * 0.1
            return {"embeds": to(emb).to(torch.bfloat16),
                    "labels": to(labels)}
        return {"tokens": to(toks), "labels": to(labels)}

    # ------------------------------------------------------------ prefetch
    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            item = (step, self.batch_at(step))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, step: int = 0) -> None:
        """Start the prefetch thread at ``step``; iterate for (step, batch)
        pairs in order."""
        self._step = step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the prefetch thread and drop what it had queued."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(STOP_TIMEOUT_S)
            if self._thread.is_alive():
                raise RuntimeError("the prefetch thread did not stop")
            self._thread = None
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int
                     ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each batch entry, allocating nothing."""
    labels = ((global_batch, seq_len), torch.int32)
    if cfg.frontend:
        return {"embeds": ((global_batch, seq_len, cfg.d_model),
                           torch.bfloat16), "labels": labels}
    return {"tokens": ((global_batch, seq_len), torch.int32),
            "labels": labels}
