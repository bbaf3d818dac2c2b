"""Deterministic synthetic token pipeline (+ a memmap file loader).

Counterpart of ``src/repro/data/pipeline.py``: batches are a function of
``(seed, step)`` alone, so a restored trainer replays its stream from the
step counter with no iterator state to checkpoint.

* ``SyntheticLM`` keeps the reference's Markov rule (the next token is
  ``(t * 7 + 3) % V`` with probability 0.5, else uniform), drawn from
  ``np.random.default_rng((seed, step))``.  The reference draws from
  ``jax.random``, which the port cannot reproduce, so its batches differ
  from the reference's by design; their statistics are the same.
* ``MemmapDataset`` draws its windows from ``np.random.default_rng(seed +
  step)`` as the reference does, so it gives the reference's batches bit
  for bit.

Batches are int32 tensors on the host; the trainer moves them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import frontend_embeddings


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    seed: int = 0
    vocab_size: int = 32000


class SyntheticLM:
    """Markov-ish synthetic LM stream: the next token depends on the
    previous one half the time, so a trained model's loss falls."""

    def __init__(self, cfg: DataConfig,
                 model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        base = rng.integers(0, c.vocab_size, (c.batch, c.seq + 1))
        flip = rng.random((c.batch, c.seq + 1)) < 0.5
        toks = np.empty((c.batch, c.seq + 1), dtype=np.int64)
        toks[:, 0] = base[:, 0]
        for t in range(1, c.seq + 1):
            pred = (toks[:, t - 1] * 7 + 3) % c.vocab_size
            toks[:, t] = np.where(flip[:, t], pred, base[:, t])
        toks = torch.from_numpy(toks.astype(np.int32))
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.model_cfg is not None:
            out.update(frontend_embeddings(self.model_cfg, c.batch,
                                           seed=c.seed + step, device="cpu"))
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapDataset:
    """Flat token file -> deterministic (tokens, labels) batches."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(c.seed + step)
        idx = rng.integers(0, self.n_windows, size=c.batch)
        toks = np.stack([self.tokens[i * c.seq:(i + 1) * c.seq + 1]
                         for i in idx]).astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}


def make_dataset(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None,
                 path: Optional[str] = None):
    if path and os.path.exists(path):
        return MemmapDataset(path, cfg)
    return SyntheticLM(cfg, model_cfg)
