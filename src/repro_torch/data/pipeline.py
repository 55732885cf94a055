"""Deterministic synthetic data pipeline — port of
``repro/data/pipeline.py``.

The same seeded Markov-chain token generator as the reference, so a given
(seed, step, row) yields the same tokens byte for byte in both packages;
batches are int32 tensors on the pipeline's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


class TokenPipeline:
    """Markov-chain token stream -> model input batches."""

    def __init__(self, model, shape: ShapeConfig, seed: int = 0,
                 vocab_cap: int = 32768, device=None):
        self.model = model
        self.shape = shape
        self.seed = seed
        self.device = model.device if device is None else torch.device(device)
        self.vocab = min(model.cfg.vocab_size, vocab_cap)
        self.state = PipelineState(seed=seed, step=0)
        rng = np.random.RandomState(seed)
        self._a = int(rng.randint(1, self.vocab // 2) * 2 + 1)
        self._c = int(rng.randint(1, self.vocab))

    def _tokens(self, step: int, row: int, n: int) -> np.ndarray:
        """One sequence, deterministic in (seed, step, row)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 8191 + row) % (2 ** 31 - 1))
        start = rng.randint(self.vocab)
        noise = rng.randint(0, self.vocab, size=n)
        toks = np.empty(n, np.int64)
        t = start
        for i in range(n):
            # mostly-deterministic chain with 10% noise: learnable structure
            t = (self._a * t + self._c) % self.vocab
            toks[i] = t if noise[i] % 10 else noise[i]
        return toks

    def host_batch(self, step: int) -> dict:
        """The numpy batch of ``step``: tokens and next-token labels."""
        B, S = self.shape.global_batch, self.shape.seq_len
        arr = np.stack([self._tokens(step, b, S + 1) for b in range(B)])
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self.host_batch(self.state.step)
        self.state.step += 1
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                # a copy from pinned memory does not wait for the stream
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out
