"""Deterministic synthetic data pipeline — port of
``repro/data/pipeline.py``.

The same seeded Markov-chain token generator as the reference, so a given
(seed, step, row) yields the same tokens byte for byte in both packages;
batches are int32 tensors on the pipeline's device, with the float inputs
of a frontend stub (f32) where the model takes them.  With P pods, pod p
takes rows [p*B/P, (p+1)*B/P) of each global batch of B rows, as the
reference's batch sharding over ("pod", "data") gives them; on a
hierarchical fleet ``pod`` is the fleet slot r = c*E + e and P the fleet
size, as the reference's pod-major ("pod", "edge") sharding gives them.
After an elastic membership change :meth:`TokenPipeline.resized` hands
pod p the rows of its rank in the new membership; the contents stay a
function of (seed, step, row).
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
                 vocab_cap: int = 32768, device=None, pod: int = 0,
                 n_pods: int = 1):
        if shape.global_batch % n_pods or not 0 <= pod < n_pods:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {n_pods} pods (pod {pod})")
        self.model = model
        self.shape = shape
        self.seed = seed
        per = shape.global_batch // n_pods
        #: the rows of each global batch this pod takes
        self.rows = range(pod * per, (pod + 1) * per)
        self.device = model.device if device is None else torch.device(device)
        self.vocab_cap = vocab_cap
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
        """This pod's rows of the numpy batch of ``step``, the model's
        ``input_specs``: tokens and next-token labels, and a frontend
        stub's float inputs (the encoder-decoder's ``frames``, the VLM's
        ``patch_embs``).  Each float input is drawn as the reference
        draws it, N(0, 0.02^2) from one ``RandomState`` of (seed, step)
        over the whole global batch, of which this pod takes its rows.
        Where the labels are longer than the tokens (the VLM's patches
        come first) they are left-padded with label 0, which the loss
        scores as the reference's does (ROADMAP R9)."""
        specs = self.model.input_specs(self.shape)
        (_, S), _ = specs["tokens"]
        arr = np.stack([self._tokens(step, b, S + 1) for b in self.rows])
        out = {"tokens": arr[:, :-1].astype(np.int32)}
        labels = arr[:, 1:].astype(np.int32)
        for name, (dims, dtype) in specs.items():
            if dtype.is_floating_point:
                rng = np.random.RandomState(
                    (self.seed + step * 7919) % (2 ** 31 - 1))
                full = rng.randn(*dims).astype(np.float32) * 0.02
                out[name] = full[self.rows.start:self.rows.stop]
        if "labels" in specs:
            (_, n), _ = specs["labels"]
            pad = np.zeros((len(self.rows), n - S), np.int32)
            out["labels"] = np.concatenate([pad, labels], axis=1)[:, :n]
        return out

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

    # ---- restart support ------------------------------------------------
    def snapshot(self) -> dict:
        return dataclasses.asdict(self.state)

    def restore(self, snap: dict):
        self.state = PipelineState(**snap)

    # ---- elastic membership ---------------------------------------------
    def resized(self, batch_rows: int, pod: int = 0,
                n_pods: int = 1) -> "TokenPipeline":
        """A pipeline of ``batch_rows`` rows per global batch, of which
        this pod (rank ``pod`` of ``n_pods`` in the new membership) takes
        its share, resuming at this pipeline's stream position."""
        shape = dataclasses.replace(self.shape, global_batch=batch_rows)
        out = TokenPipeline(self.model, shape, seed=self.seed,
                            vocab_cap=self.vocab_cap, device=self.device,
                            pod=pod, n_pods=n_pods)
        out.restore(self.snapshot())
        return out
