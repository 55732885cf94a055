"""Serving: batched prefill + decode with the whole model zoo — the
dense transformers, the MoE family, the recurrent families, the VLM and
the encoder-decoder — port of ``repro/launch/serve.py``.

A request queue served by static batching: the requests are cut into
server-batch chunks, each chunk's prompts left-padded with token 0 to its
longest (the pads are attended, or run through the recurrence, and take
positions, as in the reference), prefilled into caches for ``prompt +
new tokens`` positions — ring KV caches, for falcon-mamba-7b and
recurrentgemma-2b each recurrent layer's conv carry and scan state, for
seamless-m4t-medium each decoder layer's cross K/V of the encoder's
output — then decoded greedily one token per step, the caches written in
place.  A frontend stub's inputs are zeros, as the reference serves them:
seamless-m4t-medium's ``max(64, S // 8)`` frames (with which its encoder
contributes exactly nothing), llava-next-mistral-7b's 576 patch
embeddings, which take the first positions of the caches; decode goes on
after them (the reference's ``Server`` starts it at the prompt's length
instead, and its CLI sizes the ring without them: ROADMAP R8).
A prompt length the reference refuses (its attention chunks, or for the
recurrent families its scan chunks: at most 256 or a multiple of 256)
raises ``ValueError`` in the prefill.  Runs on the card unless the
caller asks for the CPU::

    python -m repro_torch.launch.serve --arch gemma2-9b --prompt-len 512 \
        --new-tokens 32 --requests 8 [--batch 4] [--smoke] [--device cuda]
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b ...
    python -m repro_torch.launch.serve --arch falcon-mamba-7b ...
    python -m repro_torch.launch.serve --arch recurrentgemma-2b ...
    python -m repro_torch.launch.serve --arch seamless-m4t-medium ...
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b ...

prints ``{"requests", "tokens", "wall_s", "tok_per_s"}``.  The weights
come from a seed (no checkpoint is read) and are served in bf16.

Every family also serves on a within-pod ("data", "model") mesh of D x
M ranks, one process each (``launch/mesh.py``'s ``spawn_mesh``; NCCL
with a card per rank, gloo where ranks share one)::

    python -m repro_torch.launch.serve --arch dbrx-132b --data 1 --model 4
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --data 1 \
        --model 4
    python -m repro_torch.launch.serve --arch llava-next-mistral-7b \
        --data 1 --model 4

(a frontend's zero inputs at the global batch, each rank keeping its
batch block of them, as of the tokens).

Each rank holds its shards of the weights (``init_model(ctx=)``) and its
part of the caches; the ``Server`` gathers the last position's logits
over "model" and the batch blocks over "data", so every rank holds every
token, and checks that they do at each step.  Rank 0 prints the JSON
line, each rank its weight bytes and peak memory.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.models.shardctx import ShardCtx


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_done: Optional[float] = None


class Server:
    """Static batching over ``model`` (its own weights, on its device):
    ring caches of ``cache_len`` positions, ``batch`` sequences each.
    ``ctx``: the mesh the model is sharded over, as the reference's
    ``mesh=`` (default ``model.ctx``; another raises)."""

    def __init__(self, model, cache_len: int, batch: int,
                 ctx: Optional[ShardCtx] = None):
        if ctx is not None and ctx is not model.ctx:
            raise ValueError("the Server's mesh context must be the one "
                             "its model is sharded over")
        self.model = model
        self.cache_len = cache_len
        self.batch = batch
        self.ctx = model.ctx

    def serve(self, requests: List[Request]) -> List[Request]:
        """Static batching: pad requests to the server batch, prefill,
        then decode until every request hit its token budget."""
        out = []
        with torch.inference_mode():
            for i in range(0, len(requests), self.batch):
                out.extend(self._serve_batch(requests[i:i + self.batch]))
        return out

    def _serve_batch(self, reqs: List[Request]) -> List[Request]:
        model = self.model
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch, S), np.int32)
        for j, r in enumerate(reqs):
            toks[j, S - len(r.prompt):] = r.prompt  # left-pad
            r.t_submit = time.time()
        # a frontend stub's inputs are zeros, as the reference serves them
        inputs = {k: torch.zeros(d, dtype=torch.float32, device=model.device)
                  for k, d in model.frontend_shapes(self.batch, S).items()}
        logits, caches = model.prefill(
            torch.from_numpy(toks).to(model.device), self.cache_len,
            **inputs)
        # decode goes on after every prefilled position: the VLM's patches
        # come first (the reference starts at S: ROADMAP R8)
        cache_len = model.n_prefix + S
        tokens = self._greedy(logits)
        max_new = max(r.max_new_tokens for r in reqs)
        for step in range(max_new):
            # the host reads the step's tokens once (the reference reads
            # them request by request)
            host = tokens[:, 0].tolist()
            for j, r in enumerate(reqs):
                if step < r.max_new_tokens:
                    r.out_tokens.append(host[j])
            logits, caches = model.decode_step(caches, cache_len, tokens)
            tokens = self._greedy(logits)
            cache_len += 1
        for r in reqs:
            r.t_done = time.time()
        return reqs

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The argmax over the vocabulary of the last position's logits
        (the first index among equal logits), (B, 1).  Under a mesh
        ``logits`` are this rank's batch block and vocabulary part: the
        parts are gathered over "model", the tokens over "data", and the
        world must then hold one set of tokens."""
        last = logits[:, -1]
        ctx = self.ctx
        if ctx is not None:
            last = ctx.all_gather(last, "model", dim=-1)
        tokens = last[:, :self.model.cfg.vocab_size].argmax(dim=-1)[:, None]
        if ctx is not None:
            tokens = ctx.gather_batch(tokens, self.batch)
            ctx.check_replicated(tokens, "the greedy tokens")
        return tokens


def init_model(cfg: ModelConfig, device="cuda", seed: int = 0,
               dtype=torch.bfloat16, ctx: Optional[ShardCtx] = None):
    """``cfg``'s model on ``device`` with seeded random weights held in
    ``dtype``: the Parameters are allocated in ``dtype`` and each stacked
    leaf is drawn in f32 one layer group at a time and cast as it is
    copied in, so no f32 temporary exceeds one slice of a leaf
    (qwen3-moe-30b-a3b: 60.44 GB in bf16; one (128, 2048, 768) expert
    slice, 0.81 GB in f32; falcon-mamba-7b's (4096, 16384) ``in_proj``,
    0.27 GB).  With ``ctx`` the model holds this rank's shards: each
    slice is drawn whole from the unsharded model's stream and the rest
    freed (dbrx-132b: one (16, 6144, 10752) expert slice, 4.2 GB in
    f32), so the shards equal the unsharded seeded model's, bit for
    bit."""
    dev = resolve_device(device)
    model = build_model(cfg, device="meta", ctx=ctx).to(dtype)
    model.to_empty(device=dev)
    model.device = dev
    model.init_params(torch.Generator(dev).manual_seed(seed))
    return model


def make_requests(prompt_lens, new_tokens: int, vocab: int,
                  seed: int = 0) -> List[Request]:
    """One request per prompt length, the prompts drawn in turn from
    ``np.random.RandomState(seed)`` as the reference CLI draws them."""
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(0, vocab, size=n).astype(np.int32),
                    new_tokens) for i, n in enumerate(prompt_lens)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-350m", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=1,
                    help="D: ranks the batch is split over")
    ap.add_argument("--model", type=int, default=1,
                    help="M: ranks heads (the encoder's and the "
                         "cross-attention's too), d_ff, experts, d_inner / "
                         "the RG-LRU's width and vocab split over")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.data * args.model == 1:
        _serve(None, vars(args))
    else:
        from repro_torch.launch.mesh import spawn_mesh
        spawn_mesh(_serve, args.data, args.model, args.device,
                   args=(vars(args),))


def _serve(ctx: Optional[ShardCtx], args: dict) -> None:
    """The CLI's run, on one device or as one rank of a mesh."""
    cfg = (SMOKE_ARCHS if args["smoke"] else ARCHS)[args["arch"]]
    model = init_model(cfg, args["device"] if ctx is None else ctx.device,
                       ctx=ctx)
    # the ring holds the VLM's patches too (the reference's does not: R8)
    server = Server(model, cache_len=(model.n_prefix + args["prompt_len"]
                                      + args["new_tokens"]),
                    batch=args["batch"])
    reqs = make_requests([args["prompt_len"]] * args["requests"],
                         args["new_tokens"], cfg.vocab_size)
    t0 = time.time()
    done = server.serve(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    if ctx is not None:
        dev = model.device
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB "
                f"allocated" if dev.type == "cuda" else "not measured "
                "(CPU)")
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        # one write with its newline: the ranks print at once, and an
        # unbuffered stream writes a print's end apart
        print(f"rank {ctx.rank} ({ctx.d}, {ctx.m}): {weights} weight bytes; "
              f"peak {peak}\n", end="", flush=True)
        ctx.world.barrier()
        if ctx.rank:
            return
    print(json.dumps({"requests": len(done), "tokens": n_tok,
                      "wall_s": round(dt, 2),
                      "tok_per_s": round(n_tok / dt, 1)}), flush=True)


if __name__ == "__main__":
    main()
