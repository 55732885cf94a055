"""The port's side of ``tests/torch_mesh_heads_ref.py``: one rank of a
("data", "model") mesh serving and training a SMOKE config whose query
heads "model" does not divide, run in a process of its own by
``spawn_mesh``.  Kept apart from the test files, which import JAX: a
spawned rank imports this module by name and nothing of the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer, MeshLayout
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.trainer import Trainer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import build_model
from torch_mesh_train_ranks import flat_state

#: SMOKE configs cut to 3 query heads of 16 columns and one K/V head:
#: "model" = 2 divides their 48 columns, not their heads (both packages
#: build the same)
HEADS = {"n_heads": 3, "n_kv_heads": 1, "head_dim": 16}
#: the teacher-forced run (batch, prompt, cache, decode steps) and the
#: train step's shape and learning rate
B, SP, CACHE, STEPS = 2, 16, 20, 2
SEQ, BATCH, LR = 32, 4, 1e-2
#: the checkpoint's step
STEP = 1


def heads_config(arch: str):
    return dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32", **HEADS)


def run_config(arch: str) -> RunConfig:
    return RunConfig(model=heads_config(arch),
                     shape=ShapeConfig("t", SEQ, BATCH, "train"), lr=LR,
                     warmup_steps=1, total_steps=50)


def heads_rank(ctx, arch, ref_path, tf_tokens, ckpt_dir):
    """One rank: from the reference's weights, the prefill's and decode
    steps' logits (its vocabulary part); from the reference's initial
    state, one ``local`` step (loss, grad norm, the params' shards); that
    state saved to ``ckpt_dir`` on the mesh."""
    torch.set_num_threads(1)
    ref = np.load(ref_path)
    weights = {k[len("params/"):]: ref[k] for k in ref.files
               if k.startswith("params/")}
    model = build_model(heads_config(arch), device="cpu", ctx=ctx)
    convert.params_from_reference(convert.shard_params(weights, model),
                                  model)
    toks = torch.from_numpy(tf_tokens)
    out = {"coords": (ctx.d, ctx.m)}
    with torch.inference_mode():
        logits, caches = model.prefill(toks[:, :SP], CACHE)
        out["logits0"] = logits.numpy()
        for i in range(STEPS):
            logits, caches = model.decode_step(caches, SP + i,
                                               toks[:, SP + i:SP + i + 1])
            out[f"logits{i + 1}"] = logits.numpy()
    run = run_config(arch)
    tr = Trainer(build_model(run.model, run, device="cpu", ctx=ctx), run,
                 strategy="acesync")
    state = convert.state_from_reference(
        {k[len("state0/"):]: ref[k] for k in ref.files
         if k.startswith("state0/")}, tr)
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(tr.model, run.shape, seed=0).host_batch(0).items()}
    state, m = tr.step(state, batch, tr.default_plan(), "local")
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               index={k[len("params/"):]: tr.model.shard_index(
                   k[len("params/"):]) for k in flat_state(state)
                   if k.startswith("params/")},
               params={k: v for k, v in flat_state(state).items()
                       if k.startswith("params/")})
    Checkpointer(ckpt_dir, mesh=MeshLayout(ctx.world, tr.state_layout)).save(
        STEP, state, blocking=True)
    return out
