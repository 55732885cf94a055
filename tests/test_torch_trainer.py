"""End-to-end parity of the port with the reference on the paper-350m
smoke model: the model's loss and gradients, and the Trainer's step kinds
(``grad_sync``, ``local``, ``delta_sync``) run from the reference's own
initial state (carried across by ``repro_torch.convert``) on the same
batches; every strategy trains paper-350m and qwen3-moe-30b-a3b, and the
families not ported are refused (the rest of the zoo:
tests/test_torch_train_zoo.py).

Tolerances: bf16 model compute rounds at other places in the two
frameworks (and the port's attention is SDPA), so losses agree to 2e-2
relative, and each gradient leaf has cosine similarity above 0.999 with
the reference's.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.configs.base import RunConfig as JRun, ShapeConfig as JShape
from repro.core.trainer import Trainer as JTrainer
from repro.models.registry import build_model as jbuild
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ACESyncConfig, RunConfig, ShapeConfig
from repro_torch.core.trainer import Trainer as TTrainer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.session import TrainSession
from repro_torch.models.registry import build_model as tbuild

SEQ, BATCH = 32, 2
RUN_KW = dict(lr=1e-2, warmup_steps=1, total_steps=50)
LOSS_RTOL = 2e-2
GRAD_COS = 0.999


def _runs():
    j = JRun(model=J_SMOKE["paper-350m"],
             shape=JShape("t", SEQ, BATCH, "train"), **RUN_KW)
    t = RunConfig(model=SMOKE_ARCHS["paper-350m"],
                  shape=ShapeConfig("t", SEQ, BATCH, "train"), **RUN_KW)
    return j, t


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def _flat(tree, strip_pod=True):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[_key(path)] = a[0] if strip_pod else a
    return out


def _batches(model, n, seed=0):
    pipe = TokenPipeline(model, model.run.shape, seed=seed)
    return [pipe.host_batch(i) for i in range(n)]


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_model_loss_and_grads_match():
    jrun, trun = _runs()
    jm = jbuild(jrun.model, jrun)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(trun.model, trun, device="cpu")
    flat = _flat(params, strip_pod=False)
    with torch.no_grad():
        for path, p in T.leaves_with_path(tm.param_tree()):
            p.copy_(torch.from_numpy(np.array(flat["/".join(path)])))
    batch = _batches(tm, 1)[0]
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(params, _jb(batch))
    leaves = T.leaves(tm.param_tree())
    tl = tm.loss(_tb(batch))
    tg = torch.autograd.grad(tl, leaves)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        w = np.asarray(want).reshape(-1).astype(np.float64)
        g = got.numpy().reshape(-1).astype(np.float64)
        cos = w @ g / (np.linalg.norm(w) * np.linalg.norm(g) + 1e-30)
        assert cos > GRAD_COS, (_key(path), cos)


KIND_SEQS = {
    "grad_sync": ["grad_sync"] * 3,
    "local": ["local"] * 3,
    "delta_sync": ["local", "delta_sync"] * 3 + ["local"],
}


@pytest.fixture(scope="module")
def setups():
    jrun, trun = _runs()
    jm = jbuild(jrun.model, jrun)
    jt = JTrainer(jm, jrun, mesh=None, strategy="acesync")
    tm = tbuild(trun.model, trun, device="cpu")
    tt = TTrainer(tm, trun, strategy="acesync")
    return jt, tt


@pytest.mark.parametrize("kind", sorted(KIND_SEQS))
def test_trainer_step_kinds_match(setups, kind):
    jt, tt = setups
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = convert.state_from_reference(_flat(jstate), tt)
    jplan, tplan = jt.default_plan(), tt.default_plan()
    assert tplan.level_idx == jplan.level_idx
    assert tplan.bucket_sig == jplan.bucket_sig
    seq = KIND_SEQS[kind]
    batches = _batches(tt.model, len(seq))
    jl, tl = [], []
    for k, b in zip(seq, batches):
        jstate, jmet = jt.step(jstate, _jb(b), jplan, k)
        tstate, tmet = tt.step(tstate, _tb(b), tplan, k)
        assert set(tmet) == set(jmet)
        if "loss" in jmet:
            jl.append(float(jmet["loss"]))
            tl.append(float(tmet["loss"]))
    assert len(tl) >= 3
    print(kind, "losses port", tl, "reference", jl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert int(tstate["step"]) == int(np.asarray(jstate["step"])[0])


def test_entry_points_default_to_cuda(tmp_path):
    """Without a device argument the entry points ask for the card, and
    raise here instead of running on the CPU: the session (with or without
    a fault schedule), the model and the train CLI."""
    from repro_torch.launch import train
    from repro_torch.runtime.faults import FaultSchedule
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainSession.from_config("paper-350m", smoke=True, steps=2,
                                 ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainSession.from_config(
            "paper-350m", smoke=True, steps=2, ckpt_dir=str(tmp_path),
            fault_schedule=FaultSchedule.preempt_and_rejoin(1, 2, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild(SMOKE_ARCHS["paper-350m"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


def test_session_runs_on_cpu_when_asked(tmp_path):
    """The main path through the session facade: 8 acesync steps with two
    delta_sync rounds and one device replan (the smoke CLI's path)."""
    sess = TrainSession.from_config(
        "paper-350m", smoke=True, seq_len=SEQ, batch=BATCH, steps=8,
        device="cpu", warmup_steps=1, ckpt_dir=str(tmp_path),
        acesync=ACESyncConfig(replan_every=4))
    sess.run(8, log_every=0)
    kinds = [k for h in sess.history for k in h["kinds"]]
    assert kinds.count("delta_sync") == 2
    assert sess.loop.device_replans == 1
    assert all(np.isfinite(sess.losses)) and len(sess.losses) == 8
    assert sess.comm_bytes > 0


@pytest.mark.parametrize("kind", ["grad_sync", "delta_sync"])
def test_rung_ordered_apply_equals_barriered_apply(kind):
    """``overlap_apply`` (AdamW / the anchor update applied per rung, on
    the rung's rows) gives bit-identical state to applying the whole
    aggregate after the sync: the same elementwise math either way."""
    import dataclasses
    _, trun = _runs()
    outs = []
    for overlap in (True, False):
        run = trun.replace(acesync=dataclasses.replace(
            trun.acesync, overlap_apply=overlap))
        tr = TTrainer(tbuild(run.model, run, device="cpu"), run)
        state = tr.init_state(0)
        plan = tr.scheduler.plan_from_levels(
            [i % 8 for i in range(len(tr.sizes))], (1.0,))
        for b in _batches(tr.model, 2):
            if kind == "delta_sync":
                state, _ = tr.step(state, _tb(b), plan, "local")
            state, _ = tr.step(state, _tb(b), plan, kind)
        outs.append([p.detach().clone() for p in T.leaves(state["params"])]
                    + T.leaves(state["ace"].errors))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("strategy", ["acesync", "acesync_hier",
                                      "bandwidth_tiered", "fedavg",
                                      "fullsync", "localsgd", "topk"])
@pytest.mark.parametrize("arch", ["paper-350m", "qwen3-moe-30b-a3b"])
def test_every_strategy_trains_on_cpu(tmp_path, strategy, arch):
    from repro_torch.strategies import list_strategies
    assert strategy in list_strategies()
    sess = TrainSession.from_config(
        arch, strategy=strategy, smoke=True, seq_len=SEQ,
        batch=BATCH, steps=4, device="cpu", warmup_steps=1,
        ckpt_dir=str(tmp_path))
    sess.run(4, log_every=0)
    assert len(sess.losses) == 4 and all(np.isfinite(sess.losses))


#: the families' SMOKE archs which the Trainer refused until it trained
#: them: the recurrent ones and the encoder-decoder
_RECURRENT = {"ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b",
              "encdec": "seamless-m4t-medium"}


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec", "vlm"])
def test_training_refuses_an_unported_family(family, tmp_path):
    """A family the port does not have ("vlm" is no family of the zoo:
    the VLM is the dense family behind a stub) is refused loudly by the
    registry and the Trainer.  The recurrent ones (ssm, hybrid) and the
    encoder-decoder (encdec) are trained now: their real SMOKE models
    take a ``grad_sync`` step to a finite loss and finite parameters."""
    import dataclasses
    import types
    run_shape = ShapeConfig("t", SEQ, BATCH, "train")
    if family in _RECURRENT:
        cfg = SMOKE_ARCHS[_RECURRENT[family]]
        run = RunConfig(model=cfg, shape=run_shape, ckpt_dir=str(tmp_path))
        tr = TTrainer(tbuild(cfg, run, device="cpu"), run)
        assert tr.model.cfg.family == family
        state, m = tr.step(tr.init_state(0), _tb(_batches(tr.model, 1)[0]),
                           tr.default_plan(), "grad_sync")
        assert np.isfinite(float(m["loss"]))
        assert all(bool(torch.isfinite(p).all())
                   for p in T.leaves(state["params"]))
        return
    cfg = dataclasses.replace(SMOKE_ARCHS["paper-350m"], family=family)
    run = RunConfig(model=cfg, shape=run_shape, ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match=family):
        tbuild(cfg, run, device="cpu")
    with pytest.raises(NotImplementedError, match=family):
        TTrainer(types.SimpleNamespace(cfg=cfg, device="cpu"), run)
