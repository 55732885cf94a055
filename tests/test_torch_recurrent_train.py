"""The backward of the port's recurrent scans against the JAX reference on
the CPU: mamba's ``SelectiveScan`` (a backward that recomputes one
chunk at a time from the saved chunk-start states) against ``jax.grad``
of ``repro.models.mamba.selective_scan_chunked``, and autograd through
the RG-LRU scan against ``jax.grad`` of ``repro.models.rglru.rglru_scan``,
with seeded numpy cotangents on y and hT, for every input; what the
backward holds; and that the forward and the served path keep their
bits.  The models' gradients, step kinds, sessions and CLI are in
tests/test_torch_train_zoo.py.

Tolerances: f32, every input's gradient within ``GRAD_REL`` = 1e-5 of
that gradient's largest magnitude (the two scan in other orders, which
moves f32 results by ~3e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JMa
from repro.models import rglru as JR
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.memory import _saved_bytes
from repro_torch.models import flops
from repro_torch.models import mamba as M
from repro_torch.models import rglru as R
from test_torch_recurrent import _Largest, _scan_inputs

GRAD_REL = 1e-5
LENGTHS = [64, 256, 512, 1024]


def _leaves(arrays, requires_grad=True):
    return [torch.tensor(a, dtype=torch.float32, requires_grad=requires_grad)
            for a in arrays]


def _grads_match(tfn, jfn, args, cots):
    """``tfn`` / ``jfn`` map ``args`` to (y, hT); their gradients of
    <y, cots[0]> + <hT, cots[1]> for every input."""
    ins = _leaves(args)
    got = torch.autograd.grad(tfn(*ins), ins, _leaves(cots, False))

    def loss(*xs):
        y, hT = jfn(*xs)
        return (jnp.vdot(y, jnp.asarray(cots[0], jnp.float32))
                + jnp.vdot(hT, jnp.asarray(cots[1], jnp.float32)))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a, jnp.float32) for a in args))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        g = g.numpy().astype(np.float64)
        assert g.shape == w.shape, i
        rel = float(np.abs(g - w).max() / np.abs(w).max())
        assert rel <= GRAD_REL, (i, rel)


@pytest.mark.parametrize("S", LENGTHS)
def test_selective_scan_grads_match_reference(S):
    a = _scan_inputs(S, seed=S)
    r = np.random.RandomState(S + 1)
    B, Di, N = a["h0"].shape
    _grads_match(M.SelectiveScan.apply, JMa.selective_scan_chunked,
                 list(a.values()), [r.randn(B, S, Di), r.randn(B, Di, N)])


@pytest.mark.parametrize("S", LENGTHS)
def test_rglru_scan_grads_match_reference(S):
    r = np.random.RandomState(S)
    B, Dr = 2, 48
    args = [r.randn(B, S, Dr), 1.0 / (1.0 + np.exp(-r.randn(B, S, Dr))),
            r.randn(B, Dr)]
    _grads_match(R.rglru_scan, JR.rglru_scan, args,
                 [r.randn(B, S, Dr), r.randn(B, Dr)])


def test_selective_scan_backward_holds_one_chunk_at_a_time():
    """Over 1024 positions (4 chunks) the backward makes no tensor larger
    than one chunk's (B, 256, Di, N), and what the forward saves for it
    (the inputs and the chunk-start states, counted by
    ``saved_tensors_hooks``) is less than one (B, S, Di, N) f32 tensor:
    ``flops.scan_start_bytes`` of states beside the inputs."""
    cfg = SMOKE_ARCHS["falcon-mamba-7b"]
    B, S, Di, N = 1, 1024, cfg.d_inner, cfg.ssm_state
    ins = _leaves(_scan_inputs(S, B=B, Di=Di, N=N).values())
    (y, hT), saved = _saved_bytes(lambda: M.SelectiveScan.apply(*ins))
    assert saved < B * S * Di * N * 4
    starts = flops.scan_start_bytes(cfg, ShapeConfig("t", S, B, "train"))
    assert saved == starts + sum(t.numel() * 4 for t in ins[:5])
    with _Largest() as seen:
        grads = torch.autograd.grad((y.sum() + hT.sum()), ins)
    assert all(torch.isfinite(g).all() for g in grads)
    assert seen.numel == B * M.SCAN_CHUNK * Di * N < B * S * Di * N


def test_plain_autograd_holds_the_whole_sequence():
    """The control of the test above: autograd through the chunked scan
    itself saves more than one (B, S, Di, N) f32 tensor."""
    B, S, Di, N = 1, 1024, 16, 4
    ins = _leaves(_scan_inputs(S, B=B, Di=Di, N=N).values())
    _, saved = _saved_bytes(lambda: M.selective_scan_chunked(*ins))
    assert saved > 4 * B * S * Di * N * 4


@pytest.mark.parametrize("grad", [False, True])
def test_selective_scan_keeps_the_forward_bits(grad):
    """``SelectiveScan`` gives ``selective_scan_chunked``'s bits whether
    a gradient is asked for (trained) or not (served, under
    ``inference_mode``), and records a graph only for the former."""
    ins = _leaves(_scan_inputs(512, seed=3).values(), requires_grad=grad)
    want = M.selective_scan_chunked(*(t.detach() for t in ins))
    with torch.inference_mode(not grad):
        got = M.SelectiveScan.apply(*ins)
    assert (got[0].grad_fn is not None) == grad
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)


def test_scan_start_bytes():
    """One mamba layer's saved chunk-start states: a (B, Di, N) f32 state
    per 256 positions (one chunk below 256), none for the other
    families."""
    cfg = SMOKE_ARCHS["falcon-mamba-7b"]
    per = 8 * cfg.d_inner * cfg.ssm_state * 4
    assert flops.scan_start_bytes(cfg, ShapeConfig("t", 1024, 8,
                                                   "train")) == 4 * per
    assert flops.scan_start_bytes(cfg, ShapeConfig("t", 64, 8,
                                                   "train")) == per
    assert flops.scan_start_bytes(SMOKE_ARCHS["recurrentgemma-2b"],
                                  ShapeConfig("t", 1024, 8, "train")) == 0
