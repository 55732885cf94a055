"""Parity of the port's one-pod sync with the reference: ``sync_tree`` on
the smoke model's gradient tree, under a backward-segmented plan whose
groups cover all 8 ladder rungs, fed the same f32 grads and nonzero
error-feedback residuals.  The reference runs with ``use_pallas=True``
(its producer-fused Pallas kernels, interpreted on the CPU).

Tolerances: bit-exact (int32 bit patterns) for every leaf except those on
the SIGN1 rung, whose per-block scale may differ by at most 8 ulp (XLA
sums ``mean|ef|`` in another order); there the aggregate and the residual
may differ by at most 8 ulp of the block scale.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ACESyncConfig as JACE
from repro.core import planexec as jpe
from repro.core import sync as jsync
from repro.core.scheduler import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ACESyncConfig
from repro_torch.core import planexec as tpe
from repro_torch.core import sync as tsync
from repro_torch.core.scheduler import Scheduler as TScheduler
from repro_torch.models.registry import build_model as tbuild

SIGN_ULP = 8
SIGN_RUNG = 5


def _tsched(sizes):
    return TScheduler(ACESyncConfig(), sizes, 1, device="cpu")


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _tree_np(shapes, seed, scale=1.0):
    r = np.random.RandomState(seed)
    return T.tree_map(lambda s: (r.randn(*s) * scale).astype(np.float32),
                      shapes)


@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("shift", [0, 3])
def test_sync_tree_matches_reference(segments, shift):
    shapes = tbuild(SMOKE_ARCHS["paper-350m"], device="cpu").param_shapes()
    metas = tsync.group_metas(shapes)
    sizes = [m.size for m in metas]
    li = [(i + shift) % 8 for i in range(len(sizes))]
    assert sorted(set(li)) == list(range(8))
    g_np = _tree_np(shapes, 1)
    e_np = _tree_np(shapes, 2, 0.3)
    gamma = 0.9

    jplan = JScheduler(JACE(), sizes, 1).plan_from_levels(li, (1.0,))
    jep = jpe.build_exec_plan(jplan, sizes, segments=segments)

    @jax.jit
    def ref(g, e, ep):
        return jsync.sync_tree(g, e, ep, mesh=None, shardings=None,
                               gamma=gamma, use_pallas=True)

    jagg, jerr = ref(jax.tree.map(jnp.asarray, g_np),
                     jax.tree.map(jnp.asarray, e_np), jep)

    tplan = _tsched(sizes).plan_from_levels(
        li, (1.0,))
    tep = tpe.build_exec_plan(tplan, sizes, segments=segments,
                               device="cpu")
    assert tep.segmented == (segments > 1)
    tagg, terr = tsync.sync_tree(T.tree_map(torch.from_numpy, g_np),
                                 T.tree_map(torch.from_numpy, e_np), tep,
                                 gamma=gamma)
    jl = jax.tree_util.tree_leaves(jagg), jax.tree_util.tree_leaves(jerr)
    tl = T.leaves(tagg), T.leaves(terr)
    for i, m in enumerate(metas):
        for want, got in ((jl[0][i], tl[0][i]), (jl[1][i], tl[1][i])):
            want, got = np.asarray(want), got.numpy()
            assert got.shape == want.shape
            if li[i] != SIGN_RUNG:
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=m.name)
            else:
                # per-block scale bound: |agg| of a block is its scale
                blk = np.abs(np.asarray(jl[0][i])).reshape(-1)
                pad = (-blk.size) % 1024
                s = np.concatenate([blk, np.zeros(pad, blk.dtype)]) \
                    .reshape(-1, 1024).max(axis=1, keepdims=True)
                tol = np.broadcast_to(SIGN_ULP * np.spacing(s),
                                      (s.shape[0], 1024)).reshape(-1)
                diff = np.abs(got - want).reshape(-1)
                assert np.all(diff <= tol[:diff.size]), m.name


def test_sync_tree_apply_fn_matches_plain_scatter():
    """The rung-ordered apply path hands each rung's aggregate rows to
    apply_fn and scatters its outputs back — equal to applying the same
    function to the whole aggregate."""
    shapes = tbuild(SMOKE_ARCHS["paper-350m"], device="cpu").param_shapes()
    sizes = [m.size for m in tsync.group_metas(shapes)]
    plan = _tsched(sizes).plan_from_levels(
        [i % 8 for i in range(len(sizes))], (1.0,))
    ep = tpe.build_exec_plan(plan, sizes, segments=2, device="cpu")
    g = T.tree_map(torch.from_numpy, _tree_np(shapes, 3))
    e = T.tree_map(torch.from_numpy, _tree_np(shapes, 4, 0.1))
    a = T.tree_map(torch.from_numpy, _tree_np(shapes, 5))
    agg, err = tsync.sync_tree(g, e, ep, gamma=1.0)
    (out,), err2 = tsync.sync_tree(
        g, e, ep, gamma=1.0, apply_fn=lambda d, aux, s: (aux[0] + d,),
        apply_aux=(a,))
    for x, y, z in zip(T.leaves(out), T.leaves(a), T.leaves(agg)):
        torch.testing.assert_close(x, y + z, rtol=0, atol=0)
    for x, y in zip(T.leaves(err), T.leaves(err2)):
        assert torch.equal(x, y)


def test_sync_tree_multi_pod_raises():
    """What the multi-pod exchange refuses: a plan whose omega does not
    match the pod count (a 2-pod plan run without its pod group) —
    instead of quietly running something else.  A two-tier fleet lowers
    (INT8 two-tier, FULL flat); it is held to the live reference in
    tests/test_torch_hier.py, and the ring (ring_chunks 0 = auto, or
    K > 0) to the one-shot exchange and the reference in
    tests/test_torch_ring.py."""
    sizes = [4096, 2048]
    plan = TScheduler(ACESyncConfig(), sizes, 2,
                      device="cpu").plan_from_levels([1, 0], (0.5, 0.5))
    hep = tpe.build_exec_plan(plan, sizes, n_pods=4, n_edge=2, hier=2,
                              device="cpu")
    assert hep.hier[:2] == (0, tpe.INTRA_INT8)
    ep = tpe.build_exec_plan(plan, sizes, n_pods=2, ring=2, device="cpu")
    assert ep.chunks == (0, 2) + (0,) * (len(ep.chunks) - 2)
    tree = {"a": torch.zeros(4096), "b": torch.zeros(2048)}
    with pytest.raises(ValueError, match="2 weights for 1 pods"):
        tsync.sync_tree(tree, tree, ep, gamma=1.0)
