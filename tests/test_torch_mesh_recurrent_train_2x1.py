"""The Trainer on a (2, 1) ("data", "model") mesh against the live
reference for the recurrent families, SMOKE falcon-mamba-7b (d_inner and
its fused [u | z] projection over "model") and recurrentgemma-2b (the
RG-LRU's channels, its local attention's one K/V head split by columns):
each rank's local sizes and default plan, the sync round on its shards,
and the step kinds' losses, grad norms and state shards (see
``tests/torch_mesh_train_ref.py``, the shared body and its
tolerances), the reference's sync round through its interpreted
kernels (``kernels=True``: the top-k rungs' bisection, as the port's
K4)."""
import pytest

from torch_mesh_train_ranks import KIND_SEQS
import torch_mesh_train_ref as R

ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
MESH = (2, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.run_mesh(tmp_path_factory.mktemp("mesh_rec_train"), MESH,
                      ARCHS, kernels=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_sizes_and_plan_match_reference(runs, arch):
    R.check_sizes_and_plan(*runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_round_is_the_references_on_each_shard(runs, arch):
    R.check_sync_round(*runs, arch)


@pytest.mark.parametrize("seq", sorted(KIND_SEQS))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_kinds_match_reference(runs, arch, seq):
    R.check_step_kinds(*runs, arch, seq)
