"""The Trainer on a (2, 2) ("data", "model") mesh against the live
reference (see ``tests/torch_mesh_train_ref.py``, the shared body and
its tolerances): each rank's local sizes and default plan, the sync
round on its shards, and the step kinds' losses, grad norms and state
shards, for SMOKE qwen3-8b, gemma2-9b, qwen3-moe-30b-a3b and dbrx-132b."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

from torch_mesh_train_ranks import KIND_SEQS
import torch_mesh_train_ref as R

MESH = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.run_mesh(tmp_path_factory.mktemp("mesh_train"), MESH)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_local_sizes_and_plan_match_reference(runs, arch):
    R.check_sizes_and_plan(*runs, arch)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_sync_round_is_the_references_on_each_shard(runs, arch):
    R.check_sync_round(*runs, arch)


@pytest.mark.parametrize("seq", sorted(KIND_SEQS))
@pytest.mark.parametrize("arch", R.ARCHS)
def test_step_kinds_match_reference(runs, arch, seq):
    R.check_step_kinds(*runs, arch, seq)
