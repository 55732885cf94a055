"""The Trainer on a (2, 2) ("data", "model") mesh against the live
reference for the encoder-decoder and the VLM: SMOKE seamless-m4t-medium
(the encoder's and the decoder's stacks, the cross-attention, a
vocab-parallel head) and llava-next-mistral-7b (its patches blocked with
the tokens; two K/V heads), fed the pipeline's seeded non-zero frames /
patch embeddings: each rank's local sizes and default plan, the sync
round on its shards, and the step kinds' losses, grad norms and state
shards (see ``tests/torch_mesh_train_ref.py``, the shared body and its
tolerances), the reference's sync round through its interpreted
kernels (``kernels=True``: the top-k rungs' bisection, as the port's
K4)."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

from torch_mesh_train_ranks import KIND_SEQS
import torch_mesh_train_ref as R

ARCHS = ("seamless-m4t-medium", "llava-next-mistral-7b")
MESH = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.run_mesh(tmp_path_factory.mktemp("mesh_frontend_train"), MESH,
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
