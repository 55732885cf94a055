"""Checkpoints on a (2, 1) ("data", "model") mesh against the live
reference (see ``tests/torch_mesh_ckpt_ref.py``, the shared body and what
each case checks): the port's mesh checkpoint of the reference's state
byte for byte the reference's, each package restoring the other's, and
the loop's resume, corruption fallback, failed write and refusal of
another arch's checkpoint on every rank.  The archs: SMOKE
qwen3-8b and dbrx-132b (FSDP over "data"; the (2, 2) file runs both MoE
archs)."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

import torch_mesh_ckpt_ref as R

ARCHS = ("qwen3-8b", "dbrx-132b")
MESH = (2, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    return (tmp,) + R.run_mesh(tmp, MESH, ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_checkpoint_files_are_the_references(runs, arch):
    R.check_files(runs[0], arch)
    R.check_save_numbers(runs[2], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_restores_the_ports_mesh_checkpoint(runs, arch):
    R.check_reference_restores(runs[1], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_restores_the_references_mesh_checkpoint(runs, arch):
    R.check_port_restores(runs[0], runs[2], arch)


def test_resumed_mesh_run_replays_bit_for_bit(runs):
    R.check_resume(runs[0], runs[2])


def test_corrupt_leaf_falls_back_on_every_rank(runs):
    R.check_corruption(runs[2])


def test_failed_shard_write_fails_on_every_rank(runs):
    R.check_write_failure(runs[2])


def test_another_archs_checkpoint_raises_on_every_rank(runs):
    R.check_other_arch(runs[2])
