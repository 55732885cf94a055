"""Checkpoints on a (2, 2) ("data", "model") mesh against the live
reference (see ``tests/torch_mesh_ckpt_ref.py``, the shared body and what
each case checks): the port's mesh checkpoint of the reference's state
byte for byte the reference's, each package restoring the other's, and
the loop's resume, corruption fallback, failed write and refusal of
another arch's checkpoint on every rank.  The reference's (2, 2)
checkpoint of SMOKE paper-350m (four K/V heads: the archs with two do
not train on four "model" ranks) also restores onto a (1, 4) mesh."""
import numpy as np
import pytest

import torch_mesh_ckpt_ref as R

MESH = (2, 2)
WIDE_ARCH = "paper-350m"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    return (tmp,) + R.run_mesh(tmp, MESH, R.ARCHS + (WIDE_ARCH,))


@pytest.mark.parametrize("arch", R.ARCHS + (WIDE_ARCH,))
def test_mesh_checkpoint_files_are_the_references(runs, arch):
    R.check_files(runs[0], arch)
    R.check_save_numbers(runs[2], arch)


@pytest.mark.parametrize("arch", R.ARCHS + (WIDE_ARCH,))
def test_reference_restores_the_ports_mesh_checkpoint(runs, arch):
    R.check_reference_restores(runs[1], arch)


@pytest.mark.parametrize("arch", R.ARCHS + (WIDE_ARCH,))
def test_port_restores_the_references_mesh_checkpoint(runs, arch):
    R.check_port_restores(runs[0], runs[2], arch)


def test_references_mesh_checkpoint_restores_on_1x4(runs):
    """Each rank of a (1, 4) mesh restores the reference's (2, 2)
    checkpoint to the reference's leaves cut by its index, bit for bit,
    and the ranks assemble (``convert.reference_from_shards``) to the
    whole state."""
    from repro_torch import convert
    from repro_torch.launch.mesh import spawn_mesh
    from torch_mesh_ckpt_ranks import restore_rank
    tmp = runs[0]
    want = dict(np.load(tmp / f"{WIDE_ARCH}_state.npz"))
    got = spawn_mesh(restore_rank, 1, 4, "cpu",
                     args=(WIDE_ARCH, str(tmp / "ref" / WIDE_ARCH)),
                     init_method=f"file://{tmp / 'store14'}", threads=1,
                     timeout=600)
    for rank, shards in enumerate(got):
        for key, (part, index, _) in shards.items():
            np.testing.assert_array_equal(part, want[key][index],
                                          err_msg=f"rank {rank} {key}")
    whole = convert.reference_from_shards(got)
    assert set(whole) == set(want)
    for key, x in want.items():
        np.testing.assert_array_equal(whole[key], x, err_msg=key)


def test_resumed_mesh_run_replays_bit_for_bit(runs):
    R.check_resume(runs[0], runs[2])


def test_corrupt_leaf_falls_back_on_every_rank(runs):
    R.check_corruption(runs[2])


def test_failed_shard_write_fails_on_every_rank(runs):
    R.check_write_failure(runs[2])


def test_another_archs_checkpoint_raises_on_every_rank(runs):
    R.check_other_arch(runs[2])
