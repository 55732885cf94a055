"""Checkpoints of the recurrent families on a (2, 2) ("data", "model")
mesh against the live reference (see ``tests/torch_mesh_ckpt_ref.py``,
the shared body): the reference's ``Trainer(mesh=)`` steps SMOKE
falcon-mamba-7b and recurrentgemma-2b (f32) twice and saves with its
``Checkpointer``; the port's ranks save the same state on the mesh — the
files byte for byte the reference's, mamba's ``in_proj`` shards in the
reference's column order — and each package restores the other's
checkpoint bit for bit (the reference on its mesh and without one)."""
import pytest

import torch_mesh_ckpt_ref as R

ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
MESH = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_rec_ckpt")
    return (tmp,) + R.run_mesh(tmp, MESH, ARCHS, loop=False)


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
