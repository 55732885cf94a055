"""Training the dense zoo through the port, held to the reference on the
CPU: SMOKE paper-350m, qwen3-8b, gemma2-9b, minitron-8b and
starcoder2-3b — gradients in f32 and bf16, the loss's per-chunk
recompute, the sync groups and default plan, the Trainer's step kinds
(gemma2-9b, qwen3-8b), sessions and the CLI.  The body and its
tolerances: ``tests/torch_train_zoo_ref.py``; the other families:
``tests/test_torch_train_zoo_{moe,recurrent,frontend}.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

from test_torch_models import DENSE
import torch_train_zoo_ref as Z
from torch_train_zoo_ref import step_trainers  # noqa: F401 (a fixture)

ARCHS = DENSE
STEP_ARCHS = [a for a in sorted(Z.STEP_ARCHS) if a in ARCHS]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference_f32(arch):
    Z.check_grads_match_reference_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference_bf16(arch, monkeypatch):
    Z.check_grads_match_reference_bf16(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["gemma2-9b"])
def test_loss_chunk_recompute_keeps_the_gradients(arch, monkeypatch):
    Z.check_loss_chunk_recompute_keeps_the_gradients(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_groups_and_default_plan_match(arch):
    Z.check_sync_groups_and_default_plan_match(arch)


@pytest.mark.parametrize("kind", sorted(Z.KIND_SEQS))
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_trainer_step_kinds_match(step_trainers, arch, kind):
    Z.check_trainer_step_kinds_match(step_trainers, arch, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_session_trains_every_smoke_arch(arch, tmp_path):
    Z.check_session_trains_every_smoke_arch(arch, tmp_path)


@pytest.mark.parametrize("arch", ["gemma2-9b"])
def test_cli_trains_a_zoo_arch_on_cpu(arch, tmp_path, capsys):
    Z.check_cli_trains_a_zoo_arch_on_cpu(arch, tmp_path, capsys)
