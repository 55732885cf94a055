"""Training the encoder-decoder and the VLM through the port, held to the
reference on the CPU: SMOKE seamless-m4t-medium and
llava-next-mistral-7b, fed the pipeline's seeded non-zero frames / patch
embeddings — gradients in f32 and bf16, the sync groups and default
plan, the Trainer's step kinds, sessions, the CLI, and the pipeline's
float inputs per pod against the reference's.  The body and its
tolerances: ``tests/torch_train_zoo_ref.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

from test_torch_models import FRONTEND
import torch_train_zoo_ref as Z
from torch_train_zoo_ref import step_trainers  # noqa: F401 (a fixture)

ARCHS = FRONTEND
STEP_ARCHS = [a for a in sorted(Z.STEP_ARCHS) if a in ARCHS]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference_f32(arch):
    Z.check_grads_match_reference_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference_bf16(arch, monkeypatch):
    Z.check_grads_match_reference_bf16(arch, monkeypatch)


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


@pytest.mark.parametrize("arch", FRONTEND)
def test_cli_trains_a_zoo_arch_on_cpu(arch, tmp_path, capsys):
    Z.check_cli_trains_a_zoo_arch_on_cpu(arch, tmp_path, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_frontend_inputs_match_reference(arch):
    Z.check_pipeline_frontend_inputs_match_reference(arch)
