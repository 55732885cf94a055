"""Parity of the port's serving path with the JAX reference on the CPU for
the recurrent families (SMOKE falcon-mamba-7b, recurrentgemma-2b):
``prefill`` / ``decode_step`` logits and caches per step and the
``Server`` against the reference.  The shared bodies and their
tolerances: ``tests/torch_serve_ref.py``."""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

from test_torch_models import RECURRENT
import torch_serve_ref as V


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_decode_match_reference(arch, dtype, monkeypatch):
    V.check_prefill_decode_match_reference(arch, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_server_tokens_match_reference(arch, dtype, monkeypatch):
    V.check_server_tokens_match_reference(arch, dtype, monkeypatch)
