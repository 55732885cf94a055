"""PyTorch/CUDA port of the ACE-Sync training system.

Mirrors the module layout of the JAX package ``repro`` (the reference),
imports ``torch`` and never ``jax`` or anything of ``repro``.  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a usable
    card is an error, never a silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch was asked to run on CUDA but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev
