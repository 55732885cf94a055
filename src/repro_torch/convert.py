"""Carry a train state across from the JAX reference.

The two packages draw their random inits from different RNG streams, so
parity runs start the port from the reference's own initial state.
:func:`state_from_reference` takes that state as numpy arrays keyed by
path — dict keys and NamedTuple field names joined with "/", with the
reference's leading pod dimension stripped — e.g.::

    params/blocks/slot0/attn/wq      m/embed            step
    anchor/final_norm                ace/errors/embed   ace/struct_feat
    ace/importance/params/w1         ace/importance/opt_v/wq
    ace/importance/feat_ema          ace/div_ema        ace/mse_ema

and returns the port's train state: the model's Parameters are loaded in
place (they stay the ``params`` leaves), every other leaf becomes a tensor
on the trainer's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.acesync import ACEState
from repro_torch.core.importance import ImportanceState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def state_from_reference(flat: Dict[str, np.ndarray], trainer) -> dict:
    """The port's train state from the reference's (see module doc)."""
    dev = trainer.device
    tree = T.from_flat_dict(flat)
    params = trainer.model.param_tree()
    with torch.no_grad():
        for path, p in T.leaves_with_path(params):
            src = flat["params/" + T.path_str(path)]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"params/{T.path_str(path)}: shape "
                                 f"{src.shape} != {tuple(p.shape)}")
            p.copy_(_tensor(src, dev))

    def tensors(sub):
        return T.tree_map(lambda a: _tensor(a, dev), sub)

    ace, ist = tree["ace"], tree["ace"]["importance"]
    state = {
        "params": params,
        "m": tensors(tree["m"]),
        "v": tensors(tree["v"]),
        "step": _tensor(np.asarray(tree["step"], np.int32), dev),
        "ace": ACEState(
            errors=tensors(ace["errors"]),
            importance=ImportanceState(
                params=tensors(ist["params"]), opt_m=tensors(ist["opt_m"]),
                opt_v=tensors(ist["opt_v"]),
                feat_ema=_tensor(ist["feat_ema"], dev),
                norm_mom=_tensor(ist["norm_mom"], dev),
                step=_tensor(np.asarray(ist["step"], np.int32), dev)),
            struct_feat=_tensor(ace["struct_feat"], dev),
            div_ema=_tensor(np.asarray(ace["div_ema"], np.float32), dev),
            mse_ema=_tensor(np.asarray(ace["mse_ema"], np.float32), dev)),
    }
    if "anchor" in tree:
        state["anchor"] = tensors(tree["anchor"])
    return state


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, device) for v in obj))
    return obj


def move_state(state: dict, trainer) -> dict:
    """A copy of a port train state for ``trainer`` (on its device): the
    params are loaded into its model in place, every other leaf copied."""
    params = trainer.model.param_tree()
    with torch.no_grad():
        for p, q in zip(T.leaves(params), T.leaves(state["params"])):
            p.copy_(q)
    out = {k: _to(v, trainer.device) for k, v in state.items()
           if k != "params"}
    out["params"] = params
    return out
