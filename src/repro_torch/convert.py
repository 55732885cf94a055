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

(the paths :func:`repro_torch.tree.reference_leaf_paths` gives a port
state, in the same order), and returns the port's train state: the
model's Parameters are loaded in place by :func:`params_from_reference`
(they stay the ``params`` leaves; a serving model loads the reference's
bare parameter tree through it), every other leaf becomes a tensor on
the trainer's device (:func:`shard_params` first cuts a serving model's
parameters to its rank's shards on a ("data", "model") mesh).  On a mesh
rank every parameter-shaped tree — params, m, v, the error buffers and
the anchor — is cut to the rank's shards (``model.shard_index``), the
rest (step, importance state) taken whole.  The inverse,
:func:`reference_from_shards`, assembles every rank's shards
(:func:`rank_shards`, host copies that cross a process boundary) back
into the reference's whole leaves.
:func:`pod_state_from_reference` takes the
reference's multi-pod state as it is, every leaf with its leading pod
dimension, and returns pod ``pod``'s state (one per pod process; on a
fleet of meshes each rank of pod ``pod`` takes its shards of that row).
On a hierarchical fleet that dimension is the reference's pod-major fleet
("pod", "edge"), and ``pod`` is the fleet slot c * n_edge + e (on a
two-tier fleet of meshes too: :func:`reference_from_shards` with each
rank's fleet slot assembles the C * E rows).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.acesync import ACEState
from repro_torch.core.importance import ImportanceState
from repro_torch.core.trainer import param_path


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(flat: Dict[str, np.ndarray], model) -> dict:
    """Load the reference's parameters, keyed by path
    (``blocks/slot1/attn/q_norm``, ``embed``, ...), into ``model``'s
    Parameters in place (each in the Parameter's dtype); returns the
    model's parameter tree.  The paths must be the model's."""
    params = model.param_tree()
    paths = {T.path_str(p) for p, _ in T.leaves_with_path(params)}
    if set(flat) != paths:
        raise ValueError(f"reference params {sorted(set(flat) - paths)} "
                         f"not in the model; model params "
                         f"{sorted(paths - set(flat))} not given")
    with torch.no_grad():
        for path, p in T.leaves_with_path(params):
            src = flat[T.path_str(path)]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{T.path_str(path)}: shape "
                                 f"{src.shape} != {tuple(p.shape)}")
            p.copy_(_tensor(src, p.device))
    return params


def shard_params(flat: Dict[str, np.ndarray], model) -> dict:
    """The reference's parameters (keyed by path, as
    :func:`params_from_reference` takes them) cut to the shards ``model``
    holds on its rank of a ("data", "model") mesh
    (``model.shard_index``); a model without a mesh takes them whole.
    Feed the result to :func:`params_from_reference`."""
    if getattr(model, "ctx", None) is None:
        return dict(flat)
    return {k: np.asarray(a)[model.shard_index(k)] for k, a in flat.items()}


def state_from_reference(flat: Dict[str, np.ndarray], trainer) -> dict:
    """The port's train state from the reference's (see module doc)."""
    dev = trainer.device
    model = trainer.model
    if getattr(model, "ctx", None) is not None:
        flat = {k: a if param_path(k) is None
                else np.asarray(a)[model.shard_index(param_path(k))]
                for k, a in flat.items()}
    tree = T.from_flat_dict(flat)
    params = params_from_reference(
        {k[len("params/"):]: a for k, a in flat.items()
         if k.startswith("params/")}, trainer.model)

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


def rank_shards(state, trainer) -> Dict[str, tuple]:
    """This rank's train state for :func:`reference_from_shards`: {path
    (as :func:`state_from_reference` takes it): (host copy of the leaf,
    its index into the global leaf, the global shape)}, as the trainer's
    checkpoint layout places it (``Trainer.state_layout``)."""
    return {T.path_str(p): (x.detach().to("cpu", copy=True).numpy(),
                            sh.index, sh.shape)
            for (p, x), sh in zip(T.reference_leaves_with_path(state),
                                  trainer.state_layout(state))}


def reference_from_shards(ranks: Sequence[Dict[str, tuple]],
                          pods: Optional[Sequence[int]] = None
                          ) -> Dict[str, np.ndarray]:
    """The reference's whole train state, keyed by path with no pod
    dimension (as :func:`state_from_reference` takes it), assembled from
    every rank's :func:`rank_shards`.  Every entry of a leaf must be held
    by some rank, and ranks holding the same entry must hold the same
    bits: ``ValueError`` naming the leaf otherwise.  With ``pods`` (each
    rank's pod, on a fleet of meshes) the reference's stacked multi-pod
    state: every leaf with its leading (P, ...) pod dimension, row p
    assembled from pod p's ranks (:func:`pod_state_from_reference`
    carries row p back into them)."""
    if pods is not None:
        rows = [reference_from_shards([r for r, q in zip(ranks, pods)
                                       if q == p])
                for p in range(max(pods) + 1)]
        return {k: np.stack([row[k] for row in rows]) for k in rows[0]}
    out = {}
    for key, (first, _, shape) in ranks[0].items():
        whole = np.empty(shape, first.dtype)
        held = np.zeros(shape, bool)
        bits = f"u{first.dtype.itemsize}"
        regions = {}
        for r in ranks:
            part, index, _ = r[key]
            # what an earlier rank holds of this region (where it holds
            # some of it), this rank's entries elsewhere
            prev = regions.get(repr(index))
            seen = np.asarray(held[index])
            if prev is None and seen.any():
                prev = np.where(seen, np.asarray(whole[index]), part)
            if prev is not None and not np.array_equal(
                    np.asarray(prev).view(bits), part.view(bits)):
                raise ValueError(f"{key}: ranks hold different bits of one "
                                 f"shard")
            if repr(index) not in regions:
                whole[index] = part
                held[index] = True
                regions[repr(index)] = part
        if not held.all():
            raise ValueError(f"{key}: no rank holds {int((~held).sum())} "
                             f"of its {held.size} entries")
        out[key] = whole
    return out


def pod_state_from_reference(flat: Dict[str, np.ndarray], trainer,
                             pod: int) -> dict:
    """Pod ``pod``'s port state from the reference's multi-pod state
    (leaves keyed as above, each with its leading pod — or pod-major
    fleet — dimension; ``pod`` is the fleet slot)."""
    n = {np.shape(a)[0] for a in flat.values()}
    if len(n) != 1 or not 0 <= pod < n.pop():
        raise ValueError(f"expected leaves with one leading pod dimension "
                         f"covering pod {pod}")
    return state_from_reference({k: np.asarray(a)[pod]
                                 for k, a in flat.items()}, trainer)


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
