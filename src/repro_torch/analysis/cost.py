"""What a step computes, moves and holds, counted as it runs — the port's
counterpart of ``repro/analysis/hlo.py``'s ``CostReport``.

The reference reads these off XLA's compiled HLO.  The port has no
compiled program: :class:`Counters` runs a function under three counters
and reads the byte logs of its process groups:

  * ``FlopCounterMode``: the FLOPs of the matrix products and attention,
    by op.  Attention counts by the fused kernels' formula (PyTorch's
    ``sdpa_flop`` / ``sdpa_backward_flop``) on every device: the CPU's
    fused op, which PyTorch's counter does not know, is given that
    formula, and on the meta device attention runs the fused
    (memory-efficient) op (``models.layers._sdpa``), where PyTorch would
    decompose it into its math version — the products and the (S, S)
    scores the card never materialises;
  * a dispatch mode that sums each aten op's input and output bytes (an
    unfused upper bound: a fusing compiler reads and writes less; views
    move none), and the live bytes: each storage an op allocates adds
    its bytes until it is freed (a weak reference to the storage takes
    them off), the peak kept;
  * the dry groups' (or the real groups') byte logs: collective bytes and
    counts by op and tier;

and the kernels' launches (the wrappers' meta records on the meta device,
``kernels.ops.DRY_LAUNCHES``; ``launch_counts()`` on the card).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels import ops

_aten = torch.ops.aten


def _raw(formula):
    """A registered formula (it takes the op's own arguments and makes
    their shapes itself) marked so that the counter does not wrap it
    again."""
    def f(*args, **kwargs):
        return formula(*args, **kwargs)
    f._get_raw = True
    return f


#: the CPU's fused attention, which PyTorch's counter has no formula for:
#: the card's fused kernels' formulas (same arguments first)
CPU_ATTENTION = {
    _aten._scaled_dot_product_flash_attention_for_cpu: _raw(
        flop_registry[_aten._scaled_dot_product_flash_attention]),
    _aten._scaled_dot_product_flash_attention_for_cpu_backward: _raw(
        flop_registry[_aten._scaled_dot_product_flash_attention_backward]),
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Bytes(TorchDispatchMode):
    """Per aten op: the bytes of its tensor inputs and outputs (views
    none); the live bytes of the storages ops allocate, and their peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._alive: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in (_aten.detach.default,
                                    _aten.lift_fresh.default):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._alive:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class CostReport:
    """One traced call's counts (per device: the rank that ran it)."""

    flops: int = 0
    bytes_accessed: int = 0
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    op_flops: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)
    #: the live bytes' peak above what was allocated before the call
    transient_peak: int = 0


def collectives(log: Sequence[dict]) -> tuple:
    """({"op/tier": bytes}, {"op/tier": count}) of a byte log."""
    nbytes, count = defaultdict(int), defaultdict(int)
    for e in log:
        key = f"{e['op']}/{e['tier']}"
        nbytes[key] += int(e["bytes"])
        count[key] += 1
    return dict(nbytes), dict(count)


def kernel_launches(records: Sequence[tuple]) -> Dict[str, dict]:
    """{name: {"launches", "rows", "bytes"}} of ``DRY_LAUNCHES`` records."""
    out: Dict[str, dict] = {}
    for name, rows, nbytes in records:
        k = out.setdefault(name, {"launches": 0, "rows": 0, "bytes": 0})
        k["launches"] += 1
        k["rows"] += rows
        k["bytes"] += nbytes
    return out


class Counters:
    """``with Counters(log) as c: fn()`` counts what ``fn`` runs; then
    ``c.report`` is its :class:`CostReport`.  ``log`` is the byte log of
    the groups the call uses (only entries added inside count)."""

    def __init__(self, log: Optional[List[dict]] = None):
        self.log = log if log is not None else []
        self.report: Optional[CostReport] = None

    def __enter__(self):
        self._log0 = len(self.log)
        self._dry0 = len(ops.DRY_LAUNCHES)
        self._flops = FlopCounterMode(display=False,
                                      custom_mapping=CPU_ATTENTION)
        self._bytes = _Bytes()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        nbytes, count = collectives(self.log[self._log0:])
        self.report = CostReport(
            flops=int(self._flops.get_total_flops()),
            bytes_accessed=int(self._bytes.bytes),
            collective_bytes=nbytes, collective_count=count,
            op_flops={str(k): int(v) for k, v in
                      self._flops.get_flop_counts().get("Global",
                                                        {}).items()},
            kernels=kernel_launches(ops.DRY_LAUNCHES[self._dry0:]),
            transient_peak=int(self._bytes.peak))
        del ops.DRY_LAUNCHES[self._dry0:]
        return False


def tensor_bytes(tree) -> int:
    """The bytes of the tensors of a tree (dicts, lists, tuples, named
    tuples), each storage counted once."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total
