"""Dry groups: the process groups of a layout that no process runs — the
port's stand-in for the reference's 512 fake XLA devices.

A :class:`DryGroup` speaks :class:`~repro_torch.launch.mesh.PodGroup`'s
interface (rank, size, ranks, tier, the byte log, ``all_gather``,
``all_gather_bytes``, ``all_to_all``, ``all_reduce_sum``,
``reduce_scatter``, ``full_exchange``, the ring's hops,
``broadcast_object``, ``split_tiers``) with no transport behind it: every
collective returns an uninitialised tensor of the shape and dtype the
real one returns, on the input's device (the meta device in a dry run),
and logs the bytes a member would receive by the real groups' own rule
(``mesh.received_bytes``, through ``PodGroup``'s own code).  The sums a
real group folds on the host after its transport (the gloo branch's
all-reduce, reduce-scatter and FULL's exchange) are not run: they are
the collective's arithmetic, and there are no values.

:func:`dry_layout` gives rank (0, 0) of pod 0 of P pods of D x M
("data", "model") meshes its place as
:func:`~repro_torch.launch.mesh.split_fleet_mesh` gives it to a process:
the pod's ``ShardCtx`` (its "data", "model" and world groups) and the pod
group of the ranks at its (d, m), all logging into one list.  Nothing
here starts a process or touches a device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import PodGroup
from repro_torch.models.shardctx import ShardCtx

#: the device a dry run's tensors live on
META = torch.device("meta")


class DryGroup(PodGroup):
    """A member of a group of ``size`` with no process behind it: the
    collectives' outputs are uninitialised tensors of the real outputs'
    shapes and dtypes, their bytes logged as a real group logs them."""

    def __init__(self, rank: int, size: int, *, tier: str,
                 ranks: Optional[Sequence[int]] = None,
                 log: Optional[List[dict]] = None):
        super().__init__(rank, size, META, "dry", tier=tier, ranks=ranks,
                         log=log)

    def make_host_groups(self) -> None:
        pass

    # ---- transport: shapes only ------------------------------------------
    def _gather_flat(self, u8: torch.Tensor) -> torch.Tensor:
        return torch.empty((self.size, u8.numel()), dtype=torch.uint8,
                           device=u8.device)

    def _scatter_flat(self, u8: torch.Tensor) -> torch.Tensor:
        return torch.empty((self.size, u8.numel() // self.size),
                           dtype=torch.uint8, device=u8.device)

    def _post_hop(self, fwd, bwd, tag: int):
        return [], [None if b is None else torch.empty(
            (b.numel(),), dtype=torch.uint8, device=b.device)
            for b in (fwd, bwd)]

    # ---- the folds: the collective's arithmetic, no values to fold --------
    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"all_reduce_sum takes float32 or float64, "
                             f"got {x.dtype}")
        self._gather_values(x, "reduce")
        return torch.empty_like(x)

    def reduce_scatter(self, parts: torch.Tensor) -> torch.Tensor:
        if parts.shape[0] != self.size:
            raise ValueError(f"reduce_scatter takes one row per member "
                             f"({self.size}), got {tuple(parts.shape)}")
        self._collective("reduce_scatter",
                         parts.contiguous().reshape(-1).view(torch.uint8),
                         scatter=True)
        return torch.empty(parts.shape[1:], dtype=parts.dtype,
                           device=parts.device)

    def full_exchange(self, contrib: torch.Tensor) -> torch.Tensor:
        if contrib.dtype != torch.bfloat16:
            raise ValueError(f"FULL sums bf16 contributions, got "
                             f"{contrib.dtype}")
        m = -(-contrib.numel() // self.size)
        u8 = torch.empty((m * self.size * 2,), dtype=torch.uint8,
                         device=contrib.device)
        self._collective("full", u8, scatter=True)
        self._collective("full", u8[:2 * m])
        return torch.empty(contrib.shape, dtype=torch.float32,
                           device=contrib.device)

    # ---- tiers and membership ----------------------------------------------
    def _sub_group(self, tier: str, ranks: List[int],
                   rank: Optional[int]) -> Optional["DryGroup"]:
        """:meth:`PodGroup.split_tiers`'s sub-group, dry, on the shared
        log."""
        if rank is None:
            return None
        return DryGroup(rank, len(ranks), tier=tier, ranks=ranks,
                        log=self.log)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s object: this member's own (there is no other)."""
        return obj


def dry_layout(P: int, D: int, M: int, n_edge: int = 1
               ) -> Tuple[ShardCtx, Optional[DryGroup], List[dict]]:
    """Rank (0, 0) of pod 0 on P pods of D x M meshes, dry: (its pod's
    ``ShardCtx`` on the meta device, with dry "data" / "model" / world
    groups — the world's tier "fleet", as ``split_mesh`` names it — the
    dry pod group of the P ranks at (0, 0), tier "pod", None where P = 1,
    and the byte log they share).  ``n_edge`` > 1 splits the pod group
    into its ``intra`` / ``cross`` tiers."""
    log: List[dict] = []
    n = D * M
    ctx = ShardCtx(D, M, 0, 0,
                   data=DryGroup(0, D, tier="data", log=log,
                                 ranks=[i * M for i in range(D)]),
                   model=DryGroup(0, M, tier="model", log=log),
                   world=DryGroup(0, n, tier="fleet", log=log),
                   device=META)
    pods = None
    if P > 1:
        pods = DryGroup(0, P, tier="pod", log=log,
                        ranks=[q * n for q in range(P)])
        pods.split_tiers(n_edge)
    return ctx, pods, log
