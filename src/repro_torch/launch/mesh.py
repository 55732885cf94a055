"""The pod group: one process per pod over ``torch.distributed`` — the
port's counterpart of ``repro/launch/mesh.py``'s ``make_mesh``.

The reference runs P pods as one SPMD program over a ("pod", "data",
"model") mesh — or a ("pod", "edge", ...) mesh for the two-tier
hierarchy — and names the mesh axes in its collectives.  The port runs
one process per fleet member ("data" and "model" are 1) and hands every
collective a :class:`PodGroup`:

  * ``all_gather_bytes(u8) -> (P, nbytes)`` — the one-shot payload
    exchange, pod-major like the reference's ``all_gather``;
  * ``all_reduce_sum`` / ``pmean`` of small f32 tensors (grad stats,
    divergence projections, the parameter average), summed in pod order
    so that every pod gets the same bits;
  * ``reduce_scatter`` — each member's row for every member summed over
    the members, each keeping its own (NCCL's reduce-scatter; under gloo
    an ``all_to_all`` and the sum in f32 in rank order, the bits of
    ``all_reduce_sum``'s row): the backward of an FSDP gather;
  * ``full_exchange`` — FULL's cross-pod sum of bf16 contributions as a
    reduce-scatter and an all-gather: each pod sums, in f32 and in pod
    order, the shard of the vector it owns, rounds it to bf16 once, and
    the shards are gathered back — bf16(sum of f32(contrib)), as the
    reference's psum gives it on XLA:CPU, identical on every pod, at the
    bytes a bf16 ring all-reduce moves (``FullCodec.wire_bytes``);
  * ``ring_stage`` / ``ring_hop`` / ``ring_to_device`` — the point-to-point
    hops of the chunked ring (the reference's ``ppermute``): one hop of a
    chunk goes to pod (rank + 1) % P and comes from (rank - 1) % P
    (forward), or the other way round (backward), both directions in
    flight together;
  * a log of the bytes each collective received per pod (``log``), so a
    run can hold the exchange to the analytic ``plan_wire_bytes``;
  * elastic membership (:meth:`PodGroup.regroup`): the group of the alive
    pods, created by every process of the fleet in one order (a new
    ``torch.distributed`` group is collective over the whole fleet, so a
    preempted pod's process takes part), cached per membership; and the
    host-side exchanges of the control loop over gloo: the pods' step
    times (:meth:`PodGroup.gather_floats`), a small object from one pod
    (:meth:`PodGroup.broadcast_object`) and one pod's state to a
    rejoining pod (:meth:`PodGroup.send_state`).

Every group carries two gloo groups of its members besides its own:
``host_pg`` for the control loop's host exchanges (the group itself where
it is gloo) and ``ckpt_pg``, used only by the checkpoint writer's
background thread (gloo matches collectives by order, so no other thread
may run them on that group).

A hierarchical fleet of C clusters x E members (``n_edge`` = E > 1) is
one world group of C*E ranks, slot ``r = c*E + e`` pod-major as the
reference's ``pod * n_edge + edge``.  Its :class:`PodGroup` (tier
"fleet") carries two sub-groups, each a :class:`PodGroup` of its own with
rank and size local to it (the reference's mesh axes): ``intra``, the E
members of its cluster (``EDGE_AXIS``), and ``cross``, the C members with
its edge index (``POD_AXIS``).  The three share one byte log, each entry
naming its tier.

The backend follows from the layout, before any collective runs: NCCL
when every pod has a card of its own; gloo when pods share a card or run
on the CPU.  NCCL refuses two ranks on one device, so pods that share a
card stage each CUDA collective through pinned host memory: one copy to
the host, a stream synchronisation, the gloo collective, one copy back.
The ring stages its own chunks once per exchange and forwards what it
received from host memory as it is.

:func:`spawn_pods` starts the P pod processes and gathers their results.
They fork from a ``forkserver`` that has imported torch and the port's
modules once (``PRELOAD``) and never touches the card: a process starts
in a fraction of a second instead of importing everything again, and
initialises CUDA itself.  The environment of the call is handed to each
process explicitly (the server's is the one it was started with).

Within a pod, the reference's ("data", "model") mesh of D x M devices is
D * M ranks, one process each (:func:`spawn_mesh`), rank d * M + m at
(d, m) as ``make_mesh((D, M), ("data", "model"))`` orders its devices;
:func:`split_mesh` gives each rank its ``ShardCtx``
(``models/shardctx.py``): the "data" and "model" sub-groups, every rank
creating every group in one order.  The backend follows from the layout
as for pods: NCCL with a card per rank, gloo staged through pinned host
memory when ranks share a card or run on the CPU.

A fleet of P pods, each a D x M mesh (the reference's ("pod", "data",
"model") mesh), is P * D * M ranks, one process each
(:func:`spawn_fleet_mesh`), world rank p * D * M + d * M + m as
``make_mesh((P, D, M), ("pod", "data", "model"))`` orders its devices.
:func:`split_fleet_mesh` gives each rank its pod's ``ShardCtx`` (the
"data" and "model" groups of the pod's D * M ranks) and a
:class:`PodGroup` of tier "pod": the P ranks at its (d, m), which the
sync round exchanges over (the reference's collectives over "pod" in its
manual region), sharing one byte log with the mesh groups.  Every rank
creates every group in one order.  A membership change regroups each
(d, m)'s pod group to the alive pods, every (d, m) alike
(:meth:`PodGroup.regroup` over its ``siblings``).

A two-tier fleet of such meshes (the reference's ("pod", "edge", "data",
"model") mesh: C clusters x E members, each member a D x M mesh) is the
same fleet of P = C * E pods, pod p = c * E + e, world rank
p * D * M + d * M + m as ``make_mesh((C, E, D, M), ("pod", "edge",
"data", "model"))`` orders its devices: ``split_fleet_mesh(...,
n_edge=E)`` splits each (d, m)'s pod group into its ``intra`` and
``cross`` sub-groups of global ranks (:meth:`PodGroup.split_tiers`), the
reference's collectives over "edge" and "pod" at that (d, m).  Every rank
creates the tier groups of every (d, m), in one order.  Its membership is
fixed (the reference's two-tier fleet has no elastic membership).
"""
from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import ftz
from repro_torch.models.shardctx import ShardCtx

#: wait for a peer this long before a collective gives up
TIMEOUT_S = 900
#: what the processes' start server imports once, for every process it
#: forks: torch and the port's modules a pod or a mesh rank runs (none
#: of them touches the card on import)
PRELOAD = ("numpy", "torch", "torch.distributed", "repro_torch.convert",
           "repro_torch.checkpoint.checkpointer", "repro_torch.core.trainer",
           "repro_torch.launch.serve", "repro_torch.launch.session",
           "repro_torch.launch.train", "repro_torch.models.registry")


def backend_for(n_pods: int, device_type: str) -> str:
    """'nccl' when every pod gets a card of its own, else 'gloo'."""
    if device_type == "cuda" and n_pods <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def pod_device(rank: int, n_pods: int, device_type: str) -> torch.device:
    """The device pod ``rank`` runs on: its own card where there are
    enough, else the cards round-robin (one card: all pods share it)."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


class PodGroup:
    """One pod's handle on a pod group (rank, size, device, collectives
    and the byte log).  ``pg`` is the ``torch.distributed`` group (None:
    the world), ``ranks`` the global rank of each member, ``tier`` the
    name its log entries carry; ``log`` may be shared with other groups
    of the same process.  On a hierarchical fleet :meth:`split_tiers`
    adds the ``intra`` and ``cross`` sub-groups."""

    def __init__(self, rank: int, size: int, device, backend: str, *,
                 tier: str = "fleet", pg=None,
                 ranks: Optional[Sequence[int]] = None,
                 log: Optional[List[dict]] = None):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.tier = tier
        self.pg = pg
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        #: staged through host memory: CUDA tensors under gloo
        self.staged = backend == "gloo" and self.device.type == "cuda"
        #: one entry per collective: op, tier, bytes received per pod, host
        #: seconds in the call, and of those the seconds spent waiting for
        #: the card before a staged copy
        self.log: List[dict] = [] if log is None else log
        self._sync_s = 0.0
        #: members per cluster, and the tier sub-groups (hierarchical
        #: fleets only)
        self.n_edge = 1
        self.intra: Optional["PodGroup"] = None
        self.cross: Optional["PodGroup"] = None
        #: gloo groups of the same members: the control loop's host
        #: exchanges, and the checkpoint writer's thread
        self.host_pg = pg if backend == "gloo" else None
        self.ckpt_pg = None
        #: sub-groups by membership (:meth:`regroup`), None where this pod
        #: is not a member
        self._members: dict = {}
        #: the offsets of the global ranks of the groups parallel to this
        #: one, this one's (0) among them, in the order every process
        #: creates them: on a fleet of meshes, the pod groups of every
        #: (d, m); :meth:`regroup` regroups them all alike
        self.siblings: tuple = (0,)

    @property
    def n_cross(self) -> int:
        return self.size // self.n_edge

    def make_host_groups(self) -> None:
        """Create this group's gloo ``host_pg`` (where it is not gloo
        itself) and ``ckpt_pg``; every process of the fleet calls this in
        the same order."""
        if self.backend != "gloo":
            self.host_pg = dist.new_group(self.ranks, backend="gloo")
        self.ckpt_pg = dist.new_group(self.ranks, backend="gloo")

    def regroup(self, members: Sequence[int]) -> Optional["PodGroup"]:
        """The group of fleet ranks ``members`` (global ranks, among this
        group's own), or None where this pod is not a member.  Called on
        the fleet's group by every process of the fleet, in the same
        order, member or not; the groups are cached per membership, so a
        fleet that returns to a membership reuses them.  The rank of a pod
        in the new group is its index in the sorted members.  The groups
        parallel to this one (``siblings``) are regrouped alike, in one
        order, so that every process creates every group."""
        members = sorted(int(m) for m in members)
        if members == self.ranks:
            return self
        key = tuple(members)
        if key not in self._members:
            me = self.ranks[self.rank]
            for off in self.siblings:
                ranks = [m + off for m in members]
                pg = dist.new_group(ranks)
                sub = PodGroup(ranks.index(me) if me in ranks else 0,
                               len(ranks), self.device, self.backend,
                               tier=self.tier, pg=pg, ranks=ranks,
                               log=self.log)
                sub.make_host_groups()
                if off == 0:
                    sub.siblings = self.siblings
                    self._members[key] = sub if me in members else None
        return self._members[key]

    def split_tiers(self, n_edge: int) -> None:
        """Make this fleet of C = size / n_edge clusters hierarchical: the
        ``intra`` group of the E members of its cluster (members c*E ..
        c*E+E-1) and the ``cross`` group of the C members with its edge
        index (members e, E+e, ...), made of the members' global ranks
        (``ranks``).  Every process creates every sub-group, in the same
        order, including the groups it is not in: those of this group and
        of each group parallel to it (``siblings``, on a fleet of meshes
        the fleet groups of every (d, m)), sibling by sibling."""
        E = int(n_edge)
        if E < 1 or self.size % E:
            raise ValueError(f"{self.size} fleet members do not split into "
                             f"clusters of {E}")
        self.n_edge = E
        if E == 1:
            return
        C = self.size // E
        layouts = ([("intra", [c * E + e for e in range(E)])
                    for c in range(C)]
                   + [("cross", [c * E + e for c in range(C)])
                      for e in range(E)])
        for off in self.siblings:
            for tier, members in layouts:
                ranks = [self.ranks[i] + off for i in members]
                pg = dist.new_group(ranks)
                if off == 0 and self.rank in members:
                    setattr(self, tier, PodGroup(
                        members.index(self.rank), len(ranks), self.device,
                        self.backend, tier=tier, pg=pg, ranks=ranks,
                        log=self.log))

    # ---- transport -------------------------------------------------------
    def _stage(self, u8: torch.Tensor) -> torch.Tensor:
        """What the transport reads: a pinned host copy after a stream
        synchronisation when staged, else ``u8`` itself."""
        if not self.staged:
            return u8
        src = torch.empty((u8.numel(),), dtype=torch.uint8, pin_memory=True)
        src.copy_(u8, non_blocking=True)
        t0 = time.perf_counter()
        # the gloo call reads the host copy: it must have landed (the wait
        # also covers the device work queued before the copy)
        torch.cuda.current_stream(u8.device).synchronize()
        self._sync_s += time.perf_counter() - t0
        return src

    def _gather_flat(self, u8: torch.Tensor) -> torch.Tensor:
        """(nbytes,) uint8 on this pod -> (P, nbytes) on its device."""
        P, n = self.size, u8.numel()
        if self.backend == "nccl":
            out = torch.empty((P, n), dtype=torch.uint8, device=u8.device)
            dist.all_gather_into_tensor(out.view(-1), u8, group=self.pg)
            return out
        src = self._stage(u8)
        out = torch.empty((P, n), dtype=torch.uint8, pin_memory=self.staged)
        dist.all_gather(list(out.unbind(0)), src, group=self.pg)
        return out.to(u8.device, non_blocking=True) if self.staged else out

    def _scatter_flat(self, u8: torch.Tensor) -> torch.Tensor:
        """(P * k,) uint8 on this pod, piece q for pod q -> (P, k) on its
        device, row p the piece pod p sent here (``all_to_all``)."""
        P = self.size
        if self.backend == "nccl":
            out = torch.empty_like(u8)
            dist.all_to_all_single(out, u8, group=self.pg)
            return out.view(P, -1)
        src = self._stage(u8)
        out = torch.empty((u8.numel(),), dtype=torch.uint8,
                          pin_memory=self.staged)
        dist.all_to_all_single(out, src, group=self.pg)
        out = out.to(u8.device, non_blocking=True) if self.staged else out
        return out.view(P, -1)

    def _collective(self, op: str, u8: torch.Tensor,
                    scatter: bool = False) -> torch.Tensor:
        self._sync_s = 0.0
        t0 = time.perf_counter()
        u8 = u8.contiguous().view(-1)
        if scatter:
            out = self._scatter_flat(u8)
            got = (self.size - 1) * (u8.numel() // self.size)
        else:
            out = self._gather_flat(u8)
            got = (self.size - 1) * u8.numel()
        self.log.append({"op": op, "tier": self.tier, "bytes": got,
                         "seconds": time.perf_counter() - t0,
                         "sync_seconds": self._sync_s})
        return out

    # ---- collectives -----------------------------------------------------
    def all_gather_bytes(self, u8: torch.Tensor) -> torch.Tensor:
        """The one-shot payload exchange: every pod's (nbytes,) uint8 wire
        -> (P, nbytes), row p from pod p."""
        if u8.dtype != torch.uint8 or u8.dim() != 1:
            raise ValueError(f"expected a 1-D uint8 wire, got {u8.dtype} "
                             f"{tuple(u8.shape)}")
        return self._collective("gather", u8)

    def _gather_values(self, x: torch.Tensor, op: str) -> torch.Tensor:
        flat = x.contiguous().reshape(-1)
        got = self._collective(op, flat.view(torch.uint8))
        return got.view(x.dtype).reshape((self.size,) + tuple(x.shape))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every pod's ``x`` (one shape and dtype on all) -> (P,
        *x.shape), row p from pod p."""
        return self._gather_values(x, "gather")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (P, ...), row q for pod q -> (P, ...), row p the row pod
        p sent here."""
        flat = x.contiguous().reshape(-1)
        got = self._collective("a2a", flat.view(torch.uint8), scatter=True)
        return got.view(x.dtype).reshape(x.shape)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a small f32 (or f64) tensor over the pods, in pod order
        0..P-1 (the same bits on every pod)."""
        if x.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"all_reduce_sum takes float32 or float64, "
                             f"got {x.dtype}")
        parts = self._gather_values(x, "reduce")
        out = parts[0]
        for p in range(1, self.size):
            out = ftz(out + parts[p])
        return out

    def reduce_scatter(self, parts: torch.Tensor) -> torch.Tensor:
        """``parts`` (P, ...), row q for member q -> the sum over the
        members of the rows they hold for this one (...), in ``parts``'s
        dtype.  NCCL reduces in that dtype; gloo moves the rows with one
        ``all_to_all`` and sums them in f32 (f64 for f64) in rank order
        0..P-1, the bits of :meth:`all_reduce_sum`'s row.  Logged as op
        "reduce_scatter", (P - 1) rows received."""
        P = self.size
        if parts.shape[0] != P:
            raise ValueError(f"reduce_scatter takes one row per member "
                             f"({P}), got {tuple(parts.shape)}")
        if self.backend == "nccl":
            t0 = time.perf_counter()
            out = torch.empty(parts.shape[1:], dtype=parts.dtype,
                              device=parts.device)
            dist.reduce_scatter_tensor(out, parts.contiguous(),
                                       group=self.pg)
            self.log.append({"op": "reduce_scatter", "tier": self.tier,
                             "bytes": (P - 1) * out.numel()
                             * out.element_size(),
                             "seconds": time.perf_counter() - t0,
                             "sync_seconds": 0.0})
            return out
        flat = parts.contiguous().reshape(-1)
        got = self._collective("reduce_scatter", flat.view(torch.uint8),
                               scatter=True)
        rows = got.view(parts.dtype).reshape(parts.shape)
        acc = torch.promote_types(parts.dtype, torch.float32)
        out = rows[0].to(acc)
        for p in range(1, P):
            out = ftz(out + rows[p].to(acc))
        return out.to(parts.dtype)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the pods: the pod-order sum times 1/P in f32 (XLA
        turns the reference's division by the pod count into this
        product)."""
        return ftz(self.all_reduce_sum(x) * float(
            torch.tensor(1.0 / self.size, dtype=torch.float32)))

    def full_exchange(self, contrib: torch.Tensor) -> torch.Tensor:
        """FULL's cross-pod sum: bf16 contributions -> f32 aggregate,
        bf16(sum over pods, in pod order, of f32(contrib)).

        A reduce-scatter, then an all-gather, both logged as op "full":
        the n entries, padded to P shards of m = ceil(n / P), go shard q to
        pod q (``all_to_all``); each pod sums the P copies of its shard in
        f32 in pod order and rounds once to bf16; one ``all_gather`` of the
        bf16 shards returns the whole vector.  Each pod receives
        4 (P-1) m bytes: ``FullCodec.wire_bytes`` (2 (P-1)/P 2n) plus less
        than 4 (P-1) bytes of shard padding, none where P divides n."""
        if contrib.dtype != torch.bfloat16:
            raise ValueError(f"FULL sums bf16 contributions, got "
                             f"{contrib.dtype}")
        P = self.size
        flat = contrib.contiguous().reshape(-1)
        n = flat.numel()
        m = -(-n // P)
        if m * P != n:
            flat = torch.cat([flat, flat.new_zeros(m * P - n)])
        parts = self._collective("full", flat.view(torch.uint8),
                                 scatter=True).view(torch.bfloat16)
        acc = parts[0].float()
        for p in range(1, P):
            acc = ftz(acc + parts[p].float())
        shard = acc.to(torch.bfloat16)
        whole = self._collective("full", shard.view(torch.uint8))
        out = whole.view(torch.bfloat16).reshape(-1)[:n]
        return out.float().reshape(contrib.shape)

    # ---- the ring's point-to-point hops ---------------------------------
    def ring_stage(self, wires: List[torch.Tensor]) -> List[torch.Tensor]:
        """The own chunk wires (1-D uint8) as the transport sends them:
        pinned host copies after one stream synchronisation when staged,
        else the wires themselves."""
        if not self.staged:
            return [w.contiguous() for w in wires]
        host = []
        for w in wires:
            h = torch.empty((w.numel(),), dtype=torch.uint8, pin_memory=True)
            h.copy_(w, non_blocking=True)
            host.append(h)
        t0 = time.perf_counter()
        # gloo reads the host copies: they must have landed
        torch.cuda.current_stream(self.device).synchronize()
        self._sync_s += time.perf_counter() - t0
        return host

    def ring_hop(self, fwd: Optional[torch.Tensor],
                 bwd: Optional[torch.Tensor], tag: int) -> "RingHop":
        """Post one hop of a ring chunk: ``fwd`` goes to pod (rank + 1) % P
        while a buffer of its size comes from (rank - 1) % P, ``bwd`` the
        other way round; None posts nothing in that direction.  Peers are
        local to the group and sent to by their global rank.  ``tag`` names
        the (hop, chunk) on every pod alike, so that messages cannot
        cross.  Buffers are the transport's (:meth:`ring_stage`, or what
        an earlier hop received).  Returns the hop's handle; its log entry
        (op "ring") counts the bytes received."""
        P, r = self.size, self.rank
        t0 = time.perf_counter()
        works, recvs, ops = [], [], []
        for d, buf in ((1, fwd), (-1, bwd)):
            if buf is None:
                recvs.append(None)
                continue
            dst, src = self.ranks[(r + d) % P], self.ranks[(r - d) % P]
            t = 2 * tag + (d < 0)
            out = torch.empty((buf.numel(),), dtype=torch.uint8,
                              device=buf.device, pin_memory=self.staged)
            recvs.append(out)
            if self.backend == "nccl":
                ops += [dist.P2POp(dist.isend, buf, dst, self.pg, t),
                        dist.P2POp(dist.irecv, out, src, self.pg, t)]
            else:
                works.append(dist.irecv(out, src, group=self.pg, tag=t))
                works.append(dist.isend(buf, dst, group=self.pg, tag=t))
        if ops:
            works = dist.batch_isend_irecv(ops)
        entry = {"op": "ring", "tier": self.tier,
                 "bytes": sum(x.numel() for x in recvs if x is not None),
                 "seconds": time.perf_counter() - t0,
                 "sync_seconds": self._sync_s}
        self._sync_s = 0.0
        self.log.append(entry)
        return RingHop(entry, works, recvs[0], recvs[1])

    def ring_to_device(self, buf: torch.Tensor) -> torch.Tensor:
        """A received buffer on this pod's device (a non-blocking copy out
        of pinned memory when staged)."""
        return buf.to(self.device, non_blocking=True) if self.staged else buf

    # ---- host exchanges of the control loop (gloo, host_pg) -------------
    def gather_floats(self, values: Sequence[float]) -> List[List[float]]:
        """Every pod's ``values`` (the same count on each), in rank
        order."""
        x = torch.tensor(list(values), dtype=torch.float64)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.host_pg)
        return [o.tolist() for o in out]

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every pod."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=self.ranks[src],
                                   group=self.host_pg)
        return box[0]

    def send_state(self, tensors: Sequence[torch.Tensor], src: int,
                   dsts: Sequence[int]) -> None:
        """Rank ``src``'s ``tensors`` into the same-shape ``tensors`` of
        each rank in ``dsts`` (in place), one host copy at a time over
        ``host_pg``; other ranks pass through."""
        if self.rank != src and self.rank not in dsts:
            return
        with torch.no_grad():
            for t in tensors:
                if self.rank == src:
                    host = t.detach().to("cpu", copy=True).contiguous()
                    for d in dsts:
                        dist.send(host, dst=self.ranks[d],
                                  group=self.host_pg)
                else:
                    host = torch.empty(t.shape, dtype=t.dtype)
                    dist.recv(host, src=self.ranks[src], group=self.host_pg)
                    t.copy_(host)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.pg, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.pg)

    # ---- the byte log ----------------------------------------------------
    def bytes_logged(self, op=None, tier=None) -> int:
        """Bytes received in the log's entries of op(s) ``op`` and tier(s)
        ``tier`` (a name or a tuple of names; None: all)."""
        def hit(val, want):
            return want is None or val == want or (
                isinstance(want, tuple) and val in want)
        return sum(e["bytes"] for e in self.log
                   if hit(e["op"], op) and hit(e["tier"], tier))


class RingHop:
    """A posted ring hop: :meth:`wait` returns ``(recv_fwd, recv_bwd)``
    (None where nothing was posted) once both directions have landed, and
    adds the wait to the hop's log entry."""

    def __init__(self, entry: dict, works, recv_f, recv_b):
        self.entry = entry
        self.works = works
        self.recv = (recv_f, recv_b)

    def wait(self):
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.works = []
        self.entry["seconds"] += time.perf_counter() - t0
        return self.recv


# ---------------------------------------------------------------------------
# one process per pod
# ---------------------------------------------------------------------------


def free_tcp_address() -> str:
    """A ``tcp://localhost:<port>`` rendezvous address on a free port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _pod_main(rank, n_pods, n_edge, device_type, init_method, threads, fn,
              args, results, env):
    """Body of one pod process: take the caller's environment ``env``,
    join the group, run ``fn``, report."""
    try:
        os.environ.clear()
        os.environ.update(env)
        if threads:
            torch.set_num_threads(threads)
        dev = pod_device(rank, n_pods, device_type)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = backend_for(n_pods, device_type)
        kw = {}
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=n_pods,
            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
        try:
            group = PodGroup(rank, n_pods, dev, backend)
            group.make_host_groups()
            group.split_tiers(n_edge)
            results.put((rank, True, fn(group, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_pods(fn: Callable, n_pods: int, device="cuda", args=(), *,
               n_edge: int = 1, init_method: Optional[str] = None,
               threads: int = 0, timeout: float = 3600.0) -> list:
    """Run ``fn(group, *args)`` in ``n_pods`` fresh processes, one per pod,
    and return their results in rank order.  ``n_edge`` > 1 makes the
    pods a hierarchical fleet of ``n_pods / n_edge`` clusters (the
    group's ``intra`` / ``cross`` sub-groups, :meth:`PodGroup.split_tiers`).  ``fn`` and its arguments and
    results must pickle (``fn`` by import path).  Rendezvous is
    ``init_method`` (default: a free ``tcp://localhost`` port).  The
    processes fork from the ``forkserver`` (``PRELOAD``) with this
    process's environment as it is now (``threads``: ``OMP_NUM_THREADS``
    too).  Raises if a pod fails or the run outlasts ``timeout`` seconds;
    every process is stopped before this returns."""
    import multiprocessing as mp
    import queue as queue_mod

    device_type = torch.device(device).type
    if n_edge < 1 or n_pods % n_edge:
        raise ValueError(f"{n_pods} pods do not split into clusters of "
                         f"{n_edge}")
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    results = ctx.Queue()
    init_method = init_method or free_tcp_address()
    env = dict(os.environ)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    try:
        for r in range(n_pods):
            p = ctx.Process(target=_pod_main,
                            args=(r, n_pods, n_edge, device_type,
                                  init_method, threads, fn, args, results,
                                  env))
            p.start()
            procs.append(p)
        out, errors = {}, []
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < n_pods:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"pods did not finish in {timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and len(out) + len(errors) < n_pods:
                    # a pod died without reporting (killed, segfault)
                    raise RuntimeError(
                        f"pod process exited with code {dead[0].exitcode}")
                continue
            if ok:
                out[rank] = val
            else:
                errors.append((rank, val))
                break
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"pod {rank} failed:\n{tb}")
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(n_pods)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)


def stop_start_server() -> None:
    """Stop the ``forkserver`` and the resource tracker that
    :func:`spawn_pods` started in this process (they end with it
    otherwise, a moment after it exits); a later spawn starts them
    again.  multiprocessing has no public call for this: the private
    ``_stop`` of each is the one its own tests use."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


# ---------------------------------------------------------------------------
# the within-pod ("data", "model") mesh
# ---------------------------------------------------------------------------


def _mesh_axes(D: int, M: int) -> list:
    """(axis, mesh ranks) of every "data" group (the ranks with one m)
    and "model" group (the ranks with one d) of a D x M mesh, in the
    order every rank creates them."""
    return ([("data", [d * M + m for d in range(D)]) for m in range(M)]
            + [("model", [d * M + m for m in range(M)]) for d in range(D)])


def split_mesh(group: PodGroup, D: int, M: int) -> ShardCtx:
    """This rank's :class:`ShardCtx` on the D x M mesh of ``group``'s
    ranks (its rank d * M + m): its "data" group and "model" group.
    Every rank creates every sub-group, in one order, those it is not in
    too; where ``group`` is not the world (:func:`sub_mesh`) the
    processes outside it create them as well."""
    if D < 1 or M < 1 or group.size != D * M:
        raise ValueError(f"a ({D}, {M}) mesh needs {D * M} ranks, the "
                         f"group has {group.size}")
    axes = {}
    for axis, ranks in _mesh_axes(D, M):
        members = [group.ranks[r] for r in ranks]
        pg = dist.new_group(members)
        if group.rank in ranks:
            axes[axis] = PodGroup(ranks.index(group.rank), len(ranks),
                                  group.device, group.backend, tier=axis,
                                  pg=pg, ranks=members, log=group.log)
    return ShardCtx(D, M, group.rank // M, group.rank % M, data=axes["data"],
                    model=axes["model"], world=group, device=group.device)


def sub_mesh(fleet: PodGroup, members: Sequence[int], D: int,
             M: int) -> Optional[ShardCtx]:
    """The :class:`ShardCtx` of a D x M mesh of the fleet's ranks
    ``members`` (mesh rank i the i-th of them, sorted), None where this
    process is not a member.  Every process of the fleet calls this, in
    one order (the groups are created by every process)."""
    sub = fleet.regroup(members)
    if sub is not None:
        return split_mesh(sub, D, M)
    ranks = sorted(int(m) for m in members)
    if len(ranks) != D * M:
        raise ValueError(f"a ({D}, {M}) mesh needs {D * M} ranks, not "
                         f"{len(ranks)}")
    for _, mesh_ranks in _mesh_axes(D, M):
        dist.new_group([ranks[r] for r in mesh_ranks])
    return None


def _mesh_main(group, D, M, fn, *args):
    return fn(split_mesh(group, D, M), *args)


def spawn_mesh(fn: Callable, D: int, M: int, device="cuda", args=(),
               **kw) -> list:
    """Run ``fn(ctx, *args)`` on a D x M ("data", "model") mesh: D * M
    fresh processes (:func:`spawn_pods`, whose keywords ``kw`` takes),
    each with its :class:`ShardCtx`; returns their results in rank
    order."""
    return spawn_pods(_mesh_main, D * M, device, args=(D, M, fn) + tuple(args),
                      **kw)


# ---------------------------------------------------------------------------
# pods x ("data", "model"): a fleet of meshes
# ---------------------------------------------------------------------------


def split_fleet_mesh(world: PodGroup, P: int, D: int, M: int,
                     n_edge: int = 1) -> Tuple[ShardCtx, PodGroup]:
    """This rank's place on P pods of D x M meshes (``world`` the group of
    all P * D * M ranks, rank p * D * M + d * M + m): its pod's
    :class:`ShardCtx` and the :class:`PodGroup` (tier "pod") of the P
    ranks at its (d, m), with its gloo ``host_pg`` and ``ckpt_pg``; every
    group logs into ``world``'s byte log.  ``n_edge`` = E > 1 makes the P
    pods a two-tier fleet of P / E clusters (pod p = c * E + e, the
    reference's fleet slot): each (d, m)'s pod group gets its ``intra``
    and ``cross`` sub-groups (:meth:`PodGroup.split_tiers`).  Every rank
    creates every group, in one order: each pod's mesh, then each
    (d, m)'s pod group, then each (d, m)'s tier groups."""
    n = D * M
    if P < 1 or n < 1 or world.size != P * n:
        raise ValueError(f"a ({P}, {D}, {M}) fleet needs {P * n} ranks, "
                         f"the group has {world.size}")
    ctx = None
    for p in range(P):
        got = sub_mesh(world, [world.ranks[p * n + i] for i in range(n)],
                       D, M)
        ctx = got if got is not None else ctx
    cell = world.rank % n
    pods = None
    for c in range(n):
        ranks = [world.ranks[p * n + c] for p in range(P)]
        group = PodGroup(world.rank // n, P, world.device, world.backend,
                         tier="pod", pg=dist.new_group(ranks), ranks=ranks,
                         log=world.log)
        group.make_host_groups()
        if c == cell:
            pods = group
    # the other (d, m)'s pod groups: the same pods, ranks shifted
    pods.siblings = tuple(world.ranks[c] - world.ranks[cell]
                          for c in range(n))
    pods.split_tiers(n_edge)
    return ctx, pods


def _fleet_main(world, P, D, M, n_edge, fn, *args):
    return fn(*split_fleet_mesh(world, P, D, M, n_edge), *args)


def spawn_fleet_mesh(fn: Callable, P: int, D: int, M: int, device="cuda",
                     args=(), n_edge: int = 1, **kw) -> list:
    """Run ``fn(ctx, pods, *args)`` on P pods of D x M ("data", "model")
    meshes: P * D * M fresh processes (:func:`spawn_pods`, whose keywords
    ``kw`` takes), each with its pod's :class:`ShardCtx` and its (d, m)'s
    pod group (:func:`split_fleet_mesh`; ``n_edge`` > 1: a two-tier fleet
    of P / ``n_edge`` clusters); returns their results in world rank
    order."""
    return spawn_pods(_fleet_main, P * D * M, device,
                      args=(P, D, M, n_edge, fn) + tuple(args), **kw)
