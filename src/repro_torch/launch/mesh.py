"""The pod group: one process per pod over ``torch.distributed`` — the
port's counterpart of ``repro/launch/mesh.py``'s ``make_mesh``.

The reference runs P pods as one SPMD program over a ("pod", "data",
"model") mesh and names the pod axis in its collectives.  The port runs
one process per pod ("data" and "model" are 1) and hands every collective
a :class:`PodGroup`:

  * ``all_gather_bytes(u8) -> (P, nbytes)`` — the one-shot payload
    exchange, pod-major like the reference's ``all_gather``;
  * ``all_reduce_sum`` / ``pmean`` of small f32 tensors (grad stats,
    divergence projections, the parameter average), summed in pod order
    so that every pod gets the same bits;
  * ``full_exchange`` — FULL's cross-pod sum of bf16 contributions,
    summed in f32 in pod order and rounded to bf16 once, as the reference
    does on XLA:CPU (bf16(sum of f32(contrib))), identical on every pod;
  * ``ring_stage`` / ``ring_hop`` / ``ring_to_device`` — the point-to-point
    hops of the chunked ring (the reference's ``ppermute``): one hop of a
    chunk goes to pod (rank + 1) % P and comes from (rank - 1) % P
    (forward), or the other way round (backward), both directions in
    flight together;
  * a log of the bytes each collective received per pod (``log``), so a
    run can hold the exchange to the analytic ``plan_wire_bytes``.

The backend follows from the layout, before any collective runs: NCCL
when every pod has a card of its own; gloo when pods share a card or run
on the CPU.  NCCL refuses two ranks on one device, so pods that share a
card stage each CUDA collective through pinned host memory: one copy to
the host, a stream synchronisation, the gloo collective, one copy back.
The ring stages its own chunks once per exchange and forwards what it
received from host memory as it is.

:func:`spawn_pods` starts the P pod processes and gathers their results.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import ftz

#: wait for a peer this long before a collective gives up
TIMEOUT_S = 900


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
    """One pod's handle on the pod group (rank, size, device, collectives
    and the byte log)."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        #: staged through host memory: CUDA tensors under gloo
        self.staged = backend == "gloo" and self.device.type == "cuda"
        #: one entry per collective: op, bytes received per pod, host
        #: seconds in the call, and of those the seconds spent waiting for
        #: the card before a staged copy
        self.log: List[dict] = []
        self._sync_s = 0.0

    # ---- transport -------------------------------------------------------
    def _gather_flat(self, u8: torch.Tensor) -> torch.Tensor:
        """(nbytes,) uint8 on this pod -> (P, nbytes) on its device."""
        P, n = self.size, u8.numel()
        if self.backend == "nccl":
            out = torch.empty((P, n), dtype=torch.uint8, device=u8.device)
            dist.all_gather_into_tensor(out.view(-1), u8)
            return out
        pin = self.staged
        src = u8
        if pin:
            src = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
            src.copy_(u8, non_blocking=True)
            t0 = time.perf_counter()
            # the gloo call reads the host copy: it must have landed (the
            # wait also covers the device work queued before the copy)
            torch.cuda.current_stream(u8.device).synchronize()
            self._sync_s += time.perf_counter() - t0
        out = torch.empty((P, n), dtype=torch.uint8, pin_memory=pin)
        dist.all_gather(list(out.unbind(0)), src)
        return out.to(u8.device, non_blocking=True) if pin else out

    def _collective(self, op: str, u8: torch.Tensor) -> torch.Tensor:
        self._sync_s = 0.0
        t0 = time.perf_counter()
        out = self._gather_flat(u8.contiguous().view(-1))
        self.log.append({"op": op, "bytes": (self.size - 1) * u8.numel(),
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

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a small f32 tensor over the pods, in pod order 0..P-1
        (the same bits on every pod)."""
        if x.dtype != torch.float32:
            raise ValueError(f"all_reduce_sum takes float32, got {x.dtype}")
        parts = self._gather_values(x, "reduce")
        out = parts[0]
        for p in range(1, self.size):
            out = ftz(out + parts[p])
        return out

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the pods: the pod-order sum times 1/P in f32 (XLA
        turns the reference's division by the pod count into this
        product)."""
        return ftz(self.all_reduce_sum(x) * float(
            torch.tensor(1.0 / self.size, dtype=torch.float32)))

    def full_exchange(self, contrib: torch.Tensor) -> torch.Tensor:
        """FULL's cross-pod sum: bf16 contributions -> f32 aggregate,
        bf16(sum over pods, in pod order, of f32(contrib))."""
        if contrib.dtype != torch.bfloat16:
            raise ValueError(f"FULL sums bf16 contributions, got "
                             f"{contrib.dtype}")
        parts = self._gather_values(contrib, "full")
        acc = parts[0].float()
        for p in range(1, self.size):
            acc = ftz(acc + parts[p].float())
        return acc.to(torch.bfloat16).float()

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
        other way round; None posts nothing in that direction.  ``tag``
        names the (hop, chunk) on every pod alike, so that messages cannot
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
            dst, src, t = (r + d) % P, (r - d) % P, 2 * tag + (d < 0)
            out = torch.empty((buf.numel(),), dtype=torch.uint8,
                              device=buf.device, pin_memory=self.staged)
            recvs.append(out)
            if self.backend == "nccl":
                ops += [dist.P2POp(dist.isend, buf, dst, tag=t),
                        dist.P2POp(dist.irecv, out, src, tag=t)]
            else:
                works.append(dist.irecv(out, src, tag=t))
                works.append(dist.isend(buf, dst, tag=t))
        if ops:
            works = dist.batch_isend_irecv(ops)
        entry = {"op": "ring",
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

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    # ---- the byte log ----------------------------------------------------
    def bytes_logged(self, op: Optional[str] = None) -> int:
        return sum(e["bytes"] for e in self.log
                   if op is None or e["op"] == op)


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


def _pod_main(rank, n_pods, device_type, init_method, threads, fn, args,
              results):
    """Body of one pod process: join the group, run ``fn``, report."""
    try:
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
            results.put((rank, True, fn(group, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_pods(fn: Callable, n_pods: int, device="cuda", args=(), *,
               init_method: Optional[str] = None, threads: int = 0,
               timeout: float = 3600.0) -> list:
    """Run ``fn(group, *args)`` in ``n_pods`` fresh processes, one per pod,
    and return their results in rank order.  ``fn`` and its arguments and
    results must pickle (``fn`` by import path).  Rendezvous is
    ``init_method`` (default: a free ``tcp://localhost`` port).  Raises if
    a pod fails or the run outlasts ``timeout`` seconds; every process is
    stopped before this returns."""
    import multiprocessing as mp
    import queue as queue_mod

    device_type = torch.device(device).type
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = init_method or free_tcp_address()
    env = {"OMP_NUM_THREADS": str(threads)} if threads else {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    procs = []
    try:
        for r in range(n_pods):
            p = ctx.Process(target=_pod_main,
                            args=(r, n_pods, device_type, init_method,
                                  threads, fn, args, results))
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
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
