"""Fault-tolerant checkpointer — port of ``repro/checkpoint/checkpointer.py``
that writes the reference's on-disk format, so that either package
restores the other's checkpoints.

Layout:  <dir>/step_<N>/
            manifest.json        step, n_leaves, per-leaf shape / dtype /
                                 crc32, extras, leaf_paths
            leaf_<k>.npy         one .npy per leaf, (P, ...) with the
                                 leading pod dimension, the leaf whole
         <dir>/LATEST            atomic pointer file

The leaves are numbered in the reference's flatten order
(:func:`repro_torch.tree.reference_leaves_with_path`: dict keys sorted,
NamedTuple fields in declared order), each stacked over the pods as the
reference's state carries them, so ``leaf_<k>.npy`` holds the same leaf
in both packages.  ``treedef_repr`` is written as null (the reference
checks it only when present); ``leaf_paths`` names every leaf, and the
port checks it when present, as the reference checks its treedef.

The reference's properties, kept here:

  * atomic publish: the leaves and the manifest go to ``step_<N>.tmp``,
    are fsync'd, the directory is renamed, and the LATEST pointer is
    replaced last; a leftover ``.tmp`` is ignored by readers and removed
    by :meth:`Checkpointer.prune`;
  * integrity: a CRC-32 per leaf over the whole (P, ...) array; a corrupt,
    truncated or partial checkpoint is skipped on restore, with fallback
    to the newest step that verifies (an explicit step raises instead);
  * loud background writes: ``save`` copies the state to the host in the
    foreground (the state changes in place at the next step) and writes
    it on a background thread, whose failure is re-raised by the next
    ``save`` or ``wait``;
  * retries with exponential backoff before a write gives up;
  * elastic restore: pod p reads row p mod P_saved of every leaf, the
    reference's cut (P_saved > P) and tile (P_saved < P) of the pod
    dimension; a leaf of another shape raises, never loads.

Every process writes and reads its own region of each leaf file, and
one rule, :meth:`Checkpointer._regions`, places it.  One process, or pod
p of a pod group (``pods``, one process per pod): row p of every leaf,
whole.  A rank of a within-pod ("data", "model") mesh (``mesh``, a
:class:`MeshLayout`: the group of the mesh's ranks and the function
giving one :class:`LeafShard` per state leaf): its shard of row 0 (the
reference's state on a mesh has one row, the global leaves), written by
the first of the ranks holding that shard.  So a mesh checkpoint is the
one-card checkpoint of the same state, byte for byte, and a restore onto
any mesh shape, or onto one card, reads slices of the same files.  On a
fleet of meshes (both: ``pods`` the group of the P ranks at this rank's
(d, m)) rank (p, d, m) takes its shard of row p, written by the first
rank of pod p holding it: the checkpoint that P pod processes with one
card each write for the same state, byte for byte; a restore reads its
shard of row p mod P_saved, onto any fleet of meshes, a pod-only fleet
or one card.  Its stages are agreed over the pod's mesh, then over the
(d, m)'s pods, which reaches every rank.

No process's state crosses a link: rank 0 of the group creates each
``leaf_<k>.npy`` at its global (P, ...) size, every process ``pwrite``s
each contiguous C-order run of its regions (one run for a row or a shard
along the first dimension, strided runs for a shard along an inner one)
and fsyncs, so a full disk or any other failed write raises ``OSError``
on the writing thread; rank 0 reads every file back for its CRC
(interleaved shards cannot combine theirs) and publishes.  The background thread coordinates these stages over the
group's ``ckpt_pg`` (a gloo group used by no other thread) of the group
that was current when the save began, so the loop may change its
membership while a write is in flight; a failure on any process fails
the stage on every process.  On restore rank 0 picks the newest step
that verifies and sends it to the others over ``host_pg``, so that every
process falls back to the same step; every process then checks each
file's global shape against its layout (a leaf of another shape raises
``ValueError`` naming it before any leaf is loaded) and reads its
regions.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T


class LeafShard(NamedTuple):
    """Where one state leaf of this process lies in the checkpoint's
    leaf: the leaf's global shape (no pod dimension), this process's
    index into it (a slice per dimension) and whether it writes it."""
    shape: tuple
    index: tuple
    writes: bool


def whole_leaves(state) -> List[LeafShard]:
    """The layout without a mesh: every leaf whole, written by this
    process."""
    return [LeafShard(tuple(x.shape), tuple(slice(None) for _ in x.shape),
                      True) for _, x in T.reference_leaves_with_path(state)]


class MeshLayout(NamedTuple):
    """A within-pod mesh's side of a checkpoint: ``group``, the group of
    the mesh's ranks (its ``ckpt_pg`` and ``host_pg`` coordinate the
    ranks), and ``layout``, a function of this rank's state giving one
    :class:`LeafShard` per leaf (``Trainer.state_layout``)."""
    group: Any
    layout: Callable[[Any], List[LeafShard]]


def _runs(shape: tuple, index: tuple) -> tuple:
    """The contiguous C-order runs of the region ``index`` (a slice of
    step 1 per dimension) of an array of ``shape``: (each run's element
    offset from the array's start, in C order, and the run's length).
    The region's elements in C order are its runs one after another."""
    lo, ext = [], []
    for sl, n in zip(index, shape):
        a, b, step = sl.indices(n)
        if step != 1:
            raise ValueError(f"a region's slices have step 1, not {sl}")
        lo.append(a)
        ext.append(max(b - a, 0))
    if 0 in ext:
        return np.zeros(0, np.int64), 0
    k = len(shape)
    while k > 0 and ext[k - 1] == shape[k - 1]:
        k -= 1                  # whole inner dimensions join the run
    inner = math.prod(shape[k:])
    if k == 0:
        return np.zeros(1, np.int64), inner
    stride = [math.prod(shape[d + 1:]) for d in range(k)]
    offs = np.array([lo[k - 1] * inner], np.int64)
    for d in reversed(range(k - 1)):
        offs = ((lo[d] + np.arange(ext[d], dtype=np.int64))[:, None]
                * stride[d] + offs[None, :]).ravel()
    return offs, ext[k - 1] * inner


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of one state leaf (the state is updated in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def _pwrite_all(fd: int, data: memoryview, offset: int) -> None:
    while len(data):
        n = os.pwrite(fd, data, offset)
        data, offset = data[n:], offset + n


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed integrity verification."""


class Checkpointer:
    #: write attempts per snapshot before the failure is surfaced
    RETRIES = 3
    #: base backoff between attempts (doubles each retry)
    BACKOFF_S = 0.05

    def __init__(self, directory: str, pods=None,
                 mesh: Optional[MeshLayout] = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        #: the pod group of the next save and of restores (None: one
        #: pod); the loop replaces it when the membership changes
        self.pods = pods
        #: a within-pod mesh's group and layout (None: no mesh)
        self.mesh = mesh
        #: the groups writing the save in flight
        self._writers = self._groups()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: steps whose directories failed verification this process
        self.corrupt_steps: List[int] = []
        #: the last save's bytes (``bytes`` the checkpoint's, ``rank_bytes``
        #: the leaves this process wrote) and seconds: ``copy_s`` in the
        #: foreground, ``write_s`` on the background thread, ``crc_s`` of
        #: it rank 0's read-back for the CRCs
        self.last_save: Dict[str, float] = {}

    def _groups(self) -> list:
        """The groups whose processes write and read one checkpoint,
        agreed over in this order: the mesh's, then the pods'."""
        return [g for g in (None if self.mesh is None else self.mesh.group,
                            self.pods) if g is not None]

    def _lead(self, groups=None) -> bool:
        """This process prepares, publishes and prunes: rank 0 of every
        group of ``groups`` (by default :meth:`_groups`)."""
        return all(g.rank == 0 for g in (self._groups() if groups is None
                                         else groups))

    def _rows(self) -> int:
        """The rows of a checkpoint this process saves: one per pod."""
        return self._size(self.pods)

    def _regions(self, state, rows: int) -> List[LeafShard]:
        """Where each leaf of ``state`` lies in a checkpoint of ``rows``
        rows: its global shape (no pod dimension), this process's region
        of the (rows, ...) file (the row, then a slice per dimension) and
        whether this process writes it.  Pod p takes row p mod rows: whole,
        or on a mesh rank its layout's shard of it."""
        row = self._rank(self.pods) % rows
        shards = (whole_leaves(state) if self.mesh is None
                  else self.mesh.layout(state))
        return [LeafShard(sh.shape, (slice(row, row + 1),) + sh.index,
                          sh.writes) for sh in shards]

    @staticmethod
    def _rank(group) -> int:
        return 0 if group is None else group.rank

    @staticmethod
    def _size(group) -> int:
        return 1 if group is None else group.size

    def _path(self, step: int, *name: str) -> str:
        return os.path.join(self.dir, f"step_{step:08d}", *name)

    # ------------------------------------------------------------------
    def _raise_pending(self):
        """Surface a background write failure captured since the last
        call — a failed snapshot is loud, not silent."""
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"checkpoint write failed in the background: {err!r} — the "
                f"previous valid checkpoint is untouched") from err

    def save(self, step: int, state, extras: Optional[Dict[str, Any]] = None,
             blocking: bool = False):
        """Snapshot ``state`` (this process's tree of tensors) at
        ``step``.  Every process of the group calls this at the same
        step."""
        self.wait()             # also re-raises a prior failed write
        t0 = time.perf_counter()
        pairs = T.reference_leaves_with_path(state)
        self._writers = self._groups()
        P = self._rows()
        layout = self._regions(state, P)
        # (leaf number, region, host copy) of each leaf this process writes
        host = [(i, sh.index, _host(leaf))
                for i, ((_, leaf), sh) in enumerate(zip(pairs, layout))
                if sh.writes]
        dtypes = [_np_dtype(leaf) for _, leaf in pairs]
        payload = {
            "step": step,
            "treedef_repr": None,
            "n_leaves": len(pairs),
            "leaves": [{"shape": [P] + list(sh.shape), "dtype": str(dt),
                        "crc32": None} for sh, dt in zip(layout, dtypes)],
            "extras": extras or {},
            "leaf_paths": [T.path_str(p) for p, _ in pairs],
        }
        self.last_save = {
            "step": step,
            "bytes": P * sum(math.prod(sh.shape) * dt.itemsize
                             for sh, dt in zip(layout, dtypes)),
            "rank_bytes": sum(h.nbytes for _, _, h in host),
            "copy_s": time.perf_counter() - t0}
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, payload),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write_guarded(self, step: int, host, payload):
        """Background entry point: retry transient failures with backoff,
        capture the terminal one for the next save()/wait().  Every
        attempt writes into ``.tmp`` first, so the previous valid
        checkpoint is never touched by a failed snapshot.  The processes
        of a group fail each stage together, so they retry together."""
        t0 = time.perf_counter()
        delay = self.BACKOFF_S
        for attempt in range(self.RETRIES):
            try:
                self._write(step, host, payload)
                self.last_save["write_s"] = time.perf_counter() - t0
                return
            except BaseException as e:  # noqa: BLE001 - re-raised on wait
                if attempt == self.RETRIES - 1:
                    self._error = e
                    return
                time.sleep(delay)
                delay *= 2

    def _stage(self, fn) -> None:
        """Run one write stage (``fn`` may be None: nothing to do on this
        process), then agree with the others: a stage that failed on any
        process raises on every process."""
        err = None
        if fn is not None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - raised below
                err = e
        # the failures known to this process, as (rank, message), ranks
        # written as the index in each group from the last one out; a
        # gather over each group in turn spreads them to every process
        bad = [] if err is None else [((), repr(err))]
        for group in self._writers:
            if group.size > 1:
                got = [None] * group.size
                dist.all_gather_object(got, bad, group=group.ckpt_pg)
                bad = sorted({((p,) + who, m) for p, part in enumerate(got)
                              for who, m in part})
        if bad and err is None:
            who = "/".join(str(p) for p in bad[0][0])
            raise RuntimeError(f"checkpoint write failed on rank {who}: "
                               f"{bad[0][1]}")
        if err is not None:
            raise err

    def _write(self, step: int, host, payload):
        final = self._path(step)
        tmp = final + ".tmp"
        lead = self._lead(self._writers)
        self._stage((lambda: self._prepare(tmp, payload)) if lead else None)
        self._stage(lambda: self._write_shards(tmp, host))
        self._stage((lambda: self._publish(final, tmp, payload))
                    if lead else None)

    def _prepare(self, tmp: str, payload):
        """Rank 0: a fresh ``.tmp`` directory holding every leaf file at
        its global (P, ...) size, header written."""
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, meta in enumerate(payload["leaves"]):
            mm = np.lib.format.open_memmap(
                os.path.join(tmp, f"leaf_{i}.npy"), mode="w+",
                dtype=np.dtype(meta["dtype"]), shape=tuple(meta["shape"]))
            del mm

    def _write_shards(self, tmp: str, host):
        """Every process: its region of each leaf it writes, one
        ``pwrite`` per contiguous run (:func:`_runs`), fsync'd.  A failed
        write (a full disk among them) raises ``OSError``."""
        for i, region, h in host:
            path = os.path.join(tmp, f"leaf_{i}.npy")
            head = np.load(path, mmap_mode="r")
            offset, shape = head.offset, head.shape
            del head
            offs, n = _runs(shape, region)
            size = n * h.itemsize
            data = memoryview(np.ascontiguousarray(h).reshape(-1)
                              .view(np.uint8))
            fd = os.open(path, os.O_WRONLY)
            try:
                for j, off in enumerate(offs.tolist()):
                    _pwrite_all(fd, data[j * size:(j + 1) * size],
                                offset + off * h.itemsize)
                os.fsync(fd)
            finally:
                os.close(fd)

    def _publish(self, final: str, tmp: str, payload):
        """Rank 0: the CRC of every leaf file read back whole, the
        manifest, the rename, LATEST."""
        t0 = time.perf_counter()
        for i, meta in enumerate(payload["leaves"]):
            mm = np.load(os.path.join(tmp, f"leaf_{i}.npy"), mmap_mode="r")
            meta["crc32"] = _leaf_crc(mm)
            del mm
        self.last_save["crc_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._raise_pending()

    # ------------------------------------------------------------------
    # integrity
    # ------------------------------------------------------------------
    def _step_dirs(self) -> List[int]:
        """Complete (non-.tmp) step directories, oldest first."""
        out = []
        for n in os.listdir(self.dir):
            if not n.startswith("step_") or n.endswith(".tmp"):
                continue
            try:
                out.append(int(n.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def _manifest(self, step: int) -> Optional[dict]:
        try:
            with open(self._path(step, "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _check_leaf(self, step: int, i: int, meta: Optional[dict]):
        """Load one leaf and hold it to its manifest entry; raises
        :class:`CheckpointCorruptError`."""
        d = self._path(step)
        try:
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"), mmap_mode="r")
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{d}: leaf_{i}.npy unreadable ({e})") from e
        if meta is not None:
            if list(arr.shape) != list(meta["shape"]) \
                    or str(arr.dtype) != meta["dtype"]:
                raise CheckpointCorruptError(
                    f"{d}: leaf_{i}.npy is {arr.dtype}{arr.shape}, "
                    f"manifest says {meta['dtype']}{tuple(meta['shape'])}")
            if _leaf_crc(arr) != int(meta["crc32"]):
                raise CheckpointCorruptError(
                    f"{d}: leaf_{i}.npy checksum mismatch (bit rot or "
                    f"truncated write)")
        return arr

    def verify(self, step: int, deep: bool = False) -> bool:
        """Structural (and with ``deep`` checksum-level) validation of one
        checkpoint directory: the manifest parses, every leaf file exists
        and — deep — its bytes match the recorded shape/dtype/CRC."""
        payload = self._manifest(step)
        if payload is None or payload.get("n_leaves") is None:
            return False
        metas = payload.get("leaves")
        for i in range(int(payload["n_leaves"])):
            if not os.path.isfile(self._path(step, f"leaf_{i}.npy")):
                return False
            if deep:
                try:
                    self._check_leaf(step, i,
                                     None if metas is None else metas[i])
                except CheckpointCorruptError:
                    return False
        return True

    def valid_steps(self, deep: bool = False) -> List[int]:
        """Steps whose directories pass :meth:`verify`, oldest first."""
        return [s for s in self._step_dirs() if self.verify(s, deep=deep)]

    def latest_step(self) -> Optional[int]:
        """The step LATEST points to — falling back to the newest step
        directory that verifies when the pointer is missing, unparsable,
        or points at a missing/corrupt directory."""
        p = os.path.join(self.dir, "LATEST")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    name = f.read().strip()
                step = int(name.split("_")[1])
                if self.verify(step):
                    return step
            except (OSError, IndexError, ValueError):
                pass
        valid = self.valid_steps()
        return valid[-1] if valid else None

    # ------------------------------------------------------------------
    def _verified_step(self, step: Optional[int], n_expected: int) -> int:
        """The step to restore: ``step``, or the newest one whose every
        leaf verifies (corrupt ones are recorded and skipped)."""
        if step is not None:
            candidates = [step]
        else:
            candidates = list(reversed(self.valid_steps()))
            if not candidates:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                payload = self._manifest(s)
                if payload is None:
                    raise CheckpointCorruptError(
                        f"{self._path(s)}: unreadable manifest")
                if payload["n_leaves"] != n_expected:
                    raise CheckpointCorruptError(
                        f"{self._path(s)}: holds {payload['n_leaves']} "
                        f"leaves, template has {n_expected} — tree "
                        f"structure changed")
                metas = payload.get("leaves")
                for i in range(n_expected):
                    self._check_leaf(s, i,
                                     None if metas is None else metas[i])
                return s
            except CheckpointCorruptError as e:
                self.corrupt_steps.append(s)
                if step is not None:
                    raise
                print(f"WARNING: skipping corrupt checkpoint: {e}",
                      flush=True)
                last_err = e
        raise CheckpointCorruptError(
            f"no checkpoint in {self.dir} survived verification "
            f"(last failure: {last_err})")

    def _agreed_step(self, step: Optional[int], n_expected: int) -> int:
        """:meth:`_verified_step` on the lead, the same answer (or error)
        on every process of the groups (a broadcast over each in turn)."""
        groups = [g for g in self._groups() if g.size > 1]
        if not groups:
            return self._verified_step(step, n_expected)
        msg = [None]
        if self._lead():
            try:
                msg[0] = ("ok", self._verified_step(step, n_expected),
                          self.corrupt_steps)
            except (FileNotFoundError, CheckpointCorruptError) as e:
                msg[0] = (type(e).__name__, str(e), self.corrupt_steps)
        for group in groups:
            dist.broadcast_object_list(msg, src=group.ranks[0],
                                       group=group.host_pg)
        kind, val, corrupt = msg[0]
        self.corrupt_steps = list(corrupt)
        if kind == "FileNotFoundError":
            raise FileNotFoundError(val)
        if kind != "ok":
            raise CheckpointCorruptError(val)
        return val

    def restore(self, template, step: Optional[int] = None):
        """Load a checkpoint into the tensors of ``template`` (this
        process's tree of tensors, filled in place) and return
        ``(template, extras)``.

        With ``step=None`` the newest checkpoint that verifies is used
        (fallback past corrupt ones); an explicit ``step`` raises on
        corruption.  Pod p of P reads row p mod P_saved of each leaf, a
        mesh rank its layout's region of it (:meth:`_regions`)."""
        pairs = T.reference_leaves_with_path(template)
        s = self._agreed_step(step, len(pairs))
        payload = self._manifest(s)
        want = [T.path_str(p) for p, _ in pairs]
        have = payload.get("leaf_paths")
        if have is not None and have != want:
            diff = next(i for i, (a, b) in enumerate(zip(have, want))
                        if a != b)
            raise ValueError(
                f"checkpoint step {payload['step']} was written for a "
                f"different tree structure: leaf {diff} is {have[diff]!r} "
                f"there, {want[diff]!r} in the template (restoring would "
                f"silently permute state leaves)")
        arrs = [np.load(self._path(s, f"leaf_{i}.npy"), mmap_mode="r")
                for i in range(len(pairs))]
        layout = self._regions(template, arrs[0].shape[0] if arrs else 1)
        for i, ((path, leaf), sh, arr) in enumerate(zip(pairs, layout,
                                                         arrs)):
            if (tuple(arr.shape[1:]) != tuple(sh.shape)
                    or arr.dtype != _np_dtype(leaf)):
                raise ValueError(
                    f"leaf {i} ({T.path_str(path)}): checkpoint holds "
                    f"{arr.dtype}{tuple(arr.shape)}, the state "
                    f"{_np_dtype(leaf)}{tuple(sh.shape)} per pod")
        with torch.no_grad():
            for (_, leaf), sh, arr in zip(pairs, layout, arrs):
                part = np.array(arr[sh.index])
                leaf.copy_(torch.from_numpy(part).reshape(leaf.shape))
        return template, payload["extras"]

    def prune(self, keep: int = 3):
        """Keep only the newest ``keep`` checkpoints — but never remove
        the step LATEST points to (restore's anchor), and clean leftover
        ``.tmp`` directories from crashed writers.  The lead prunes for
        the groups."""
        if not self._lead():
            return
        for n in os.listdir(self.dir):
            if n.startswith("step_") and n.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, n), ignore_errors=True)
        protect = self.latest_step()
        steps = self._step_dirs()
        for s in steps[:-keep] if keep > 0 else steps:
            if s == protect:
                continue
            shutil.rmtree(self._path(s), ignore_errors=True)


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype
