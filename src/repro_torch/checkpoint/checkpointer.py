"""Fault-tolerant checkpointer — port of ``repro/checkpoint/checkpointer.py``
that writes the reference's on-disk format, so that either package
restores the other's checkpoints.

Layout:  <dir>/step_<N>/
            manifest.json        step, n_leaves, per-leaf shape / dtype /
                                 crc32, extras, leaf_paths
            leaf_<k>.npy         one .npy per leaf, (P, ...) with the
                                 leading pod dimension
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

With a pod group (``pods``, one process per pod) no pod's state crosses
the pod link: rank 0 creates each ``leaf_<k>.npy`` with its (P, ...)
header, every pod writes its own row (one contiguous byte range in C
order), and rank 0 checksums the files and publishes.  The background
thread coordinates these stages over the group's ``ckpt_pg`` (a gloo
group used by no other thread) of the group that was current when the
save began, so the loop may change its membership while a write is in
flight; a failure on any pod fails the stage on every pod.  On restore
rank 0 picks the newest step that verifies and sends it to the others
over ``host_pg``, so that every pod falls back to the same step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T


def _leaf_crc(arr: np.ndarray, crc: int = 0) -> int:
    return zlib.crc32(np.ascontiguousarray(arr), crc) & 0xFFFFFFFF


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

    def __init__(self, directory: str, pods=None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        #: the pod group of the next save and of restores (None: one
        #: pod); the loop replaces it when the membership changes
        self.pods = pods
        #: the pod group writing the save in flight
        self._writers = pods
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: steps whose directories failed verification this process
        self.corrupt_steps: List[int] = []
        #: the last save's bytes (all pods) and seconds: ``copy_s`` in
        #: the foreground, ``write_s`` on the background thread
        self.last_save: Dict[str, float] = {}

    @staticmethod
    def _rank(pods) -> int:
        return 0 if pods is None else pods.rank

    @staticmethod
    def _size(pods) -> int:
        return 1 if pods is None else pods.size

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
        """Snapshot ``state`` (this pod's tree of tensors) at ``step``.
        With a pod group every pod of the group calls this at the same
        step."""
        self.wait()             # also re-raises a prior failed write
        t0 = time.perf_counter()
        pairs = T.reference_leaves_with_path(state)
        host = [_host(leaf) for _, leaf in pairs]
        self._writers = self.pods
        P = self._size(self._writers)
        payload = {
            "step": step,
            "treedef_repr": None,
            "n_leaves": len(host),
            "leaves": [{"shape": [P] + list(h.shape), "dtype": str(h.dtype),
                        "crc32": None} for h in host],
            "extras": extras or {},
            "leaf_paths": [T.path_str(p) for p, _ in pairs],
        }
        self.last_save = {"step": step,
                          "bytes": P * sum(h.nbytes for h in host),
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
        checkpoint is never touched by a failed snapshot.  The pods of a
        group fail each stage together, so they retry together."""
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
        pod), then agree with the other pods: a stage that failed on any
        pod raises on every pod."""
        err = None
        if fn is not None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - raised below
                err = e
        pods = self._writers
        if self._size(pods) > 1:
            got = [None] * pods.size
            dist.all_gather_object(got, None if err is None else repr(err),
                                   group=pods.ckpt_pg)
            bad = [(p, m) for p, m in enumerate(got) if m is not None]
            if bad and err is None:
                raise RuntimeError(f"checkpoint write failed on pod "
                                   f"{bad[0][0]}: {bad[0][1]}")
        if err is not None:
            raise err

    def _write(self, step: int, host, payload):
        final = self._path(step)
        tmp = final + ".tmp"
        lead = self._rank(self._writers) == 0
        self._stage((lambda: self._prepare(tmp, payload)) if lead else None)
        self._stage(lambda: self._write_rows(tmp, host))
        self._stage((lambda: self._publish(final, tmp, host, payload))
                    if lead else None)

    def _prepare(self, tmp: str, payload):
        """Rank 0: a fresh ``.tmp`` directory holding every leaf file at
        its full (P, ...) size, header written."""
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, meta in enumerate(payload["leaves"]):
            mm = np.lib.format.open_memmap(
                os.path.join(tmp, f"leaf_{i}.npy"), mode="w+",
                dtype=np.dtype(meta["dtype"]), shape=tuple(meta["shape"]))
            del mm

    def _write_rows(self, tmp: str, host):
        """Every pod: its own row of every leaf, fsync'd."""
        for i, h in enumerate(host):
            path = os.path.join(tmp, f"leaf_{i}.npy")
            offset = np.load(path, mmap_mode="r").offset
            fd = os.open(path, os.O_WRONLY)
            try:
                _pwrite_all(fd, memoryview(np.ascontiguousarray(h)).cast("B"),
                            offset + self._rank(self._writers) * h.nbytes)
                os.fsync(fd)
            finally:
                os.close(fd)

    def _publish(self, final: str, tmp: str, host, payload):
        """Rank 0: the CRC of every leaf (its own row from memory, the
        other pods' from the file), the manifest, the rename, LATEST."""
        for i, (h, meta) in enumerate(zip(host, payload["leaves"])):
            crc = _leaf_crc(h)
            if self._size(self._writers) > 1:
                mm = np.load(os.path.join(tmp, f"leaf_{i}.npy"),
                             mmap_mode="r")
                for r in range(1, self._size(self._writers)):
                    crc = _leaf_crc(mm[r], crc)
                del mm
            meta["crc32"] = crc
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
        """:meth:`_verified_step` on rank 0, the same answer (or error)
        on every pod."""
        if self._size(self.pods) == 1:
            return self._verified_step(step, n_expected)
        msg = [None]
        if self.pods.rank == 0:
            try:
                msg[0] = ("ok", self._verified_step(step, n_expected),
                          self.corrupt_steps)
            except (FileNotFoundError, CheckpointCorruptError) as e:
                msg[0] = (type(e).__name__, str(e), self.corrupt_steps)
        dist.broadcast_object_list(msg, src=self.pods.ranks[0],
                                   group=self.pods.host_pg)
        kind, val, corrupt = msg[0]
        self.corrupt_steps = list(corrupt)
        if kind == "FileNotFoundError":
            raise FileNotFoundError(val)
        if kind != "ok":
            raise CheckpointCorruptError(val)
        return val

    def restore(self, template, step: Optional[int] = None):
        """Load a checkpoint into the tensors of ``template`` (this pod's
        tree of tensors, filled in place) and return ``(template,
        extras)``.

        With ``step=None`` the newest checkpoint that verifies is used
        (fallback past corrupt ones); an explicit ``step`` raises on
        corruption.  Pod p of P reads row p mod P_saved of each leaf."""
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
        with torch.no_grad():
            for i, (path, leaf) in enumerate(pairs):
                arr = np.load(self._path(s, f"leaf_{i}.npy"), mmap_mode="r")
                if (tuple(arr.shape[1:]) != tuple(leaf.shape)
                        or arr.dtype != _np_dtype(leaf)):
                    raise ValueError(
                        f"leaf {i} ({T.path_str(path)}): checkpoint holds "
                        f"{arr.dtype}{tuple(arr.shape)}, the state "
                        f"{_np_dtype(leaf)}{tuple(leaf.shape)} per pod")
                row = np.array(arr[self._rank(self.pods) % arr.shape[0]])
                leaf.copy_(torch.from_numpy(row).reshape(leaf.shape))
        return template, payload["extras"]

    def prune(self, keep: int = 3):
        """Keep only the newest ``keep`` checkpoints — but never remove
        the step LATEST points to (restore's anchor), and clean leftover
        ``.tmp`` directories from crashed writers.  Rank 0 prunes for a
        pod group."""
        if self._rank(self.pods) != 0:
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
