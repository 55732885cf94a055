"""Deterministic fault injection for soak tests and benchmarks — a copy
of ``repro/runtime/faults.py`` (numpy only): the same events from the same
seeds, the same bytes flipped.

A :class:`FaultSchedule` is a seeded, step-indexed list of fleet events —
kill a pod at step k, rejoin it at step m, corrupt a checkpoint leaf on
disk, delay a pod's heartbeats — that the host loop
(:class:`repro_torch.launch.train.TrainLoop`) drains at the top of every
iteration.  Schedules are pure data: deterministic in their constructor
arguments (or in ``seed`` for :meth:`FaultSchedule.random`), so a
fault-injected soak is exactly reproducible and CI failures replay.

The checkpoint corruptor flips bytes INSIDE a leaf payload (past the .npy
header) so the corruption is exactly what the checkpointer's CRC pass is
for: a file that still parses but whose contents changed.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: event kinds the TrainLoop understands
KILL_POD = "kill_pod"
REJOIN_POD = "rejoin_pod"
CORRUPT_CKPT = "corrupt_checkpoint"
DELAY_HEARTBEAT = "delay_heartbeat"

KINDS = (KILL_POD, REJOIN_POD, CORRUPT_CKPT, DELAY_HEARTBEAT)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int           # host step at which the event fires
    kind: str           # one of KINDS
    target: int = 0     # pod id (kill/rejoin/delay) or leaf index (corrupt)
    duration: int = 0   # delay_heartbeat: steps of silence

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class FaultSchedule:
    """An ordered, consumable schedule of :class:`FaultEvent`.

    ``due(step)`` pops and returns every event whose step has arrived
    (events are delivered at most once).  ``peek()`` exposes what remains
    so tests can assert the schedule drained.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._events: List[FaultEvent] = sorted(events,
                                                key=lambda e: e.step)
        self.fired: List[FaultEvent] = []

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self._events)

    def peek(self) -> Tuple[FaultEvent, ...]:
        return tuple(self._events)

    def due(self, step: int) -> List[FaultEvent]:
        out = []
        while self._events and self._events[0].step <= step:
            out.append(self._events.pop(0))
        self.fired.extend(out)
        return out

    # ------------------------------------------------------------------
    @classmethod
    def preempt_and_rejoin(cls, pod: int, kill_step: int,
                           rejoin_step: int) -> "FaultSchedule":
        """The canonical elastic soak: pod preempted at k, back at m."""
        if rejoin_step <= kill_step:
            raise ValueError("rejoin must come after the kill")
        return cls([FaultEvent(kill_step, KILL_POD, pod),
                    FaultEvent(rejoin_step, REJOIN_POD, pod)])

    @classmethod
    def random(cls, seed: int, n_steps: int, n_pods: int,
               n_kills: int = 1, n_corruptions: int = 0,
               n_delays: int = 0) -> "FaultSchedule":
        """A seeded random schedule: each kill is paired with a later
        rejoin (membership returns to full strength by the end), plus
        optional checkpoint corruptions and heartbeat delays.  Pod 0 is
        never killed (the coordinator slot)."""
        rng = np.random.RandomState(seed)
        events: List[FaultEvent] = []
        lo, hi = max(2, n_steps // 8), max(3, n_steps - 2)
        for _ in range(n_kills):
            if n_pods < 2 or hi - lo < 2:
                break
            k = int(rng.randint(lo, hi - 1))
            m = int(rng.randint(k + 1, hi))
            pod = int(rng.randint(1, n_pods))
            events.append(FaultEvent(k, KILL_POD, pod))
            events.append(FaultEvent(m, REJOIN_POD, pod))
        for _ in range(n_corruptions):
            events.append(FaultEvent(int(rng.randint(lo, hi)),
                                     CORRUPT_CKPT, int(rng.randint(0, 8))))
        for _ in range(n_delays):
            events.append(FaultEvent(
                int(rng.randint(lo, hi)), DELAY_HEARTBEAT,
                int(rng.randint(0, n_pods)),
                duration=int(rng.randint(1, 4))))
        return cls(events)


def corrupt_checkpoint_leaf(ckpt_dir: str, leaf: int,
                            step: Optional[int] = None, seed: int = 0,
                            n_bytes: int = 64) -> Optional[str]:
    """Flip ``n_bytes`` random payload bytes of one leaf file in the
    newest (or given) checkpoint — deterministic in ``seed``.  Returns the
    corrupted path, or None when there is nothing to corrupt.  Bytes past
    the 128-byte .npy header are targeted so the file still loads and
    only the CRC (not the parser) can catch it."""
    if step is None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        if not steps:
            return None
        step = steps[-1]
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    path = os.path.join(d, f"leaf_{leaf}.npy")
    if not os.path.isfile(path):
        names = sorted(n for n in os.listdir(d)
                       if n.startswith("leaf_") and n.endswith(".npy"))
        if not names:
            return None
        path = os.path.join(d, names[leaf % len(names)])
    size = os.path.getsize(path)
    header = min(128, size)
    if size <= header:
        return None
    rng = np.random.RandomState(seed)
    with open(path, "r+b") as f:
        for _ in range(max(1, n_bytes)):
            off = header + int(rng.randint(0, size - header))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    return path


def truncate_checkpoint_leaf(ckpt_dir: str, leaf: int,
                             step: Optional[int] = None) -> Optional[str]:
    """Truncate a leaf file to half its length — the torn-write shape of
    corruption (a crash mid-copy).  Returns the truncated path."""
    if step is None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        if not steps:
            return None
        step = steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:08d}", f"leaf_{leaf}.npy")
    if not os.path.isfile(path):
        return None
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return path
