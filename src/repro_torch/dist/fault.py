"""Host-side fault tolerance: leases, heartbeats, restartable loops.

Port of `repro.dist.fault` (stdlib only).  The serving and training
drivers treat work as *stateless quanta* (read batches, train steps
between checkpoints), which reduces fault tolerance to three small
host-side pieces:

* ``WorkQueue`` — lease-based scheduler over ``n`` work items.  A claim
  grants a lease for ``lease_s`` seconds; if the worker neither completes
  nor renews in time, the item becomes claimable again (work *stealing*:
  a straggling or dead worker's item is simply re-issued).  Completion is
  idempotent, so a stolen item finishing twice is harmless — batch
  results are keyed by item id.
* ``Heartbeat`` — flags a straggler when the gap since the previous beat
  exceeds ``factor`` × the trailing-median gap.
* ``RestartableLoop`` — step loop with periodic async checkpoints; on
  (re)entry it resumes from ``CheckpointManager.latest_step()``, so a
  crashed process restarted by the job scheduler loses at most
  ``save_every`` steps.
"""
from __future__ import annotations

import threading
import time
from collections import deque


class WorkQueue:
    """Lease-based work queue over item ids ``0..n_items-1``.

    ``claim()`` hands out an unclaimed item first; when none remain it
    re-issues the *longest-expired* lease (steal ordering: oldest expiry
    first).  Returns None when nothing is claimable right now — either
    every item is done (``finished``) or all outstanding leases are still
    live (caller may retry/back off).  ``lease_s=0`` means leases expire
    immediately: every outstanding item is always stealable, the
    degenerate mode the tests use to exercise reassignment determinism.
    """

    def __init__(self, n_items: int, *, lease_s: float = 300.0):
        if n_items < 0:
            raise ValueError(f"n_items must be >= 0, got {n_items}")
        self.n_items = n_items
        self.lease_s = float(lease_s)
        self._lock = threading.Lock()
        self._pending = deque(range(n_items))  # never-claimed, FIFO
        self._leases: dict[int, float] = {}  # item -> expiry (monotonic)
        self._done: set[int] = set()

    # ------------------------------------------------------------ protocol --
    def claim(self) -> int | None:
        now = time.monotonic()
        with self._lock:
            if self._pending:
                item = self._pending.popleft()
                self._leases[item] = now + self.lease_s
                return item
            expired = sorted(
                (exp, item) for item, exp in self._leases.items() if exp <= now)
            if expired:
                _, item = expired[0]
                self._leases[item] = now + self.lease_s
                return item
            return None

    def renew(self, item: int) -> None:
        """Extend a live lease (long-running worker keep-alive)."""
        with self._lock:
            if item in self._leases:
                self._leases[item] = time.monotonic() + self.lease_s

    def complete(self, item: int) -> None:
        """Mark an item done (idempotent; stolen duplicates are harmless)."""
        with self._lock:
            self._done.add(item)
            self._leases.pop(item, None)

    def fail(self, item: int) -> None:
        """Return a claimed item to the head of the queue immediately."""
        with self._lock:
            if item not in self._done and self._leases.pop(item, None) is not None:
                self._pending.appendleft(item)

    # -------------------------------------------------------------- status --
    @property
    def finished(self) -> bool:
        with self._lock:
            return len(self._done) == self.n_items

    @property
    def outstanding(self) -> int:
        """Items claimed but not yet completed."""
        with self._lock:
            return len(self._leases)

    def __repr__(self) -> str:  # debugging/logs
        with self._lock:
            return (f"WorkQueue(n={self.n_items}, done={len(self._done)}, "
                    f"leased={len(self._leases)}, pending={len(self._pending)})")


class Heartbeat:
    """Straggler detector: ``beat()`` returns True when the gap since the
    previous beat exceeds ``factor`` × the trailing-median gap.

    Call once per step.  The first ``warmup`` intervals only build the
    baseline (never flag) — this absorbs a slow first step (allocator and
    library warm-up).
    """

    def __init__(self, factor: float = 3.0, *, window: int = 64,
                 warmup: int = 5):
        self.factor = float(factor)
        self.warmup = warmup
        self._intervals: deque[float] = deque(maxlen=window)
        self._last: float | None = None
        self.straggler_count = 0

    def beat(self) -> bool:
        now = time.monotonic()
        if self._last is None:
            self._last = now
            return False
        gap = now - self._last
        self._last = now
        slow = False
        if len(self._intervals) >= self.warmup:
            med = sorted(self._intervals)[len(self._intervals) // 2]
            slow = gap > self.factor * max(med, 1e-9)
        if slow:
            self.straggler_count += 1
        else:  # straggler gaps don't poison the baseline
            self._intervals.append(gap)
        return slow


class RestartableLoop:
    """Checkpointed step loop: resume-from-latest on (re)entry.

    ``run(state, step_fn, n_steps)`` restores the latest checkpoint if one
    exists, then runs ``state = step_fn(state, step)`` for the remaining
    steps, saving every ``save_every`` steps (async, double-buffered by
    ``CheckpointManager``) and once more, blocking, at the end.  A crash
    inside ``step_fn`` propagates; the restarted process calls ``run``
    again and loses at most ``save_every`` steps of work.
    """

    def __init__(self, manager, save_every: int = 100):
        if save_every < 1:
            raise ValueError(f"save_every must be >= 1, got {save_every}")
        self.mgr = manager
        self.save_every = save_every

    def run(self, state, step_fn, *, n_steps: int):
        start = self.mgr.latest_step()
        if start is not None:
            state = self.mgr.restore(start, state)
            if start >= n_steps:  # already past the target: don't rewrite
                return state      # checkpoint history with mislabeled state
        else:
            start = 0
        saved = start
        for step in range(start, n_steps):
            state = step_fn(state, step)
            if (step + 1) % self.save_every == 0:
                self.mgr.save(step + 1, state)
                saved = step + 1
        if saved != n_steps:
            self.mgr.save(n_steps, state, blocking=True)
        else:
            self.mgr.wait()  # make the last periodic save durable
        return state
