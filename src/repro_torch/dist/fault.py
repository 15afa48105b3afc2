"""Host-side fault tolerance for the offline serving drain.

Port of the ``WorkQueue`` half of `repro.dist.fault` (stdlib only).  The
serving driver treats work as *stateless quanta* (read batches), so
fault tolerance is a lease-based scheduler: a claim grants a lease for
``lease_s`` seconds; if the worker neither completes nor renews in time,
the item becomes claimable again (work *stealing*: a straggling or dead
worker's item is simply re-issued).  Completion is idempotent, so a
stolen item finishing twice is harmless — batch results are keyed by
item id.
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
