"""LRU result cache keyed on (read-bytes digest, index-epoch token).

Online mappers see heavy key reuse (duplicate reads from PCR/optical
duplicates, resubmitted requests, popular amplicons), and a mapping is a
pure function of (read bases, reference index) — so results are cacheable
as long as the key pins *which* reference index produced them.  The index
half of the key is an opaque hashable **epoch token**: the engine passes
the ``EpochedIndex`` epoch (`core/minimizer_index.py`) — refreshing the
reference bumps it, which atomically invalidates every cached result
without touching the cache (stale epochs simply never match and age out
of the LRU).  Copied from `repro.serve.cache`.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Hashable

import numpy as np


def read_digest(read: np.ndarray) -> bytes:
    """Stable digest of the read's bases (dtype/shape-normalized)."""
    return hashlib.blake2b(
        np.ascontiguousarray(read, dtype=np.int8).tobytes(), digest_size=16
    ).digest()


class ResultCache:
    """Thread-safe LRU of mapping results.

    ``capacity == 0`` disables caching (get always misses, put drops).
    Hit/miss counts feed the engine's cache-hit-rate metric.
    """

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._d: OrderedDict[tuple[bytes, Hashable], object] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, read: np.ndarray, epoch: Hashable, *,
            digest: bytes | None = None):
        """Cached result for (read, epoch token), or None; counts hit/miss."""
        if self.capacity == 0:  # disabled: skip the digest on the hot path
            with self._lock:
                self.misses += 1
            return None
        key = (digest or read_digest(read), epoch)
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, read: np.ndarray, epoch: Hashable, value, *,
            digest: bytes | None = None) -> None:
        """Insert a result under (read, epoch token), evicting LRU overflow."""
        if self.capacity == 0:
            return
        key = (digest or read_digest(read), epoch)
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def evict_epochs_below(self, epoch: int) -> int:
        """Eagerly drop entries from pre-``epoch`` scalar-epoch indexes.

        Optional — stale entries are unreachable either way — but frees
        capacity immediately after a reference refresh.  Only entries
        whose token is a plain int are compared (sharded epoch-vector
        tokens have no total order; they age out of the LRU instead).
        """
        with self._lock:
            stale = [k for k in self._d
                     if isinstance(k[1], int) and k[1] < epoch]
            for k in stale:
                del self._d[k]
            return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def hit_rate(self) -> float:
        """Fraction of gets served from cache (0.0 before any get)."""
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
