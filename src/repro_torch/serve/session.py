"""Client session + synthetic open-loop load generator.

``Session`` is the thin client surface over the engine: ``submit()``
tags each read with caller metadata (e.g. the global read id) and
``drain()`` returns ``(meta, ServeResult)`` pairs in submission order —
the shape both serving modes of `launch/serve_genomics.py` consume.

``poisson_load`` replays a read list through a session under *open-loop*
Poisson arrivals (exponential inter-arrival gaps at ``rate_rps``,
submitted on schedule regardless of completion — the arrival process of
an online mapping service, and the regime where micro-batching policy
actually matters: closed-loop benchmarks never build queues).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np

from .engine import ServeEngine, ServeResult


class Session:
    """Order-preserving submit/drain wrapper around a ``ServeEngine``."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self._pending: list[tuple[object, object]] = []  # (meta, future)

    def submit(self, read: np.ndarray, meta=None):
        fut = self.engine.submit(read)
        self._pending.append((meta, fut))
        return fut

    def drain(self) -> list[tuple[object, ServeResult]]:
        """Gather every outstanding result, in submission order."""
        out = [(meta, fut.result()) for meta, fut in self._pending]
        self._pending.clear()
        return out


class LoadReport(NamedTuple):
    results: list  # [(meta, ServeResult)] in submission order
    elapsed_s: float
    reads_per_s: float
    p50_ms: float
    p99_ms: float
    metrics: dict  # engine metrics snapshot at end of run


def poisson_load(engine: ServeEngine, reads: Sequence[np.ndarray], *,
                 rate_rps: float, seed: int = 0,
                 metas: Sequence | None = None) -> LoadReport:
    """Open-loop Poisson replay of ``reads`` at ``rate_rps`` arrivals/s."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=len(reads))
    sess = Session(engine)
    t0 = time.monotonic()
    next_t = t0
    for i, read in enumerate(reads):
        next_t += gaps[i]
        delay = next_t - time.monotonic()
        if delay > 0:  # open loop: never waits on completions, only the clock
            time.sleep(delay)
        sess.submit(read, metas[i] if metas is not None else i)
    results = sess.drain()
    elapsed = time.monotonic() - t0
    lat = sorted(r.latency_s for _, r in results)

    def q(p: float) -> float:
        return lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3 if lat else 0.0

    return LoadReport(
        results=results, elapsed_s=elapsed,
        reads_per_s=len(reads) / elapsed if elapsed else 0.0,
        p50_ms=q(0.50), p99_ms=q(0.99),
        metrics=engine.metrics.snapshot())
