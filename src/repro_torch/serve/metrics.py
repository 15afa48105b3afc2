"""Serving metrics: counters, gauges, log-bucketed histograms, exposition.

Thread-safe, dependency-free observability for the micro-batching engine
(DESIGN.md §8).  The engine records queue depth, batch occupancy, padded
bases (the waste length bucketing removes), end-to-end latency and the
seconds spent in each mapper stage (``stage_<name>_s``); `render()` emits
a Prometheus-style text page and `snapshot()` a plain dict.  Copied from
`repro.serve.metrics`.
"""
from __future__ import annotations

import bisect
import threading


class Counter:
    """Monotonic counter (float increments allowed, e.g. padded bases)."""

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins instantaneous value (e.g. queue depth)."""

    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Log-spaced bucket histogram with interpolated quantiles.

    Buckets span ``[lo, hi]`` multiplicatively (default 1 µs .. 100 s for
    latencies); observations are clamped into range, so quantiles stay
    defined even for outliers.  Quantile estimates interpolate within the
    winning bucket — coarse but monotone, and plenty for p50/p99 serving
    dashboards.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 100.0,
                 n_buckets: int = 64) -> None:
        self._lo, self._hi = float(lo), float(hi)
        self._bounds = [
            lo * (hi / lo) ** (i / (n_buckets - 1)) for i in range(n_buckets)
        ]
        self._counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        x = min(max(float(v), self._lo), self._hi)
        # first bucket whose upper bound holds x: bucket j covers
        # (bounds[j-1], bounds[j]], so an observation landing exactly on
        # a bound belongs to that bound's bucket — bisect_left is exact
        # where the old log-space arithmetic could round across the edge
        j = min(bisect.bisect_left(self._bounds, x), len(self._bounds) - 1)
        with self._lock:
            self._counts[j] += 1
            self.count += 1
            self.sum += float(v)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for j, c in enumerate(self._counts):
            if c and seen + c >= target:
                lo = self._bounds[j - 1] if j else self._lo
                frac = (target - seen) / c
                return lo + frac * (self._bounds[j] - lo)
            seen += c
        return self._bounds[-1]

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def stats(self) -> dict:
        """count/sum/mean/p50/p99 read under one lock acquisition —
        a torn read of (count, sum) mid-``observe`` cannot happen."""
        with self._lock:
            count, total = self.count, self.sum
            p50 = self._quantile_locked(0.50)
            p99 = self._quantile_locked(0.99)
        return {"count": count, "sum": total,
                "mean": total / count if count else 0.0,
                "p50": p50, "p99": p99}

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0


class Metrics:
    """Named-instrument registry shared by engine, cache, and session."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kw) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(**kw)
            return self._hists[name]

    def snapshot(self) -> dict:
        """Flat dict of every instrument (histograms → count/mean/p50/p99)."""
        with self._lock:  # registries may grow mid-scrape (lazy instruments)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        out: dict[str, float] = {}
        for n, c in counters.items():
            out[n] = c.value
        for n, g in gauges.items():
            out[n] = g.value
        for n, h in hists.items():
            st = h.stats()  # count/sum/quantiles under the histogram's lock
            out[f"{n}_count"] = st["count"]
            out[f"{n}_mean"] = st["mean"]
            out[f"{n}_p50"] = st["p50"]
            out[f"{n}_p99"] = st["p99"]
        return out

    def render(self) -> str:
        """Prometheus-style text exposition (one ``name value`` per line)."""
        lines = []
        for n, v in sorted(self.snapshot().items()):
            lines.append(f"{n} {v:.6g}")
        return "\n".join(lines) + "\n"
