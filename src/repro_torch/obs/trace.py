"""Thread-safe request tracing: spans, ring-buffer log, Perfetto export.

A `Span` is one named wall-time interval on the monotonic clock with a
parent link and free-form attributes (bucket cap, tile rung, shard id,
dc_rows, compile-vs-execute flag, …).  A `Tracer` hands them out either
scoped (``with tracer.span("flush"):`` — nesting tracked per thread) or
retroactively (``tracer.add(name, t0, t1)`` — how executors report
stage timings they measured themselves), and appends finished spans to
a bounded `TraceLog` ring buffer.

The log exports two ways:

* ``to_chrome()`` / ``export_chrome(path)`` — Chrome ``trace_event``
  JSON (the *JSON Object Format*: ``{"traceEvents": [...]}``), loadable
  in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
  Scoped spans become ``"ph": "X"`` complete events on their thread's
  track; spans marked ``async_=True`` (e.g. per-request enqueue waits,
  which overlap freely) become ``"b"``/``"e"`` async pairs so they
  never break slice nesting; instant events become ``"ph": "i"``;
  counter samples (``tracer.counter(...)``, numeric attrs only) become
  ``"ph": "C"`` counter tracks — Perfetto plots each attr as a series.
* ``export_jsonl(path)`` — one structured JSON object per line (name,
  t_start/t_end, duration, parent, tid, attrs), the machine-readable
  sink for offline analysis.

Everything is stdlib; a disabled tracer (`NULL_TRACER`) costs one
attribute check per call site.  Copied from `repro.obs.trace`.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    """One named monotonic-clock interval with parent link + attributes."""

    name: str
    t_start: float
    t_end: float = 0.0
    span_id: int = 0
    parent_id: int | None = None
    tid: str = "main"
    kind: str = "span"  # "span" | "instant" | "async" | "counter"
    attrs: dict = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        """Wall-clock seconds spanned (0.0 for unfinished/instant spans)."""
        return max(self.t_end - self.t_start, 0.0)

    def set(self, **attrs) -> None:
        """Attach attributes to a live span (inside its ``with`` block)."""
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        """Plain-dict form (the JSONL/`/trace` wire representation)."""
        return {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "tid": self.tid,
            "kind": self.kind, "t_start": self.t_start,
            "t_end": self.t_end, "duration_ms": self.duration_s * 1e3,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """Inert stand-in yielded by a disabled tracer's ``span()``."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        """Accept and discard attributes (mirrors `Span.set`)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class TraceLog:
    """Bounded ring buffer of finished spans with JSON exporters."""

    def __init__(self, max_spans: int = 65536) -> None:
        self._buf: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self.dropped = 0  # spans evicted by the ring bound
        self.t0 = time.monotonic()  # export time base

    @property
    def max_spans(self) -> int:
        """Ring capacity (the clamp bound for ``/trace?n=``)."""
        return self._buf.maxlen or 0

    def append(self, span: Span) -> None:
        """Push one finished span (evicts the oldest when full)."""
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    def spans(self) -> list[Span]:
        """Snapshot of the buffered spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def last(self, n: int) -> list[dict]:
        """The most recent ``n`` spans as plain dicts (newest last)."""
        with self._lock:
            tail = list(self._buf)[-max(n, 0):]
        return [s.to_dict() for s in tail]

    def clear(self) -> None:
        """Drop every buffered span and reset the dropped counter."""
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # ------------------------------------------------------------- export --
    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        events: list[dict] = []
        tids: dict[str, int] = {}

        def tid_of(label: str) -> int:
            i = tids.get(label)
            if i is None:
                i = tids[label] = len(tids) + 1
                events.append({"name": "thread_name", "ph": "M", "pid": 0,
                               "tid": i, "args": {"name": label}})
            return i

        for s in self.spans():
            ts = (s.t_start - self.t0) * 1e6
            base = {"name": s.name, "pid": 0, "tid": tid_of(s.tid),
                    "cat": "serve", "ts": ts}
            args = {k: v for k, v in s.attrs.items()}
            if s.kind == "instant":
                events.append({**base, "ph": "i", "s": "t", "args": args})
            elif s.kind == "counter":
                events.append({**base, "ph": "C", "args": args})
            elif s.kind == "async":
                ident = f"0x{s.span_id:x}"
                events.append({**base, "ph": "b", "id": ident, "args": args})
                events.append({**base, "ph": "e", "id": ident,
                               "ts": (s.t_end - self.t0) * 1e6, "args": {}})
            else:
                events.append({**base, "ph": "X", "args": args,
                               "dur": max((s.t_end - s.t_start) * 1e6, 0.0)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        """Write the Perfetto/Chrome ``trace_event`` JSON file."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def export_jsonl(self, path: str) -> None:
        """Write one structured JSON object per span, oldest first."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps(s.to_dict()) + "\n")


class Tracer:
    """Span factory over one `TraceLog`; per-thread nesting for parents.

    ``span()`` opens a scoped span (context manager — the parent is
    whatever span encloses it on the same thread); ``add()`` records a
    retroactive span from timestamps measured elsewhere (parented to
    the thread's current open span); ``event()`` records an instant.
    A tracer constructed with ``enabled=False`` turns every call into a
    near-free no-op — call sites never need their own guards, though
    hot loops may still check ``tracer.enabled`` to skip argument
    setup.
    """

    def __init__(self, enabled: bool = True,
                 log: TraceLog | None = None) -> None:
        self.enabled = enabled
        self.log = log if log is not None else TraceLog()
        self._ids = itertools.count(1)
        self._tl = threading.local()

    # ------------------------------------------------------------ helpers --
    def _stack(self) -> list[int]:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
        return st

    def _tid(self) -> str:
        t = threading.current_thread()
        return t.name or f"thread-{t.ident}"

    def current_parent(self) -> int | None:
        """Span id of this thread's innermost open span (None at top)."""
        st = self._stack()
        return st[-1] if st else None

    # ------------------------------------------------------------ surface --
    @contextmanager
    def span(self, name: str, **attrs):
        """Scoped span: ``with tracer.span("flush", bucket_cap=320) as s:``."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        s = Span(name=name, t_start=time.monotonic(),
                 span_id=next(self._ids), parent_id=self.current_parent(),
                 tid=self._tid(), attrs=attrs)
        st = self._stack()
        st.append(s.span_id)
        try:
            yield s
        finally:
            st.pop()
            s.t_end = time.monotonic()
            self.log.append(s)

    def add(self, name: str, t_start: float, t_end: float, *,
            tid: str | None = None, parent: int | None = None,
            async_: bool = False, **attrs) -> None:
        """Retroactive span from timestamps already on the monotonic clock."""
        if not self.enabled:
            return
        self.log.append(Span(
            name=name, t_start=t_start, t_end=t_end,
            span_id=next(self._ids),
            parent_id=self.current_parent() if parent is None else parent,
            tid=tid if tid is not None else self._tid(),
            kind="async" if async_ else "span", attrs=attrs))

    def event(self, name: str, **attrs) -> None:
        """Instant event (zero-duration span, ``ph: "i"`` in the export)."""
        if not self.enabled:
            return
        t = time.monotonic()
        self.log.append(Span(
            name=name, t_start=t, t_end=t, span_id=next(self._ids),
            parent_id=self.current_parent(), tid=self._tid(),
            kind="instant", attrs=attrs))

    def counter(self, name: str, **values) -> None:
        """Counter sample (``ph: "C"``): each numeric kwarg is a series.

        Samples with the same ``name`` form one Perfetto counter track;
        pass cumulative values for monotone plots (the roofline manager
        sends running op/byte totals per kernel).
        """
        if not self.enabled:
            return
        t = time.monotonic()
        self.log.append(Span(
            name=name, t_start=t, t_end=t, span_id=next(self._ids),
            parent_id=None, tid=self._tid(), kind="counter", attrs=values))


NULL_TRACER = Tracer(enabled=False)


class StageTimer:
    """Per-call stage clock executors use to fill their ``last_times``.

    Records ``(stage, t_start, t_end, attrs)`` tuples — the engine (or a
    benchmark) replays them into a `Tracer` via ``add()``.  Callers must
    block on the stage's device work inside the ``stage()`` scope
    (``torch.cuda.synchronize``) or the interval only measures the
    asynchronous launches.
    """

    def __init__(self) -> None:
        self.times: list[tuple[str, float, float, dict]] = []

    @contextmanager
    def stage(self, name: str, **attrs):
        """Scope one stage: appends ``(name, t0, t1, attrs)`` on exit."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.times.append((name, t0, time.monotonic(), attrs))
