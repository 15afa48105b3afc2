"""Thread-safe request tracing: spans, ring-buffer log, Perfetto export.

A `Span` is one named wall-time interval on the monotonic clock with a
parent link and free-form attributes (bucket cap, tile rung, shard id,
dc_rows, compile-vs-execute flag, …).  A `Tracer` hands them out either
scoped (``with tracer.span("flush"):`` — nesting tracked per thread),
from stamps the caller took (``tracer.begin(name, t)`` …
``tracer.end(span, t)``), or retroactively (``tracer.add(name, t0,
t1)`` — how executors report stage timings they measured themselves),
and appends finished spans to a bounded `TraceLog` ring buffer.  A
``device_span`` also times its work on a CUDA device with a pair of
events, read into the span's ``device_ms`` by ``resolve()`` once the
caller has synchronised the device.

``to_chrome()`` / ``export_chrome(path)`` export the log as Chrome
``trace_event`` JSON (the *JSON Object Format*: ``{"traceEvents":
[...]}``), loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.  Scoped spans become ``"ph": "X"`` complete events
on their thread's track; spans marked ``async_=True`` (e.g. per-request
enqueue waits, which overlap freely) become ``"b"``/``"e"`` async pairs
so they never break slice nesting; instant events become ``"ph": "i"``;
counter samples (``tracer.counter(...)``, numeric attrs only) become
``"ph": "C"`` counter tracks — Perfetto plots each attr as a series.
The log knows the offset from the monotonic clock to the epoch clock
that `torch.profiler`'s records carry (``to_epoch_ns``), so spans and a
device trace can be laid over one another.

Code that cannot be handed a tracer reads the context's current one
(`current_tracer`, `NULL_TRACER` unless a caller set one with
`using`).  `PROCESS_TRACER` is the process-wide tracer
`core.mapper.LinearMapExecutor` traces into while a torch profiler
records.

Everything is stdlib; a disabled tracer (`NULL_TRACER`) costs one
attribute check per call site.  Copied from `repro.obs.trace`.
"""
from __future__ import annotations

import contextvars
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
        """Plain-dict form (the `/trace` wire representation)."""
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
        # monotonic -> epoch clock (`torch.profiler` stamps its records on
        # the epoch clock)
        self.epoch_offset_ns = time.time_ns() - time.monotonic_ns()

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

    def to_epoch_ns(self, t: float) -> int:
        """Monotonic-clock seconds ``t`` (a span's stamp) as epoch-clock
        nanoseconds, the clock of `torch.profiler`'s records."""
        return round(t * 1e9) + self.epoch_offset_ns

    # ------------------------------------------------------------- export --
    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (Perfetto-loadable).

        ``otherData.ts0_epoch_ns`` is the epoch-clock time of ``ts`` 0: a
        profiler record stamped ``E`` ns sits at ``(E - ts0_epoch_ns) /
        1e3`` µs of this trace.
        """
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
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"ts0_epoch_ns": self.to_epoch_ns(self.t0)}}

    def export_chrome(self, path: str) -> None:
        """Write the Perfetto/Chrome ``trace_event`` JSON file."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class Tracer:
    """Span factory over one `TraceLog`; per-thread nesting for parents.

    ``span()`` opens a scoped span (context manager — the parent is
    whatever span encloses it on the same thread); ``begin()`` /
    ``end()`` open and close one on stamps the caller took;
    ``device_span()`` is a scoped span that also times its device work;
    ``add()`` records a retroactive span from timestamps measured
    elsewhere (parented to the thread's current open span); ``event()``
    records an instant.  A tracer constructed with ``enabled=False``
    turns every call into a near-free no-op — call sites never need
    their own guards, though hot loops may still check
    ``tracer.enabled`` to skip argument setup.
    """

    def __init__(self, enabled: bool = True,
                 log: TraceLog | None = None) -> None:
        self.enabled = enabled
        self.log = log if log is not None else TraceLog()
        self._ids = itertools.count(1)
        self._tl = threading.local()

    # ------------------------------------------------------------ helpers --
    def _local(self, name: str, make):
        v = getattr(self._tl, name, None)
        if v is None:
            v = make()
            setattr(self._tl, name, v)
        return v

    def _stack(self) -> list[int]:
        return self._local("stack", list)

    def _tid(self) -> str:
        t = threading.current_thread()
        return t.name or f"thread-{t.ident}"

    def current_parent(self) -> int | None:
        """Span id of this thread's innermost open span (None at top)."""
        st = self._stack()
        return st[-1] if st else None

    # ------------------------------------------------------------ surface --
    def begin(self, name: str, t: float | None = None, /, **attrs):
        """Open a span at monotonic stamp ``t`` (now if None) and make it
        the thread's innermost; close it with `end`."""
        if not self.enabled:
            return _NULL_SPAN
        s = Span(name=name, t_start=time.monotonic() if t is None else t,
                 span_id=next(self._ids), parent_id=self.current_parent(),
                 tid=self._tid(),
                 attrs={**self._local("tags", dict), **attrs})
        self._stack().append(s.span_id)
        return s

    def end(self, s, t: float | None = None) -> None:
        """Close span ``s`` at stamp ``t`` (now if None) and log it; spans
        left open inside it (an exception skipped their `end`) are
        dropped from the thread's nesting."""
        if s is _NULL_SPAN:
            return
        st = self._stack()
        while st and st.pop() != s.span_id:
            pass
        s.t_end = time.monotonic() if t is None else t
        self.log.append(s)

    @contextmanager
    def span(self, name: str, **attrs):
        """Scoped span: ``with tracer.span("flush", bucket_cap=320) as s:``."""
        s = self.begin(name, None, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    @contextmanager
    def device_span(self, name: str, device, **attrs):
        """Scoped span whose work on ``device`` is timed too: on a CUDA
        device by a pair of events around the block, read into the
        span's ``device_ms`` by the first `resolve` after the caller has
        synchronised the device; ``device_ms`` is None elsewhere.  No
        synchronisation of its own."""
        with self.span(name, **attrs) as s:
            if not self.enabled or device.type != "cuda":
                s.set(device_ms=None)
                yield s
                return
            import torch

            start = torch.cuda.Event(enable_timing=True)
            start.record()
            yield s
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self.later(s, "device_ms", lambda: start.elapsed_time(stop))

    def later(self, s, key: str, read) -> None:
        """Set ``s.attrs[key] = read()`` at this thread's next `resolve`:
        for a value the device has yet to produce."""
        if self.enabled:
            self._local("pending", list).append((s, key, read))

    def resolve(self) -> None:
        """Read every value `later` deferred on this thread; call it once
        the device has finished their work (after a synchronise)."""
        if not self.enabled:
            return
        pending = self._local("pending", list)
        for s, key, read in pending:
            s.attrs[key] = read()
        pending.clear()

    @contextmanager
    def tagged(self, **attrs):
        """Every span this thread opens in the block (`begin`, `span`,
        `device_span`) carries ``attrs``."""
        if not self.enabled:
            yield
            return
        prev = self._local("tags", dict)
        self._tl.tags = {**prev, **attrs}
        try:
            yield
        finally:
            self._tl.tags = prev

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
# what `core.mapper.LinearMapExecutor` traces into while a torch profiler
# records (and no tracer was handed to it)
PROCESS_TRACER = Tracer()

_current: contextvars.ContextVar[Tracer] = contextvars.ContextVar(
    "repro_torch_tracer", default=NULL_TRACER)


def current_tracer() -> Tracer:
    """The tracer code in this context traces into (`NULL_TRACER` unless a
    caller set one with `using`)."""
    return _current.get()


@contextmanager
def using(tracer: Tracer):
    """Make ``tracer`` the current tracer of this context in the block."""
    token = _current.set(tracer)
    try:
        yield tracer
    finally:
        _current.reset(token)


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
