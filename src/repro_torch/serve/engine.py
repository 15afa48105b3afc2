"""Async micro-batching engine for online read-mapping (DESIGN.md §8).

Port of `repro.serve.engine` for one device, serving the linear and the
graph workload.  Reads arrive continuously via ``submit() -> Future``;
the engine admits them into per-bucket queues and a background worker
flushes a bucket when it reaches ``max_batch`` *or* its oldest read has
waited ``max_delay_s``.

* **Length buckets** — reads are routed to the smallest rung of a
  length-bucket ladder (default 160/320/640/1280) that holds them, so a
  150 bp read does not pay long-read padding; `metrics` tracks the
  padded bases actually paid.
* **Executor cache** — one `mapper.LinearMapExecutor` per bucket cap
  (linear workload), or one `graph.mapper.GraphMapExecutor` per bucket
  cap and tile stride (graph workload); partial flushes are padded up to
  ``max_batch`` rows so every flush of a bucket has one shape.

Results are memoized in an LRU keyed on ``(read digest, index epoch)``
(`cache.py`); refreshing the reference bumps the epoch.  The offline
WorkQueue path and the online Poisson path of `launch/serve_genomics.py`
both sit on the same ``submit()``/``drain()`` surface, which is what
makes their PAF/GAF outputs bit-identical.

The engine runs on the device of its index: the worker thread moves each
flush there and every kernel wrapper launches on that tensor's device,
so nothing depends on the thread's current device.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch import align as align_dispatch
from repro_torch.core import mapper
from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.minimizer_index import EpochedIndex, ReferenceIndex
from repro_torch.genomics import encode
from repro_torch.graph.index import EpochedGraphIndex, GraphIndex
from repro_torch.graph.mapper import GraphMapExecutor, graph_backend_name
from repro_torch.obs.trace import NULL_TRACER, Tracer

from .cache import ResultCache, read_digest
from .metrics import Metrics


@dataclass(frozen=True)
class EngineConfig:
    """Micro-batcher policy + the static half of the mapper signature.

    ``buckets`` are pattern caps (multiples of 32 for the bitvector
    layout); reads longer than the top rung are trimmed to it, matching
    `encode.batch_reads`.  ``filter_bits`` is clamped per bucket to the
    bucket cap.  ``align_backend`` names a `repro_torch.align` registry
    entry ("auto" resolves per device at engine construction).

    ``workload`` selects what a bucket executor runs: ``"linear"``
    (`core/mapper` against an `EpochedIndex`) or ``"graph"``
    (`graph/mapper` against an `EpochedGraphIndex`, results carrying the
    node path for GAF); linear backend names resolve to their graph
    twins under the graph workload (``torch`` → ``graph_torch``,
    ``cuda_dc`` → ``graph_cuda``).  ``graph_prefilter`` toggles the
    graph mapper's q-gram tile screen (bitwise-neutral on output).
    """

    buckets: tuple[int, ...] = (160, 320, 640, 1280)
    max_batch: int = 32
    max_delay_s: float = 0.005
    genasm: GenASMConfig = GenASMConfig()
    align_backend: str = "auto"
    workload: str = "linear"
    filter_bits: int = 128
    filter_k: int = 12
    max_candidates: int = 4
    # defaults match build_reference_index/build_epoched_index and
    # mapper.map_batch, so all-defaults construction is consistent
    minimizer_w: int = 10
    minimizer_k: int = 15
    cache_capacity: int = 4096  # 0 disables the result cache
    # graph workload: q-gram tile screen before the BitAlign filter
    graph_prefilter: bool = True

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("need at least one bucket cap")
        if any(c % 32 or c <= 0 for c in self.buckets):
            raise ValueError(f"bucket caps must be positive multiples of 32, "
                             f"got {self.buckets}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.workload not in ("linear", "graph"):
            raise ValueError(f"workload must be 'linear' or 'graph', got "
                             f"{self.workload!r}")
        object.__setattr__(self, "buckets", tuple(sorted(set(self.buckets))))

    def bucket_for(self, length: int) -> int:
        """Smallest rung holding ``length`` (top rung trims longer reads)."""
        for cap in self.buckets:
            if length <= cap:
                return cap
        return self.buckets[-1]


class ServeResult(NamedTuple):
    """Per-read mapping outcome delivered through the submit() future."""

    position: int  # reference start (-1 if unmapped)
    distance: int  # edit distance (-1 if unmapped)
    ops: np.ndarray  # packed CIGAR ops
    n_ops: int
    read_len: int
    bucket_cap: int
    cached: bool
    latency_s: float
    path: np.ndarray | None = None  # graph workload: node ids per op (-1=I)


@dataclass
class _Request:
    read: np.ndarray
    length: int
    bucket: int
    future: Future
    digest: bytes | None = None  # computed once in submit(), reused by put()
    t_submit: float = field(default_factory=time.monotonic)


class ServeEngine:
    """Admission queue + per-bucket micro-batcher over the linear or the
    graph mapper."""

    def __init__(self, index, config: EngineConfig = EngineConfig(),
                 tracer: Tracer | None = None):
        self.config = config
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if config.workload == "graph":
            if isinstance(index, GraphIndex):
                index = EpochedGraphIndex(index)
            elif not isinstance(index, EpochedGraphIndex):
                raise TypeError(
                    f"graph workload needs a GraphIndex/EpochedGraphIndex, "
                    f"got {type(index).__name__}")
        elif isinstance(index, ReferenceIndex):
            # a bare ReferenceIndex carries no build params, so the engine
            # assumes it was built with config.minimizer_w/k
            index = EpochedIndex(index, w=config.minimizer_w,
                                 k=config.minimizer_k)
        elif not isinstance(index, EpochedIndex):
            raise TypeError(
                f"linear workload needs a ReferenceIndex/EpochedIndex, got "
                f"{type(index).__name__}")
        if (index._build_kw["w"], index._build_kw["k"]) != \
                (config.minimizer_w, config.minimizer_k):
            raise ValueError(
                f"index built with minimizer w={index._build_kw['w']}/"
                f"k={index._build_kw['k']} but engine seeds with "
                f"w={config.minimizer_w}/k={config.minimizer_k}; hashes "
                f"would never match")
        self.index = index
        self.device = index.index.device
        # resolve "auto" once: every flush uses the same concrete backend
        # for the engine's whole lifetime
        if config.workload == "graph":
            self.align_backend = graph_backend_name(config.align_backend,
                                                    self.device)
        else:
            self.align_backend = align_dispatch.resolve_backend(
                config.align_backend, self.device).name
        self.metrics = Metrics()
        self.cache = ResultCache(config.cache_capacity)
        self._queues: dict[int, list[_Request]] = {c: [] for c in config.buckets}
        self._executors: dict[tuple, object] = {}
        self._cv = threading.Condition()
        self._inflight = 0
        self._closed = False
        self._error: BaseException | None = None
        self._worker = threading.Thread(
            target=self._run, name="serve-engine", daemon=True)
        self._worker.start()

    # ----------------------------------------------------------- client API --
    def submit(self, read: np.ndarray) -> Future:
        """Admit one read; the future resolves to a ``ServeResult``."""
        read = np.ascontiguousarray(read, dtype=np.int8)
        fut: Future = Future()
        t0 = time.monotonic()
        with self._cv:  # a dead engine answers nothing, not even cache hits
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._error is not None:
                raise RuntimeError("engine worker died") from self._error
        _, epoch = self.index.current()
        digest = read_digest(read) if self.cache.capacity else None
        hit = self.cache.get(read, epoch, digest=digest)
        self.metrics.counter("reads_submitted").inc()
        if hit is not None:
            fut.set_result(hit._replace(
                cached=True, ops=hit.ops.copy(),  # callers own their arrays
                path=None if hit.path is None else hit.path.copy(),
                latency_s=time.monotonic() - t0))
            return fut
        req = _Request(read=read, length=len(read),
                       bucket=self.config.bucket_for(len(read)), future=fut,
                       digest=digest, t_submit=t0)
        with self._cv:
            # re-checked under the enqueue lock: a request can never land
            # after the worker has observed "closed and empty" and left
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._error is not None:
                raise RuntimeError("engine worker died") from self._error
            self._queues[req.bucket].append(req)
            self._inflight += 1
            self.metrics.gauge("queue_depth").set(
                sum(len(q) for q in self._queues.values()))
            self._cv.notify_all()
        if self.tracer.enabled:
            self.tracer.event("submit", bucket=req.bucket, length=req.length)
        return fut

    def map_all(self, reads: Sequence[np.ndarray]) -> list[ServeResult]:
        """Submit a read list and gather results in submission order."""
        futs = [self.submit(r) for r in reads]
        return [f.result() for f in futs]

    def drain(self, timeout: float | None = None) -> None:
        """Block until every admitted read has a result."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0 and self._error is None:
                wait = (None if deadline is None
                        else max(deadline - time.monotonic(), 0.0))
                if wait == 0.0:
                    raise TimeoutError(
                        f"drain timed out with {self._inflight} in flight")
                self._cv.wait(timeout=0.05 if wait is None else min(wait, 0.05))
        if self._error is not None:
            raise RuntimeError("engine worker died") from self._error

    def close(self) -> None:
        """Drain, then stop the worker (idempotent, even after worker death)."""
        with self._cv:
            if self._closed:
                return
        try:
            self.drain()
        except RuntimeError:
            pass  # worker already dead: nothing left to drain, still shut down
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------- executor cache ----
    def _executor(self, cap: int, tile_stride: int | None = None):
        """The bucket's mapper executor, built lazily.  The config and the
        backend are fixed for the engine's lifetime, so the key is the cap
        and, for the graph workload, the index's tile stride *at flush
        time* — a refresh() that re-tiles the graph gets a fresh
        executor."""
        key = (cap, tile_stride)
        fn = self._executors.get(key)
        if fn is None:
            c = self.config
            kw = dict(cfg=c.genasm, p_cap=cap,
                      filter_bits=min(c.filter_bits, cap),
                      filter_k=c.filter_k, max_candidates=c.max_candidates,
                      minimizer_w=c.minimizer_w, minimizer_k=c.minimizer_k,
                      backend=self.align_backend)
            if c.workload == "graph":
                fn = GraphMapExecutor(tile_stride=tile_stride,
                                      prefilter=c.graph_prefilter, **kw)
            else:
                fn = mapper.LinearMapExecutor(**kw)
            self._executors[key] = fn
        return fn

    @property
    def n_executors(self) -> int:
        """Number of bucket executors currently cached."""
        return len(self._executors)

    # ------------------------------------------------------------- worker ----
    def _flush_candidate(self, now: float) -> tuple[int, list[_Request]] | None:
        """Pick a bucket to flush: the most-overdue one, else any full one.

        Deadline beats fullness, so sustained traffic keeping one bucket
        full cannot starve another bucket's ``max_delay_s`` bound.  Caller
        holds the lock.  Returns (cap, requests) with the requests removed
        from the queue, or None if no bucket is ready.
        """
        overdue_cap, overdue_age = None, 0.0
        for cap, q in self._queues.items():
            if not q:
                continue
            age = now - q[0].t_submit
            if age >= self.config.max_delay_s and age >= overdue_age:
                overdue_cap, overdue_age = cap, age
        if overdue_cap is None:
            full = [c for c, q in self._queues.items()
                    if len(q) >= self.config.max_batch]
            if not full:
                return None
            overdue_cap = full[0]
        q = self._queues[overdue_cap]
        batch, self._queues[overdue_cap] = q[:self.config.max_batch], \
            q[self.config.max_batch:]
        return overdue_cap, batch

    def _next_deadline(self, now: float) -> float | None:
        ages = [now - q[0].t_submit for q in self._queues.values() if q]
        if not ages:
            return None
        return max(self.config.max_delay_s - max(ages), 0.0)

    def _run(self) -> None:
        picked: tuple[int, list[_Request]] | None = None
        try:
            while True:
                with self._cv:
                    while True:
                        if self._closed and not any(self._queues.values()):
                            return
                        now = time.monotonic()
                        picked = self._flush_candidate(now)
                        if picked is not None:
                            break
                        wait = self._next_deadline(now)
                        self._cv.wait(timeout=0.05 if wait is None
                                      else min(wait, 0.05))
                    self.metrics.gauge("queue_depth").set(
                        sum(len(q) for q in self._queues.values()))
                self._execute(*picked)  # compute outside the lock
                picked = None
        except BaseException as e:  # noqa: BLE001 — worker must not die silently
            with self._cv:
                self._error = e
                failed = [r for q in self._queues.values() for r in q]
                if picked is not None:  # the batch mid-execute fails too
                    failed += picked[1]
                for q in self._queues.values():
                    q.clear()
                for r in failed:
                    if not r.future.done():
                        r.future.set_exception(e)
                self._inflight = 0
                self._cv.notify_all()

    def _deliver(self, cap: int, reqs: list[_Request], epoch, lens, res,
                 stats) -> None:
        """Flush tail: metrics, cache, futures."""
        c, tr, m = self.config, self.tracer, self.metrics
        pos = res.position.cpu().numpy()
        dist = res.distance.cpu().numpy()
        ops = res.ops.cpu().numpy()
        n_ops = res.n_ops.cpu().numpy()
        paths = res.path.cpu().numpy() if c.workload == "graph" else None

        m.counter("batches_flushed").inc()
        m.counter(f"batches_flushed_cap{cap}").inc()
        m.histogram("batch_occupancy", lo=1e-3, hi=1.0).observe(
            len(reqs) / c.max_batch)
        real = int(sum(min(r.length, cap) for r in reqs))
        m.counter("bases_useful").inc(real)
        m.counter("bases_padded_read").inc(len(reqs) * cap - real)
        m.counter("bases_padded_slot").inc((c.max_batch - len(reqs)) * cap)
        if stats:  # graph executors: tile-screen / DC-occupancy
            for name, v in stats.items():
                m.counter(f"graph_{name}").inc(int(v))

        with tr.span("emit", bucket_cap=cap):
            done = time.monotonic()
            results = []
            for i, r in enumerate(reqs):
                out = ServeResult(
                    position=int(pos[i]), distance=int(dist[i]),
                    ops=ops[i].copy(), n_ops=int(n_ops[i]),
                    read_len=int(lens[i]), bucket_cap=cap,
                    cached=False, latency_s=done - r.t_submit,
                    path=None if paths is None else paths[i].copy())
                self.cache.put(r.read, epoch, out, digest=r.digest)
                m.histogram("latency_s").observe(out.latency_s)
                results.append(out)
            # resolve futures before releasing drain(): a drained
            # engine has every result observable, not merely computed
            for r, out in zip(reqs, results):
                r.future.set_result(out)

    def _execute(self, cap: int, reqs: list[_Request]) -> None:
        c, tr, m = self.config, self.tracer, self.metrics
        t_flush = time.monotonic()
        with tr.span("flush", bucket_cap=cap, batch=len(reqs),
                     workload=c.workload):
            if tr.enabled:
                # queue waits overlap the previous flush's compute, so
                # they export as async spans (outside the slice nesting)
                for r in reqs:
                    tr.add("enqueue_wait", r.t_submit, t_flush,
                           bucket_cap=cap, async_=True)
            index, epoch = self.index.current()
            if c.workload == "graph":
                payload = index.arrays
                fn = self._executor(cap, index.tile_stride)
            else:
                payload = index
                fn = self._executor(cap)
            with tr.span("encode", bucket_cap=cap):
                arr, lens = encode.batch_reads(
                    [r.read for r in reqs]
                    + [np.zeros(0, np.int8)] * (c.max_batch - len(reqs)),
                    cap)
            res = fn(payload, arr, lens)
            # replay the executor's per-stage windows as child spans of
            # this flush, and sum them per stage in the metrics
            for name, t0, t1, attrs in fn.last_times:
                tr.add(name, t0, t1, bucket_cap=cap, **attrs)
                m.counter(f"stage_{name}_s").inc(t1 - t0)
            self._deliver(cap, reqs, epoch, lens, res,
                          getattr(fn, "last_stats", None))
        with self._cv:
            self._inflight -= len(reqs)
            self._cv.notify_all()
