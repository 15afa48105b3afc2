"""Async micro-batching engine for online read-mapping (DESIGN.md §8).

Port of `repro.serve.engine`, serving the linear and the graph workload
on one device or, with ``num_shards > 1``, through `repro_torch.shard`.
Reads arrive continuously via ``submit() -> Future``; the engine admits
them into per-bucket queues and a background worker flushes a bucket
when it reaches ``max_batch`` *or* its oldest read has waited
``max_delay_s``.

* **Length buckets** — reads are routed to the smallest rung of a
  length-bucket ladder (default 160/320/640/1280) that holds them, so a
  150 bp read does not pay long-read padding; `metrics` tracks the
  padded bases actually paid.
* **Executor cache** — one `mapper.LinearMapExecutor` per bucket cap
  (linear workload), or one `graph.mapper.GraphMapExecutor` per bucket
  cap and tile stride (graph workload); partial flushes are padded up to
  ``max_batch`` rows so every flush of a bucket has one shape.

* **Sharded serving** — with ``num_shards > 1`` the engine wraps the
  index into its epoch-vector-stamped sharded form and the bucket
  executors become `repro_torch.shard` scatter/merge/align pipelines,
  placed on the engine's ``shard_devices``; output is byte-identical.
  ``pipelined`` dispatches each flush without waiting for it and
  finishes it after the next one is dispatched (one batch in flight).

* **Observability** — an optional `Tracer` gets a ``flush`` span per
  flush with the executor's stage windows replayed as its children;
  an optional `repro_torch.obs.RooflineManager` gets each linear
  flush's align interval and the site's analytic kernel counters.

Results are memoized in an LRU keyed on ``(read digest, index epoch
token)`` (`cache.py`) — a scalar epoch for a single-device index, the
``(layout, epoch vector)`` token for a sharded one; refreshing the
reference bumps it.  The offline WorkQueue path and the online Poisson
path of `launch/serve_genomics.py` both sit on the same
``submit()``/``drain()`` surface, which is what makes their PAF/GAF
outputs bit-identical.

The engine runs on the device of its index (the first shard device when
sharded): the worker thread moves each flush there and every kernel
wrapper launches on that tensor's device, so nothing depends on the
thread's current device.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch import align as align_dispatch
from repro_torch import shard
from repro_torch.core import mapper
from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.minimizer_index import EpochedIndex, ReferenceIndex
from repro_torch.genomics import encode
from repro_torch.graph.index import EpochedGraphIndex, GraphIndex
from repro_torch.graph.mapper import GraphMapExecutor, graph_backend_name
from repro_torch.obs.roofline import RooflineManager
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

    ``num_shards > 1`` serves through `repro_torch.shard`;
    ``shard_candidates`` is each shard's per-read candidate budget (None
    = ``max_candidates``, which keeps output independent of the shard
    count; see the `repro_torch.shard.mapper` caveat before shrinking
    it).  ``align_sharded`` cuts the align stage into per-shard blocks
    and ``pipelined`` overlaps a flush's dispatch with the previous
    flush's completion; both need ``num_shards > 1`` and leave the
    output unchanged.
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
    num_shards: int = 1
    shard_candidates: int | None = None  # None = max_candidates per shard
    # defaults match build_reference_index/build_epoched_index and
    # mapper.map_batch, so all-defaults construction is consistent
    minimizer_w: int = 10
    minimizer_k: int = 15
    cache_capacity: int = 4096  # 0 disables the result cache
    # graph workload: q-gram tile screen before the BitAlign filter
    graph_prefilter: bool = True
    # sharded serving: per-shard align blocks / one flush in flight
    align_sharded: bool = False
    pipelined: bool = False

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
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")
        if self.shard_candidates is not None and self.shard_candidates < 1:
            raise ValueError(f"shard_candidates must be >= 1, got "
                             f"{self.shard_candidates}")
        if (self.align_sharded or self.pipelined) and self.num_shards < 2:
            raise ValueError(
                "align_sharded/pipelined serve through the repro_torch.shard "
                "executors; they need num_shards > 1")
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


class _PendingFlush(NamedTuple):
    """One dispatched flush not yet finished (pipelined mode)."""

    cap: int
    reqs: list
    fn: object  # the sharded executor that dispatched it
    pending: shard.PendingBatch
    epoch: object
    lens: np.ndarray
    t_flush: float


class ServeEngine:
    """Admission queue + per-bucket micro-batcher over the linear or the
    graph mapper, on one device or sharded.

    ``shard_devices`` places the shards of a ``num_shards > 1`` engine:
    one device for all of them (the default: the index's device) or one
    device per shard (`repro_torch.shard.resolve_devices`)."""

    def __init__(self, index, config: EngineConfig = EngineConfig(),
                 metrics: Metrics | None = None,
                 tracer: Tracer | None = None,
                 roofline: RooflineManager | None = None,
                 shard_devices: Sequence | None = None):
        self.config = config
        # NULL_TRACER's span()/add()/event() are near-free no-ops, so the
        # untraced hot path stays untaxed
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # optional per-flush analytic kernel counters keyed by this
        # engine's align dispatch sites (linear workload)
        self.roofline = roofline
        if config.num_shards > 1:
            index = self._sharded_index(index, shard_devices)
        elif config.workload == "graph":
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
        if config.num_shards > 1:
            self._check_minimizer(index.index.minimizer_w,
                                  index.index.minimizer_k)
        else:
            self._check_minimizer(index._build_kw["w"], index._build_kw["k"])
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
        self.metrics = metrics if metrics is not None else Metrics()
        self.cache = ResultCache(config.cache_capacity)
        self._queues: dict[int, list[_Request]] = {c: [] for c in config.buckets}
        self._executors: dict[tuple, object] = {}
        self._cv = threading.Condition()
        self._inflight = 0
        self._pending: _PendingFlush | None = None  # pipelined: one in flight
        self._closed = False
        self._error: BaseException | None = None
        self._worker = threading.Thread(
            target=self._run, name="serve-engine", daemon=True)
        self._worker.start()

    def _check_minimizer(self, w: int, k: int) -> None:
        c = self.config
        if (w, k) != (c.minimizer_w, c.minimizer_k):
            raise ValueError(
                f"index built with minimizer w={w}/k={k} but engine seeds "
                f"with w={c.minimizer_w}/k={c.minimizer_k}; hashes would "
                f"never match")

    # ------------------------------------------------------------ sharding --
    def _shard_halo(self) -> int:
        """Smallest halo covering every bucket's mapping geometry."""
        c = self.config
        cap = max(c.buckets)
        return max(shard.DEFAULT_HALO, shard.required_halo(
            p_cap=cap, filter_bits=min(c.filter_bits, cap),
            filter_k=c.filter_k, t_cap=cap + 2 * c.genasm.w))

    def _sharded_index(self, index, devices):
        """Wrap/convert an index for ``num_shards > 1`` serving."""
        c = self.config
        graph = c.workload == "graph"
        epoched = (shard.EpochedShardedGraphIndex if graph
                   else shard.EpochedShardedIndex)
        if isinstance(index, epoched):
            esi = index
        elif isinstance(index, (shard.ShardedIndex, shard.ShardedGraphIndex)):
            raise TypeError(
                "sharded serving needs an epoched sharded index (it keeps "
                "the source for failover re-materialization); build it "
                "with shard.from_epoched / shard.from_epoched_graph")
        elif graph:
            if not isinstance(index, (GraphIndex, EpochedGraphIndex)):
                raise TypeError(
                    f"graph workload needs a GraphIndex/EpochedGraphIndex, "
                    f"got {type(index).__name__}")
            esi = shard.from_epoched_graph(index, c.num_shards,
                                           halo=self._shard_halo(),
                                           devices=devices)
        else:
            if isinstance(index, ReferenceIndex):  # assumed built with w/k
                index = EpochedIndex(index, w=c.minimizer_w, k=c.minimizer_k)
            elif not isinstance(index, EpochedIndex):
                raise TypeError(
                    f"linear workload needs a ReferenceIndex/EpochedIndex, "
                    f"got {type(index).__name__}")
            esi = shard.from_epoched(index, c.num_shards,
                                     halo=self._shard_halo(), devices=devices)
        if esi.index.num_shards != c.num_shards:
            raise ValueError(
                f"index sharded {esi.index.num_shards} ways but config "
                f"asks for num_shards={c.num_shards}")
        return esi

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
    def _executor(self, cap: int, geom=None, sharded_index=None):
        """The bucket's mapper executor, built lazily.  The config and the
        backend are fixed for the engine's lifetime, so the key is the cap
        and the index geometry *at flush time* — the graph index's tile
        stride, or a sharded index's ``layout_key`` — so a refresh() that
        re-tiles the graph or re-partitions the shards gets a fresh
        executor.  ``sharded_index`` is the snapshot the flush took from
        ``current()``."""
        key = (cap, geom)
        fn = self._executors.get(key)
        if fn is None:
            c = self.config
            common = dict(cfg=c.genasm, p_cap=cap,
                          filter_bits=min(c.filter_bits, cap),
                          filter_k=c.filter_k, backend=self.align_backend)
            shard_kw = dict(common, align_sharded=c.align_sharded,
                            shard_candidates=(c.shard_candidates
                                              or c.max_candidates))
            kw = dict(common, max_candidates=c.max_candidates,
                      minimizer_w=c.minimizer_w, minimizer_k=c.minimizer_k)
            if c.num_shards > 1 and c.workload == "graph":
                fn = shard.ShardedGraphMapExecutor(
                    sharded_index, prefilter=c.graph_prefilter, **shard_kw)
            elif c.num_shards > 1:
                fn = shard.ShardedMapExecutor(sharded_index, **shard_kw)
            elif c.workload == "graph":
                fn = GraphMapExecutor(tile_stride=geom,
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
                            action = "stop"
                            break
                        now = time.monotonic()
                        picked = self._flush_candidate(now)
                        if picked is not None:
                            action = "exec"
                            break
                        if self._pending is not None:
                            # idle queue: finish the in-flight flush rather
                            # than sit on its futures
                            action = "finish"
                            break
                        wait = self._next_deadline(now)
                        self._cv.wait(timeout=0.05 if wait is None
                                      else min(wait, 0.05))
                    self.metrics.gauge("queue_depth").set(
                        sum(len(q) for q in self._queues.values()))
                if action == "stop":
                    self._finish_pending()
                    return
                if action == "finish":
                    self._finish_pending()
                    continue
                if self.config.pipelined:  # compute outside the lock
                    self._execute_pipelined(*picked)
                else:
                    self._execute(*picked)
                picked = None
        except BaseException as e:  # noqa: BLE001 — worker must not die silently
            with self._cv:
                self._error = e
                failed = [r for q in self._queues.values() for r in q]
                if picked is not None:  # the batch mid-execute fails too
                    failed += picked[1]
                if self._pending is not None:  # and the dispatched one
                    failed += self._pending.reqs
                    self._pending = None
                for q in self._queues.values():
                    q.clear()
                for r in failed:
                    if not r.future.done():
                        r.future.set_exception(e)
                self._inflight = 0
                self._cv.notify_all()

    def _encode(self, cap: int, reqs: list[_Request]):
        """A flush's reads, padded to ``max_batch`` rows of ``cap`` bases."""
        return encode.batch_reads(
            [r.read for r in reqs]
            + [np.zeros(0, np.int8)] * (self.config.max_batch - len(reqs)),
            cap)

    def _execute_pipelined(self, cap: int, reqs: list[_Request]) -> None:
        """Dispatch a flush without waiting for it; finish the previous one.

        One batch deep: this flush's encode, scatter, merge and align are
        enqueued on the device before the previous flush's results are
        copied to the host (the sharded executors' ``start`` never
        synchronises between stages).
        """
        prev, self._pending = self._pending, None
        try:
            t_flush = time.monotonic()
            index, epoch = self.index.current()
            fn = self._executor(cap, index.layout_key, sharded_index=index)
            arr, lens = self._encode(cap, reqs)
            with self._device_work():
                pending = fn.start(index.parts, arr, lens, timed=False)
            self._pending = _PendingFlush(cap, reqs, fn, pending, epoch,
                                          lens, t_flush)
        except BaseException:
            self._pending = prev  # the worker's handler fails prev too
            raise
        if prev is not None:
            self._finish_flush(prev)

    def _finish_pending(self) -> None:
        prev, self._pending = self._pending, None
        if prev is not None:
            self._finish_flush(prev)

    def _finish_flush(self, state: _PendingFlush) -> None:
        """Wait for a dispatched flush and deliver its results."""
        c, tr = self.config, self.tracer
        cap, reqs = state.cap, state.reqs
        try:
            with self._device_work(), tr.span(
                    "flush", bucket_cap=cap, batch=len(reqs),
                    workload=c.workload, shards=c.num_shards, pipelined=True):
                if tr.enabled:
                    for r in reqs:
                        tr.add("enqueue_wait", r.t_submit, state.t_flush,
                               bucket_cap=cap, async_=True)
                res, times = state.fn.finish(state.pending)
                state.fn.last_times = list(times)
                self._replay(cap, times)
                self._deliver(cap, reqs, state.epoch, state.lens, res,
                              state.pending.stats)
        except BaseException as e:
            # this flush's futures die here: the worker's handler, which
            # re-raises, no longer sees them (self._pending is clear)
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            raise
        with self._cv:
            self._inflight -= len(reqs)
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

    def _device_work(self):
        """Held around a flush while a roofline manager is attached: its
        measured run must have the card to itself.  Taken before the
        flush span opens, so a flush held back by a measurement shows
        the wait in its reads' ``enqueue_wait``, not in its stages."""
        rf = self.roofline
        return rf.device_lock if rf is not None else contextlib.nullcontext()

    def _replay(self, cap: int, times) -> None:
        """Replay an executor's per-stage windows as child spans of the
        open flush span and sum them per stage in the metrics.  A linear
        flush's align interval also goes to the roofline manager, and
        the align span carries the site's analytic counters."""
        c, rf = self.config, self.roofline
        kc = None
        if rf is not None and rf.enabled and c.workload == "linear":
            align_s = next((t1 - t0 for name, t0, t1, _ in times
                            if name in ("align", "align_shard")), None)
            kc = rf.record_flush(self.align_backend, cap, c.genasm.k,
                                 c.max_batch, align_s=align_s)
        for name, t0, t1, attrs in times:
            if name in ("align", "align_shard") and kc is not None:
                attrs = {**attrs, "word_ops": kc.word_ops,
                         "hbm_bytes": kc.hbm_bytes}
            self.tracer.add(name, t0, t1, bucket_cap=cap, **attrs)
            self.metrics.counter(f"stage_{name}_s").inc(t1 - t0)

    def _execute(self, cap: int, reqs: list[_Request]) -> None:
        with self._device_work():
            self._execute_flush(cap, reqs)
        with self._cv:
            self._inflight -= len(reqs)
            self._cv.notify_all()

    def _execute_flush(self, cap: int, reqs: list[_Request]) -> None:
        c, tr = self.config, self.tracer
        t_flush = time.monotonic()
        with tr.span("flush", bucket_cap=cap, batch=len(reqs),
                     workload=c.workload, shards=c.num_shards):
            if tr.enabled:
                # queue waits overlap the previous flush's compute, so
                # they export as async spans (outside the slice nesting)
                for r in reqs:
                    tr.add("enqueue_wait", r.t_submit, t_flush,
                           bucket_cap=cap, async_=True)
            index, epoch = self.index.current()
            if c.num_shards > 1:
                payload = index.parts
                fn = self._executor(cap, index.layout_key,
                                    sharded_index=index)
            elif c.workload == "graph":
                payload = index.arrays
                fn = self._executor(cap, index.tile_stride)
            else:
                payload = index
                fn = self._executor(cap)
            with tr.span("encode", bucket_cap=cap):
                arr, lens = self._encode(cap, reqs)
            res = fn(payload, arr, lens)
            self._replay(cap, fn.last_times)
            self._deliver(cap, reqs, epoch, lens, res,
                          getattr(fn, "last_stats", None))
