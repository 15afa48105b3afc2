"""Shard failover: lease-routed scatter + align so a lost shard re-queues.

Port of `repro.shard.failover`.  The serve path launches the scatter
stage over all shards at once; this module is the degraded-mode driver
for when shards can *fail independently* (a device drops, a host runs
out of memory).  Each shard's stage runs on its own, routed through the
`repro_torch.dist.fault.WorkQueue` lease protocol:

* every shard id is a work item; a claim leases it for ``lease_s``;
* a shard whose stage raises (or whose worker dies and lets the lease
  expire) is **re-queued, not dropped** — the handler re-materializes
  the shard from the epoched index (``refresh_shard``, which bumps that
  shard's epoch-vector entry) and the next claim retries it;
* reads are only answered after *every* shard contributed its
  candidates, so no read silently loses the shard that owned its true
  locus.

The merge is the packed-key device reduction (span ``merge_device``).
With ``align_fault_hook`` the winning windows split into per-owner-shard
chunks on a second lease queue, so a shard lost *between merge and
align* — the window the pipelined serve path opens — re-queues its chunk
instead of dropping those reads.  ``pipelined=True`` skips the
synchronise after the merge, as the engine's pipelined mode does.

``fault_hook(shard_id, attempt)`` / ``align_fault_hook(shard_id,
attempt)`` exist for tests and drills: they run before each shard stage
/ align chunk and may raise to simulate a lost device.
`map_batch_with_failover_graph` is the same driver for the
variation-graph workload (screen → stage → device merge → align).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.mapper import MapResult
from repro_torch.dist.fault import WorkQueue
from repro_torch.graph.mapper import GraphMapResult, tile_rung, unmapped_result
from repro_torch.obs.trace import NULL_TRACER

from . import merge as shard_merge
from .graph_mapper import get_graph_executor
from .graph_partition import EpochedShardedGraphIndex
from .mapper import ShardStageResult, get_executor, sync, to_host
# a name the reference module binds too
from .graph_partition import GraphShardArrays  # noqa: F401
from .partition import EpochedShardedIndex
# a name the reference module binds too
from .partition import ShardArrays  # noqa: F401


def _run_shard_queue(s, *, esi, lease_s, max_attempts, fault_hook, tr,
                     span_name, work, **span_attrs):
    """Lease-queue driver: run ``work(shard_id)`` once per shard with retry.

    Returns ``{shard_id: work result}`` after every shard completed;
    re-materializes + re-queues a shard whose ``work`` (or
    ``fault_hook``) raises, giving up only after ``max_attempts``.
    """
    q = WorkQueue(s, lease_s=lease_s)
    attempts = [0] * s
    parts: dict[int, object] = {}
    while not q.finished:
        item = q.claim()
        if item is None:
            time.sleep(0.001)
            continue
        attempts[item] += 1
        try:
            with tr.span(span_name, shard=item, attempt=attempts[item],
                         **span_attrs):
                if fault_hook is not None:
                    fault_hook(item, attempts[item])
                parts[item] = work(item)
        except Exception as e:  # a lost shard: any failure of its stage
            if attempts[item] >= max_attempts:
                raise RuntimeError(
                    f"shard {item} failed {attempts[item]} times in "
                    f"{span_name}; last error: {e}") from e
            esi.refresh_shard(item)  # re-materialize before the retry
            q.fail(item)
            tr.event("shard_requeued", shard=item, attempt=attempts[item],
                     stage=span_name, error=type(e).__name__)
            continue
        q.complete(item)
    return parts


def _chunked_align(owner: np.ndarray, align_one, b: int, *, s, esi, lease_s,
                   max_attempts, align_fault_hook, tr):
    """Align the winners in per-owner-shard chunks on a lease queue.

    ``owner[b]`` is each read's winning shard; chunk ``i`` aligns the
    reads shard ``i`` owns (``align_one(row_idx) -> host result``) and a
    chunk whose shard dies between merge and align re-queues instead of
    dropping its reads.  The chunks' rows scatter back into ``[B]``
    tensors, so the batch equals the one-shot align's (``align_batch``
    is per row).
    """
    chunks = [np.nonzero(owner == i)[0] for i in range(s)]

    def work(i):
        idx = chunks[i]
        return None if idx.size == 0 else (idx, align_one(idx))

    parts = _run_shard_queue(
        s, esi=esi, lease_s=lease_s, max_attempts=max_attempts,
        fault_hook=align_fault_hook, tr=tr, span_name="align_shard",
        work=work)
    done = [p for p in parts.values() if p is not None]
    template = done[0][1]
    out = [torch.zeros((b,) + f.shape[1:], dtype=f.dtype) for f in template]
    for idx, res in done:
        rows = torch.from_numpy(idx)
        for dst, src in zip(out, res):
            dst[rows] = src
    return type(template)(*out)


def map_batch_with_failover(
    esi: EpochedShardedIndex,
    reads,
    read_lens,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int = 256,
    filter_bits: int = 128,
    filter_k: int = 12,
    shard_candidates: int = 4,
    backend: str | None = None,
    lease_s: float = 60.0,
    max_attempts: int = 3,
    fault_hook=None,
    align_fault_hook=None,
    pipelined: bool = False,
    tracer=None,
) -> MapResult:
    """Map a batch with per-shard retry semantics over a lease queue.

    Gives `shard.mapper.map_batch_sharded`'s `MapResult` (on the host):
    shard stages are deterministic, so a re-materialized shard
    contributes identical candidates and failures leave the merged
    output unchanged.  Raises ``RuntimeError`` only after a shard fails
    ``max_attempts`` times.

    ``tracer`` (a `repro_torch.obs.trace.Tracer`) records one
    ``scatter`` span per shard attempt, a ``shard_requeued`` instant per
    lease failure, and the ``merge_device`` / ``align`` (or per-chunk
    ``align_shard``) spans.
    """
    tr = tracer if tracer is not None else NULL_TRACER
    sharded, _ = esi.current()
    s = sharded.num_shards
    home = sharded.device
    ex = get_executor(
        sharded, cfg=cfg, p_cap=p_cap, filter_bits=filter_bits,
        filter_k=filter_k, shard_candidates=shard_candidates,
        backend=backend)

    def scatter_one(item):
        cur, _ = esi.current()
        st = ex.stage((cur.row(item),), reads, read_lens)
        return ShardStageResult(*(x[0].cpu() for x in st))

    parts = _run_shard_queue(
        s, esi=esi, lease_s=lease_s, max_attempts=max_attempts,
        fault_hook=fault_hook, tr=tr, span_name="scatter",
        work=scatter_one)

    with tr.span("merge_device", shards=s, pipelined=pipelined):
        stacked = ShardStageResult(*(
            torch.stack([parts[i][f] for i in range(s)]).to(home)
            for f in range(len(ShardStageResult._fields))))
        fd, pos, text, t_len, win = ex.merge_device(stacked)
        if not pipelined:
            sync((home,))

    if align_fault_hook is None:
        with tr.span("align"):
            return to_host(ex._align(text, reads, read_lens, t_len, pos, fd))

    owner = win.cpu().numpy()
    reads_t = torch.as_tensor(reads)
    lens_t = torch.as_tensor(read_lens)

    def align_one(idx):
        rows = torch.from_numpy(idx).to(home)
        return to_host(ex._align(text[rows], reads_t[idx], lens_t[idx],
                                 t_len[rows], pos[rows], fd[rows]))

    return _chunked_align(
        owner, align_one, len(owner), s=s, esi=esi, lease_s=lease_s,
        max_attempts=max_attempts, align_fault_hook=align_fault_hook, tr=tr)


def map_batch_with_failover_graph(
    esi: EpochedShardedGraphIndex,
    reads,
    read_lens,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int = 256,
    filter_bits: int = 128,
    filter_k: int = 12,
    shard_candidates: int = 4,
    backend: str | None = None,
    prefilter: bool | None = None,
    lease_s: float = 60.0,
    max_attempts: int = 3,
    fault_hook=None,
    align_fault_hook=None,
    pipelined: bool = False,
    tracer=None,
) -> GraphMapResult:
    """Graph-workload twin of `map_batch_with_failover`.

    Per shard: the q-gram screen as its own lease-queued task
    (``scatter`` spans; ``fault_hook`` faults it), then, once every
    shard reported its survivors and the rung is known, the compacted
    candidate stage; then the packed ``(distance, origin, tile)`` device
    merge and the winner align — chunked per owner shard on a second
    lease queue when ``align_fault_hook`` is given.  Byte-identical to
    `shard.graph_mapper.map_batch_sharded_graph` under any failure
    sequence that stays within ``max_attempts``.
    """
    tr = tracer if tracer is not None else NULL_TRACER
    sharded, _ = esi.current()
    s = sharded.num_shards
    home = sharded.device
    reads = torch.as_tensor(reads)
    lens = torch.as_tensor(read_lens)
    b = int(reads.shape[0])
    ex = get_graph_executor(
        sharded, cfg=cfg, p_cap=p_cap, filter_bits=filter_bits,
        filter_k=filter_k, shard_candidates=shard_candidates,
        backend=backend, prefilter=prefilter)

    def screen_one(item):
        # the rung must follow the fleet rule (the worst shard's survivor
        # count), so each shard screens here and the rung is picked after
        # every shard reported
        cur, _ = esi.current()
        (pf,) = ex.screen((cur.row(item),), reads, lens)
        return esi.epochs[item], pf, int(pf.n_keep.sum())

    screened = _run_shard_queue(
        s, esi=esi, lease_s=lease_s, max_attempts=max_attempts,
        fault_hook=fault_hook, tr=tr, span_name="scatter", work=screen_one)

    n_cap = tile_rung(max(screened[i][2] for i in range(s)),
                      b * shard_candidates)
    if n_cap == 0:
        # on the host, as the sharded executor's all-pruned batch
        return unmapped_result(b, cfg=cfg, p_cap=p_cap, device="cpu")

    def candidates_one(item):
        cur, _ = esi.current()
        row = (cur.row(item),)
        # a shard refreshed since its screen recomputes the
        # deterministic screen before the stage
        epoch, pf, _ = screened[item]
        if esi.epochs[item] != epoch:
            (pf,) = ex.screen(row, reads, lens)
        st = ex.candidates(row, reads, lens, [pf], n_cap)
        return type(st)(*(x[0].cpu() for x in st))

    parts = _run_shard_queue(
        s, esi=esi, lease_s=lease_s, max_attempts=max_attempts,
        fault_hook=None, tr=tr, span_name="scatter", work=candidates_one,
        phase="candidates")

    kind = type(parts[0])
    with tr.span("merge_device", shards=s, pipelined=pipelined):
        stacked = kind(*(torch.stack([parts[i][f] for i in range(s)]).to(home)
                         for f in range(len(kind._fields))))
        merged = ex.merge_device(stacked)
        if not pipelined:
            sync((home,))

    if align_fault_hook is None:
        with tr.span("align"):
            return to_host(ex._align(merged, reads, lens))

    # owner shard by the same packed key the device merge used
    owner = shard_merge.pack_graph_key(
        stacked.distance, stacked.origin, stacked.tile).argmin(0).cpu().numpy()

    def align_one(idx):
        rows = torch.from_numpy(idx).to(home)
        sub = kind(*(x[rows] for x in merged))
        return to_host(ex._align(sub, reads[idx], lens[idx]))

    return _chunked_align(
        owner, align_one, b, s=s, esi=esi, lease_s=lease_s,
        max_attempts=max_attempts, align_fault_hook=align_fault_hook, tr=tr)
