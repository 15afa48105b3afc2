"""End-to-end linear read mapper (paper Figure 2-2 with GenASM inside).

Port of `repro.core.mapper`.  Seed-and-extend: MinSeed-style minimizer
seeding → GenASM-DC pre-alignment filter (`bitap_search`) over every
read's candidates → windowed GenASM DC+TB alignment of the best
candidate, dispatched through `repro_torch.align.align_batch` so every
registered backend drives the same pipeline.  Both stages run batched
over the reads on the index's device; `map_read` and `seed_filter_read`
are the reference's one-read entry points, each a batch of one.
`repro_torch.align` is imported where it is called, as the reference
does: the align package imports the graph mapper, which imports this
module.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.kernels import bitap_filter as _kfilter
from repro_torch.obs import trace

from .bitvector import SENTINEL, WILDCARD
from .genasm import GenASMConfig
from .genasm_dc import bitap_search  # noqa: F401  (the reference binds it)
from .minimizer_index import ReferenceIndex, build_reference_index  # noqa: F401
from .segram.minimizer import seed_candidates

# lexicographic-selection sentinel: masked-out candidates sort last
POS_SENTINEL = 2 ** 31 - 1


class MapResult(NamedTuple):
    """A mapped batch: position, distance and packed CIGAR per read."""

    position: torch.Tensor  # [B] int32 mapped reference start (-1 if unmapped)
    distance: torch.Tensor  # [B] int32 edit distance (-1 if unmapped)
    ops: torch.Tensor  # [B, cap] packed CIGAR
    n_ops: torch.Tensor
    failed: torch.Tensor


class SeedFilterResult(NamedTuple):
    """The seed + filter stage's winner per read and its alignment text."""

    position: torch.Tensor  # [B] int32 best candidate start (filter-refined)
    prefilter_ok: torch.Tensor  # [B] bool — candidate survived the filter
    text: torch.Tensor  # [B, t_cap] int8 reference region at position
    t_len: torch.Tensor  # [B] int32 valid text length
    pattern: torch.Tensor  # [B, p_cap] int8 wildcard-padded read
    distance: torch.Tensor  # [B] int32 winning filter distance


def lex_best(fd: torch.Tensor, fpos: torch.Tensor) -> torch.Tensor:
    """Per-row index of the lexicographically-minimal ``(fd, fpos)``.

    Minimizing ``(distance, position)`` makes the winner a function of
    the candidate *set*, not its order (the reference's rule).
    """
    pm = torch.where(fd == fd.min(-1, keepdim=True).values, fpos, POS_SENTINEL)
    return pm.argmin(-1)


def _ref_window(buf: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``[..., size]`` windows of ``buf`` at ``start``, SENTINEL past its end.

    The reference slices ``buf ++ SENTINEL×size`` with
    ``lax.dynamic_slice``, which clamps the start into ``[0, len(buf)]``
    so that the slice fits; the start is clamped the same way here, then
    gathered with the same padding.
    """
    n = buf.shape[0]
    idx = start.clamp(0, n).unsqueeze(-1) + torch.arange(size, device=buf.device)
    return torch.where(idx < n, buf[idx.clamp(max=n - 1)], SENTINEL)


def seed_filter_rows(ref_buf: torch.Tensor, ref_offset, ref_len: int,
                     hashes: torch.Tensor, positions: torch.Tensor,
                     reads: torch.Tensor, read_lens: torch.Tensor, *,
                     p_cap: int, t_cap: int, filter_bits: int, filter_k: int,
                     max_candidates: int, minimizer_w: int,
                     minimizer_k: int) -> SeedFilterResult:
    """Seed + pre-alignment-filter a ``[B, cap]`` read batch against one
    reference buffer (port of `repro.core.mapper.seed_filter_read`,
    batched over the reads).

    ``ref_buf`` is an ``[Lb] int8`` slice whose first base sits at global
    coordinate ``ref_offset`` (an int or a 0-d tensor) of a reference of
    ``ref_len`` bases; ``hashes``/``positions`` are a sorted minimizer
    table in global coordinates.  The whole-reference mapper passes
    offset 0 and the sharded mapper each shard's haloed slice: one body
    is what keeps 1-shard and N-shard output identical.

    The filter takes the exact distance of each read's first
    ``filter_bits`` bases against every candidate region (on a card one
    `kernels.bitap_filter` launch over ``[B·C]`` lanes, on the CPU one
    `bitap_search` over them), refines each candidate's start to its best
    match, and keeps the lexicographically best ``(distance, position)``
    candidate per read (``POS_SENTINEL`` when the read had no seed hits).
    Returns that candidate's ``[t_cap]`` alignment text.
    """
    lens = read_lens.to(torch.int64)
    tr = trace.current_tracer()
    with tr.device_span("seed", reads.device):
        starts, votes = seed_candidates(reads, hashes, positions,
                                        w=minimizer_w, k=minimizer_k,
                                        max_candidates=max_candidates)
    with tr.device_span("filter", reads.device) as span:
        out = _filter_rows(ref_buf, ref_offset, ref_len, starts, votes, reads,
                           lens, p_cap=p_cap, t_cap=t_cap,
                           filter_bits=filter_bits, filter_k=filter_k)
    if tr.enabled:
        tr.later(span, "passed", _host_count(out.prefilter_ok))
    return out


def _filter_rows(ref_buf, ref_offset, ref_len, starts, votes, reads, lens, *,
                 p_cap, t_cap, filter_bits, filter_k) -> SeedFilterResult:
    """`seed_filter_rows` after seeding: the filter over each read's
    candidates, the best candidate, its text window and the pattern."""
    # candidate starts are diagonal-bucketed to 32 (minimizer voting), so the
    # filter window must absorb bucket quantization + k edits of drift
    margin = filter_k + 32
    region_len = filter_bits + 2 * margin

    # pre-alignment filter (use case 2): exact distance of the read's
    # first filter_bits bases against each candidate region, and the first
    # region position that reaches it
    s0 = (starts - margin).clamp(0, max(ref_len - 1, 0))  # [B, C] global
    fd, off = _kfilter.bitap_filter_batch(
        ref_buf, s0 - ref_offset, reads.to(torch.int8), lens,
        filter_bits=filter_bits, k=filter_k, region_len=region_len)
    fpos = s0 + off
    fd = torch.where(votes > 0, fd, filter_k + 1)
    fpos = torch.where(votes > 0, fpos, POS_SENTINEL)
    best = lex_best(fd, fpos).unsqueeze(1)
    pos = torch.gather(fpos, 1, best).squeeze(1)
    best_d = torch.gather(fd, 1, best).squeeze(1)

    text = _ref_window(ref_buf, pos.clamp(max=ref_len) - ref_offset, t_cap)
    r = reads[:, :p_cap]
    if r.shape[1] < p_cap:
        r = torch.nn.functional.pad(r, (0, p_cap - r.shape[1]), value=WILDCARD)
    pat = torch.where(torch.arange(p_cap, device=reads.device) < lens.unsqueeze(1),
                      r, WILDCARD).to(torch.int8)
    return SeedFilterResult(
        position=pos.to(torch.int32),
        prefilter_ok=best_d <= filter_k,
        text=text.to(torch.int8),
        t_len=(ref_len - pos).clamp(0, t_cap).to(torch.int32),
        pattern=pat,
        distance=best_d.to(torch.int32),
    )


def _host_count(mask: torch.Tensor):
    """``() -> int``: the count of ``mask``, reduced on its device and, on
    a card, copied to pinned memory without a synchronisation; call it
    once the device has finished."""
    n = mask.sum()
    if n.device.type != "cuda":
        return lambda: int(n)
    host = torch.empty((), dtype=n.dtype, pin_memory=True)
    host.copy_(n, non_blocking=True)
    return lambda: int(host)


def _one(result):
    """A batch-of-one result without its batch axis."""
    return type(result)(*(x[0] for x in result))


def seed_filter_read(ref_buf: torch.Tensor, ref_offset, ref_len: int,
                     hashes: torch.Tensor, positions: torch.Tensor,
                     read: torch.Tensor, read_len, *, p_cap: int, t_cap: int,
                     filter_bits: int, filter_k: int, max_candidates: int,
                     minimizer_w: int, minimizer_k: int) -> SeedFilterResult:
    """Seed + pre-alignment-filter one read against one reference buffer:
    the reference's per-read signature, as `seed_filter_rows` on a batch
    of one (``read`` is ``[cap]``, ``read_len`` an int or 0-d tensor)."""
    read = torch.as_tensor(read, device=ref_buf.device)
    lens = torch.as_tensor(read_len, device=ref_buf.device).reshape(1)
    return _one(seed_filter_rows(
        ref_buf, ref_offset, ref_len, hashes, positions, read[None], lens,
        p_cap=p_cap, t_cap=t_cap, filter_bits=filter_bits, filter_k=filter_k,
        max_candidates=max_candidates, minimizer_w=minimizer_w,
        minimizer_k=minimizer_k))


def seed_and_filter_batch(index: ReferenceIndex, reads: torch.Tensor,
                          read_lens: torch.Tensor, *, p_cap: int, t_cap: int,
                          filter_bits: int, filter_k: int, max_candidates: int,
                          minimizer_w: int, minimizer_k: int) -> SeedFilterResult:
    """`seed_filter_rows` against the whole indexed reference (offset 0)."""
    return seed_filter_rows(
        index.ref, 0, index.ref.shape[0], index.hashes, index.positions,
        reads, read_lens, p_cap=p_cap, t_cap=t_cap, filter_bits=filter_bits,
        filter_k=filter_k, max_candidates=max_candidates,
        minimizer_w=minimizer_w, minimizer_k=minimizer_k)


def _finish(sf: SeedFilterResult, read_lens: torch.Tensor, *, cfg, backend,
            p_cap) -> MapResult:
    from repro_torch import align as align_dispatch

    res = align_dispatch.align_batch(
        sf.text, sf.pattern, read_lens.to(torch.int32), sf.t_len,
        cfg=cfg, backend=backend, p_cap=p_cap)
    failed = res.failed | (~sf.prefilter_ok)
    return MapResult(
        position=torch.where(failed, -1, sf.position).to(torch.int32),
        distance=torch.where(failed, -1, res.distance).to(torch.int32),
        ops=res.ops, n_ops=res.n_ops, failed=failed)


def map_batch(
    index: ReferenceIndex,
    reads: torch.Tensor,
    read_lens: torch.Tensor,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int = 256,
    filter_bits: int = 128,
    filter_k: int = 12,
    max_candidates: int = 4,
    minimizer_w: int = 10,
    minimizer_k: int = 15,
    backend: str | None = None,
) -> MapResult:
    """Map a read batch against the indexed reference.

    ``reads``/``read_lens`` are moved to the index's device; ``backend``
    selects the alignment implementation by registry name (None/"auto"
    resolves per device).
    """
    dev = index.device
    reads = torch.as_tensor(reads, device=dev)
    read_lens = torch.as_tensor(read_lens, device=dev)
    sf = seed_and_filter_batch(
        index, reads, read_lens, p_cap=p_cap, t_cap=p_cap + cfg.w * 2,
        filter_bits=filter_bits, filter_k=filter_k,
        max_candidates=max_candidates, minimizer_w=minimizer_w,
        minimizer_k=minimizer_k)
    return _finish(sf, read_lens, cfg=cfg, backend=backend, p_cap=p_cap)


def map_read(index: ReferenceIndex, read, read_len, **kw) -> MapResult:
    """Map one read: `map_batch` on a batch of one, unbatched (``kw`` as
    `map_batch` takes them)."""
    reads = torch.as_tensor(read, device=index.device)[None]
    lens = torch.as_tensor(read_len, device=index.device).reshape(1)
    return _one(map_batch(index, reads, lens, **kw))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class LinearMapExecutor:
    """Two-stage linear mapper: seed/filter stage + align stage.

    Computes exactly what `map_batch` computes, but times each stage:
    every call records ``last_times`` — ``(stage, t_start, t_end,
    attrs)`` on the monotonic clock, with the device synchronised at
    each stage boundary — which the serve engine replays into its
    tracer and metrics.

    Each call also traces one tree of spans into ``tracer``, or, with
    none given, into `obs.trace.PROCESS_TRACER` while a torch profiler
    records (untraced otherwise): ``map_batch`` › ``seed_filter`` (the
    stamps of ``last_times``) › ``seed``, ``filter`` (``passed``: rows
    the filter kept); ``map_batch`` › ``align`` (``rows``: rows aligned)
    › ``dc`` and ``tb`` a window step (``window``), from `core.genasm`'s
    loop.  Every span carries ``batch``, the call's number; ``seed``,
    ``filter`` and ``dc`` carry ``device_ms``, their device time on a
    card (CUDA events read after the stage's synchronisation).
    """

    def __init__(self, *, cfg: GenASMConfig = GenASMConfig(),
                 p_cap: int = 256,
                 filter_bits: int = 128,
                 filter_k: int = 12,
                 max_candidates: int = 4,
                 minimizer_w: int = 10,
                 minimizer_k: int = 15,
                 backend: str | None = None,
                 tracer: trace.Tracer | None = None):
        self._cfg, self._p_cap, self._backend = cfg, p_cap, backend
        self._sf_kw = dict(p_cap=p_cap, t_cap=p_cap + cfg.w * 2,
                           filter_bits=filter_bits, filter_k=filter_k,
                           max_candidates=max_candidates,
                           minimizer_w=minimizer_w, minimizer_k=minimizer_k)
        self.last_times: list[tuple[str, float, float, dict]] = []
        self._tracer = tracer
        self._calls = 0

    def __call__(self, index: ReferenceIndex, reads, read_lens) -> MapResult:
        dev = index.device
        reads = torch.as_tensor(reads, device=dev)
        lens = torch.as_tensor(read_lens, device=dev)
        self._calls += 1
        tr = self._tracer
        if tr is None:
            tr = trace.PROCESS_TRACER if _profiling() else trace.NULL_TRACER
        with trace.using(tr), tr.tagged(batch=self._calls), tr.span("map_batch"):
            t0 = time.monotonic()
            span = tr.begin("seed_filter", t0)
            sf = seed_and_filter_batch(index, reads, lens, **self._sf_kw)
            _sync(dev)
            t1 = time.monotonic()
            tr.end(span, t1)
            span = tr.begin("align", t1, rows=reads.shape[0])
            res = _finish(sf, lens, cfg=self._cfg, backend=self._backend,
                          p_cap=self._p_cap)
            _sync(dev)
            t2 = time.monotonic()
            tr.end(span, t2)
            tr.resolve()
        self.last_times = [("seed_filter", t0, t1, {}), ("align", t1, t2, {})]
        return res


def _profiling() -> bool:
    """Whether a torch profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()
