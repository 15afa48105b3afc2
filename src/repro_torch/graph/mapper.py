"""End-to-end sequence-to-graph read mapper (paper Figure 6-1, batched).

Port of `repro.graph.mapper`.  Seed-and-extend over a tiled graph index,
as a three-stage pipeline that runs eagerly on the index's device:

  * **Stage A — seed + tile pre-filter** (`tile_prefilter`): MinSeed
    minimizer seeding on the backbone, then a q-gram Bloom screen over
    each candidate tile (`core/filter` primitives against the index's
    per-tile ``tile_bloom``/``tile_slack``) — one vectorized count, no
    DC launch.  The screen is sound (q-gram lemma), so every pruned
    slot's filter distance would have been ``filter_k + 1`` anyway and
    the GAF output is byte-identical with the screen on or off.
  * **Stage B — compacted gather + BitAlign filter**
    (`graph_candidate_stage` with ``pf``/``n_cap``): survivors are
    compacted into an ``[n_cap]``-row buffer (``n_cap`` a `tile_rung`
    chosen on the host), the per-node BitAlign filter runs over those
    rows only — on the CUDA kernel for ``graph_cuda`` — and distances
    scatter back to the dense ``[B, max_candidates]`` grid for the
    winner rule ``min (distance, origin, tile)``.
  * **Stage C — align** (`align_winners`): windowed graph alignment of
    each read's winning window through `repro_torch.align.align_batch`
    (``graph_torch`` / ``graph_cuda``), with failed reads canonicalized
    (``ops`` = OP_PAD, ``n_ops`` = 0) so an all-pruned batch can skip
    the launch entirely (`unmapped_result`) without changing any output.

The host reads the survivor count between stages A and B to pick the
rung; the device is synchronised at each stage boundary so
``last_times`` measures each stage.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import torch

from repro_torch import align as align_dispatch
from repro_torch._device import resolve_device
from repro_torch.core import filter as qfilter
from repro_torch.core.bitvector import WILDCARD
from repro_torch.core.genasm import GenASMConfig, slice_windows
from repro_torch.core.genasm_tb import OP_PAD
from repro_torch.core.mapper import POS_SENTINEL
from repro_torch.core.segram.graph import HOP_LIMIT
from repro_torch.core.segram.minimizer import seed_candidates
from repro_torch.kernels.bitalign import bitalign_dc_batch

from .index import GraphArrays, GraphIndex
from .windowed import bitalign_search, unpack_graph_text

# linear backend names map to their graph twins, so ``"auto"`` (or an
# engine configured with a linear name) serves the graph workload on the
# matching implementation tier
_GRAPH_TWIN = {"torch": "graph_torch", "ref": "graph_torch",
               "cuda_dc": "graph_cuda", "cuda_dc_v2": "graph_cuda"}


def graph_backend_name(backend: str | None = None,
                       device: torch.device | str = "cpu") -> str:
    """Resolve a backend name (or None/"auto") to a graph backend."""
    name = align_dispatch.resolve_backend(backend, device).name
    return _GRAPH_TWIN.get(name, name)


class GraphMapResult(NamedTuple):
    """Batched graph-mapping outcome (the GAF-row payload).

    ``position``/``distance`` are ``-1`` for unmapped reads; ``path``
    holds global node ids per CIGAR op (``-1`` for insertions/padding).
    Failed reads are canonical: ``ops`` all OP_PAD, ``n_ops`` 0.
    """

    position: torch.Tensor  # [B] int32 backbone coord of first aligned node
    distance: torch.Tensor  # [B] int32 edit distance (-1 if unmapped)
    ops: torch.Tensor  # [B, cap] int8 packed CIGAR
    n_ops: torch.Tensor  # [B] int32
    path: torch.Tensor  # [B, cap] int64 global node ids per op (-1 for I/pad)
    failed: torch.Tensor  # [B] bool


class GraphView(NamedTuple):
    """One shard's (or the whole graph's) view of a tiled graph index.

    Local array slices plus the global coordinate of each slice's first
    row (an int, or a 0-d tensor on the view's device for a shard); the
    whole-graph view has all offsets 0.  ``idx_positions`` stay global
    backbone coordinates in every view.
    """

    tile_gtext: torch.Tensor  # [Ct, tile_len] int32 packed local tiles
    tile_valid: torch.Tensor  # [Ct] valid node count per local tile
    tile_base: int | torch.Tensor  # global tile id of local tile row 0
    node_of_backbone: torch.Tensor  # [Lb] local backbone→node slice
    nb_offset: int | torch.Tensor  # global backbone coord of slice row 0
    backbone: torch.Tensor  # [Nb] local node→backbone slice
    node_base: int | torch.Tensor  # global node id of backbone slice row 0
    idx_hashes: torch.Tensor  # [M] sorted minimizer hashes
    idx_positions: torch.Tensor  # [M] GLOBAL backbone positions
    tile_bloom: torch.Tensor  # [Ct, BLOOM_WORDS] int32 per-tile Bloom
    tile_slack: torch.Tensor  # [Ct] per-tile q-gram-lemma slack


def whole_graph_view(garr: GraphArrays) -> GraphView:
    """The trivial single-shard view: full arrays, zero offsets."""
    return GraphView(
        tile_gtext=garr.tile_gtext, tile_valid=garr.tile_valid, tile_base=0,
        node_of_backbone=garr.node_of_backbone, nb_offset=0,
        backbone=garr.backbone, node_base=0, idx_hashes=garr.idx_hashes,
        idx_positions=garr.idx_positions, tile_bloom=garr.tile_bloom,
        tile_slack=garr.tile_slack)


class CandidateStageResult(NamedTuple):
    """Per-read winner of one view's seeding + BitAlign filter stage.

    ``gwin`` is the packed ``[B, t_cap]`` graph text window, ``bwin`` the
    backbone coordinate of each window node (``-1`` on alt nodes), so
    the align stage needs no graph arrays.
    """

    distance: torch.Tensor  # [B] int32 filter distance (filter_k+1 = none)
    origin: torch.Tensor  # [B] int64 global node id of window node 0
    tile: torch.Tensor  # [B] int64 global winning tile id
    gwin: torch.Tensor  # [B, t_cap] int32 packed graph text window
    bwin: torch.Tensor  # [B, t_cap] int64 backbone coord per window node
    t_len: torch.Tensor  # [B] int32 valid window length
    prefilter_ok: torch.Tensor  # [B] bool


class TilePrefilterResult(NamedTuple):
    """Stage-A output: seeds plus the per-slot tile-screen verdict."""

    starts: torch.Tensor  # [B, C] candidate backbone starts
    votes: torch.Tensor  # [B, C] seed votes (0 = dead slot)
    keep: torch.Tensor  # [B, C] bool live & screen-pass (survivors)
    n_keep: torch.Tensor  # [B] survivors per read
    n_live: torch.Tensor  # [B] live (seeded) slots per read


def tile_rung(n: int, cap: int) -> int:
    """High-water bucket for the compacted DC row count.

    The smallest power of two ≥ max(n, 8), clamped to the dense slot
    count ``cap``.  0 survivors → rung 0 (callers short-circuit).
    """
    if n <= 0:
        return 0
    r = 8
    while r < n:
        r *= 2
    return min(r, cap)


def _tiles_of_starts(view: GraphView, starts, *, tile_stride: int,
                     n_tiles: int, backbone_len: int):
    """Candidate backbone starts → (global tile id, local tile row)."""
    sb = (starts - HOP_LIMIT).clamp(0, backbone_len - 1)
    nb_len = view.node_of_backbone.shape[0]
    node = view.node_of_backbone[(sb - view.nb_offset).clamp(0, nb_len - 1)]
    tile_g = (node // tile_stride).clamp(0, n_tiles - 1)
    tile_local = (tile_g - view.tile_base).clamp(0, view.tile_gtext.shape[0] - 1)
    return tile_g, tile_local


def _filter_pattern(reads, read_lens, filter_bits: int):
    """Wildcard-masked [B, fb] filter pattern + clamped lengths."""
    flens = read_lens.clamp(max=filter_bits)
    fpat = torch.where(
        torch.arange(filter_bits, device=reads.device) < flens.unsqueeze(1),
        reads[:, :filter_bits], WILDCARD).to(torch.int8)
    return fpat, flens


def tile_prefilter(view: GraphView, reads: torch.Tensor,
                   read_lens: torch.Tensor, *, tile_stride: int, n_tiles: int,
                   backbone_len: int, filter_bits: int, filter_k: int,
                   max_candidates: int, minimizer_w: int, minimizer_k: int,
                   prefilter: bool = True) -> TilePrefilterResult:
    """Stage A: seed, then screen each candidate tile without any DC.

    A slot survives iff it is live (has seed votes) and its tile's Bloom
    filter confirms at least ``(m-q+1) - q·filter_k - tile_slack`` of the
    read's q-grams.  With ``prefilter=False`` the screen is skipped
    (survivor = live), which still compacts away dead slots downstream.
    """
    read_lens = read_lens.to(torch.int64)
    starts, votes = seed_candidates(reads, view.idx_hashes,
                                    view.idx_positions, w=minimizer_w,
                                    k=minimizer_k,
                                    max_candidates=max_candidates)
    live = votes > 0
    if prefilter:
        _, tile_local = _tiles_of_starts(
            view, starts, tile_stride=tile_stride, n_tiles=n_tiles,
            backbone_len=backbone_len)
        fpat, flens = _filter_pattern(reads, read_lens, filter_bits)
        codes = qfilter.qgram_codes(fpat)  # [B, fb-q+1]
        b, c = votes.shape
        p = codes.shape[-1]
        n_pos = (flens - (qfilter.QGRAM_Q - 1)).clamp(min=0)  # [B]
        pos_ok = torch.arange(p, device=reads.device) < n_pos.unsqueeze(1)
        hits = qfilter.qgram_hits(codes.unsqueeze(1).expand(b, c, p),
                                  pos_ok.unsqueeze(1).expand(b, c, p),
                                  view.tile_bloom[tile_local])  # [B, C]
        need = qfilter.qgram_min_hits(n_pos.unsqueeze(1), filter_k,
                                      view.tile_slack[tile_local])
        keep = live & (hits >= need)
    else:
        keep = live
    return TilePrefilterResult(starts=starts, votes=votes, keep=keep,
                               n_keep=keep.sum(-1), n_live=live.sum(-1))


def _filter_dists(wins, fpat, flens, *, m_bits: int, k: int,
                  use_kernel: bool) -> torch.Tensor:
    """``[R, tile_len]`` per-node filter distances: the BitAlign kernel
    (distances only, no R store) or the plain `bitalign_search`."""
    bases, succ = unpack_graph_text(wins)
    if use_kernel:
        return bitalign_dc_batch(bases, succ, fpat, flens, m_bits=m_bits,
                                 k=k, store_r=False)[0]
    return bitalign_search(bases, succ, fpat, flens, m_bits=m_bits, k=k)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range, as the reference's int32
    arithmetic wraps them."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def graph_candidate_stage(
    view: GraphView,
    reads: torch.Tensor,
    read_lens: torch.Tensor,
    *,
    tile_stride: int,
    n_tiles: int,
    backbone_len: int,
    t_cap: int,
    filter_bits: int,
    filter_k: int,
    max_candidates: int,
    minimizer_w: int,
    minimizer_k: int,
    use_kernel: bool = False,
    pf: TilePrefilterResult | None = None,
    n_cap: int | None = None,
) -> CandidateStageResult:
    """Seed, gather, filter, and select one view's best candidate per read.

    ``reads`` is ``[B, p_cap] int8`` with ``read_lens [B]`` valid lengths.
    The per-read winner minimizes ``(filter distance, origin node, tile)``
    lexicographically.  With ``pf`` (a `tile_prefilter` result) the
    filter only scores surviving slots; with ``n_cap`` additionally set
    (a `tile_rung`) survivors are compacted into ``[n_cap]`` rows so
    pruned and dead slots launch no DC lanes.  Both modes equal the dense
    path (``pf=None``) on every mapped read.
    """
    dev = reads.device
    b = reads.shape[0]
    c = max_candidates
    tile_len = view.tile_gtext.shape[1]
    search_span = tile_len - t_cap
    read_lens = read_lens.to(torch.int64)

    if pf is None:
        starts, votes = seed_candidates(reads, view.idx_hashes,
                                        view.idx_positions, w=minimizer_w,
                                        k=minimizer_k, max_candidates=c)
        keep = votes > 0
    else:
        starts, votes, keep = pf.starts, pf.votes, pf.keep
    tile_g, tile_local = _tiles_of_starts(
        view, starts, tile_stride=tile_stride, n_tiles=n_tiles,
        backbone_len=backbone_len)
    fpat, flens = _filter_pattern(reads, read_lens, filter_bits)
    span_ok = torch.arange(tile_len, device=dev) < search_span
    fk1 = filter_k + 1

    def dc(wins, fp, fl):
        dists = _filter_dists(wins, fp, fl, m_bits=filter_bits, k=filter_k,
                              use_kernel=use_kernel)
        # anchors past the search span could not fit an alignment window
        dists = torch.where(span_ok, dists, fk1)
        return dists.min(-1).values.to(torch.int64), dists.argmin(-1)

    if n_cap is None:
        # dense: one gather + one DC launch over every slot
        wins = view.tile_gtext[tile_local].reshape(b * c, tile_len)
        d_c, off_c = dc(wins, fpat.repeat_interleave(c, dim=0),
                        flens.repeat_interleave(c))
        d_c, off_c = d_c.reshape(b, c), off_c.reshape(b, c)
        d_c = torch.where(keep, d_c, fk1)
    else:
        # ragged: compact survivors into [n_cap] rows, DC those only,
        # scatter back to the dense grid.  Non-survivor slots take the
        # (filter_k+1, off=0) values the dense scan computes for them.
        bc = b * c
        kf = keep.reshape(bc)
        order = torch.argsort(torch.where(kf, 0, bc)
                              + torch.arange(bc, device=dev), stable=True)
        slots = order[:n_cap]  # survivors first, in slot order; distinct
        rowmask = torch.arange(n_cap, device=dev) < kf.sum()
        ridx = slots // c  # read of each compacted row
        d_r, off_r = dc(view.tile_gtext[tile_local.reshape(bc)[slots]],
                        fpat[ridx], flens[ridx])
        d_c = torch.full((bc,), fk1, dtype=torch.int64, device=dev)
        d_c[slots] = torch.where(rowmask, d_r, fk1)
        off_c = torch.zeros((bc,), dtype=torch.int64, device=dev)
        off_c[slots] = torch.where(rowmask, off_r, 0)
        d_c, off_c = d_c.reshape(b, c), off_c.reshape(b, c)

    live = votes > 0
    origin_c = torch.where(live, tile_g * tile_stride + off_c, POS_SENTINEL)
    tile_m = torch.where(live, tile_g, POS_SENTINEL)

    # lexicographic winner per read: min (distance, origin, tile)
    dm = d_c.min(-1, keepdim=True).values
    om = torch.where(d_c == dm, origin_c, POS_SENTINEL)
    omin = om.min(-1, keepdim=True).values
    tm = torch.where(om == omin, tile_m, POS_SENTINEL)
    ci = tm.argmin(-1)  # [B]

    rows = torch.arange(b, device=dev)
    d_best = d_c[rows, ci]
    origin = origin_c[rows, ci]
    off = off_c[rows, ci]
    win_tile = tile_local[rows, ci]

    # the anchored alignment window out of the winning tile
    gwin = slice_windows(view.tile_gtext[win_tile], off, t_cap)
    t_len = (view.tile_valid[win_tile] - off).clamp(0, t_cap)

    # backbone coordinate of every window node, shipped with the window so
    # the align stage needs no graph arrays (nodes past the graph end read
    # backbone[n-1]; the sum and the shard offset wrap as the reference's
    # int32 arithmetic wraps them)
    bb_len = view.backbone.shape[0]
    widx = _wrap_int32(_wrap_int32(origin.unsqueeze(1)
                                   + torch.arange(t_cap, device=dev))
                       - view.node_base)
    bwin = view.backbone[widx.clamp(0, bb_len - 1)]
    return CandidateStageResult(
        distance=d_best.to(torch.int32), origin=origin,
        tile=torch.where(live[rows, ci], tile_g[rows, ci], POS_SENTINEL),
        gwin=gwin, bwin=bwin, t_len=t_len.to(torch.int32),
        prefilter_ok=d_best <= filter_k)


def align_winners(stage: CandidateStageResult, reads: torch.Tensor,
                  read_lens: torch.Tensor, *, cfg: GenASMConfig, p_cap: int,
                  backend: str) -> GraphMapResult:
    """Align the per-read winning windows and translate paths to GAF terms.

    Failed reads come out canonical (``ops`` all OP_PAD, ``n_ops`` 0, and
    position/distance/path ``-1``): different executions may feed
    different garbage windows for reads with no surviving candidate, and
    canonicalizing here keeps prefilter on/off — and the zero-survivor
    `unmapped_result` short-circuit — bitwise identical.
    """
    dev = reads.device
    read_lens = read_lens.to(torch.int32)
    t_cap = stage.gwin.shape[-1]
    r = reads[:, :p_cap]
    if r.shape[1] < p_cap:
        r = torch.nn.functional.pad(r, (0, p_cap - r.shape[1]), value=WILDCARD)
    pat = torch.where(torch.arange(p_cap, device=dev) < read_lens.unsqueeze(1),
                      r, WILDCARD).to(torch.int8)
    res = align_dispatch.align_batch(stage.gwin, pat, read_lens, stage.t_len,
                                     cfg=cfg, backend=backend, p_cap=p_cap)

    # window-relative node offsets -> global path -> backbone position
    rows = torch.arange(stage.gwin.shape[0], device=dev)
    live = res.nodes >= 0
    path = torch.where(live, res.nodes + stage.origin.unsqueeze(1), -1)
    bpath = torch.where(
        live, torch.gather(stage.bwin, 1, res.nodes.clamp(0, t_cap - 1)
                           .to(torch.int64)), -1)
    first = (bpath >= 0).to(torch.int8).argmax(-1)  # first backbone node
    pos = bpath[rows, first]
    failed = res.failed | (~stage.prefilter_ok)
    return GraphMapResult(
        position=torch.where(failed, -1, pos).to(torch.int32),
        distance=torch.where(failed, -1, res.distance).to(torch.int32),
        ops=torch.where(failed.unsqueeze(1), OP_PAD, res.ops),
        n_ops=torch.where(failed, 0, res.n_ops).to(torch.int32),
        path=torch.where(failed.unsqueeze(1), -1, path),
        failed=failed)


def unmapped_result(b: int, *, cfg: GenASMConfig, p_cap: int,
                    device: torch.device | str = "cuda") -> GraphMapResult:
    """The canonical all-failed batch: what `align_winners` emits for a
    failed read, at the ops/path widths an align call would produce, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    cap = cfg.ops_cap(p_cap)
    return GraphMapResult(
        position=torch.full((b,), -1, dtype=torch.int32, device=device),
        distance=torch.full((b,), -1, dtype=torch.int32, device=device),
        ops=torch.full((b, cap), OP_PAD, dtype=torch.int8, device=device),
        n_ops=torch.zeros((b,), dtype=torch.int32, device=device),
        path=torch.full((b, cap), -1, dtype=torch.int64, device=device),
        failed=torch.ones((b,), dtype=torch.bool, device=device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _env_prefilter(prefilter: bool | None) -> bool:
    """None -> the ``REPRO_GRAPH_PREFILTER`` environment default (on unless
    "0"), as the reference resolves it."""
    if prefilter is None:
        return os.environ.get("REPRO_GRAPH_PREFILTER", "1") != "0"
    return bool(prefilter)


class GraphMapExecutor:
    """Host-orchestrated three-stage graph mapper for one geometry.

    Stage A seeds and screens — no DC.  The host reads the survivor
    counts and picks the `tile_rung`; stage B compacts survivors, runs
    the BitAlign filter over ``n_cap`` rows only, and selects winners;
    stage C aligns them.  An all-pruned batch skips B and C entirely
    (`unmapped_result`).  ``last_stats`` holds the previous call's
    pruning/occupancy counters and ``last_times`` its
    ``(stage, t_start, t_end, attrs)`` windows — ``prefilter``,
    ``dc_filter``, ``align`` — which the serve engine forwards into its
    metrics and tracer.
    """

    def __init__(self, *, tile_stride: int,
                 cfg: GenASMConfig = GenASMConfig(),
                 p_cap: int = 256,
                 filter_bits: int = 128,
                 filter_k: int = 12,
                 max_candidates: int = 4,
                 minimizer_w: int = 10,
                 minimizer_k: int = 15,
                 backend: str | None = None,
                 prefilter: bool | None = None):
        if filter_bits % 32:
            raise ValueError(f"filter_bits must be a multiple of 32, got "
                             f"{filter_bits}")
        self.cfg = cfg
        self.p_cap = p_cap
        self.t_cap = p_cap + 2 * cfg.w
        self.tile_stride = tile_stride
        self.max_candidates = max_candidates
        self.prefilter = _env_prefilter(prefilter)
        self._backend = backend
        fbits = min(filter_bits, p_cap)
        self._pf_kw = dict(
            tile_stride=tile_stride, filter_bits=fbits, filter_k=filter_k,
            max_candidates=max_candidates, minimizer_w=minimizer_w,
            minimizer_k=minimizer_k, prefilter=self.prefilter)
        self._stage_kw = dict(
            tile_stride=tile_stride, t_cap=self.t_cap, filter_bits=fbits,
            filter_k=filter_k, max_candidates=max_candidates,
            minimizer_w=minimizer_w, minimizer_k=minimizer_k)
        self.last_stats: dict = {}
        self.last_times: list[tuple[str, float, float, dict]] = []

    def _check_geometry(self, garr: GraphArrays) -> None:
        tile_len = int(garr.tile_gtext.shape[1])
        span = tile_len - self.t_cap
        if span < self.tile_stride:
            raise ValueError(
                f"tile_len {tile_len} leaves a {span}-node anchor search "
                f"span < tile_stride {self.tile_stride} at p_cap "
                f"{self.p_cap}; rebuild the index with window >= "
                f"{self.t_cap}")

    def __call__(self, garr: GraphArrays, reads, read_lens) -> GraphMapResult:
        self._check_geometry(garr)
        dev = garr.bases.device
        backend = graph_backend_name(self._backend, dev)
        reads = torch.as_tensor(reads, device=dev)
        lens = torch.as_tensor(read_lens, device=dev).to(torch.int64)
        b = reads.shape[0]
        slots = b * self.max_candidates
        view = whole_graph_view(garr)
        geom = dict(n_tiles=garr.tile_gtext.shape[0],
                    backbone_len=garr.node_of_backbone.shape[0])
        t0 = time.monotonic()
        pf = tile_prefilter(view, reads, lens, **geom, **self._pf_kw)
        n_keep = pf.n_keep.cpu().numpy()  # host sync ends the prefilter stage
        t1 = time.monotonic()
        total = int(n_keep.sum())
        live = int(pf.n_live.sum())
        n_cap = tile_rung(total, slots)
        self.last_stats = dict(
            candidate_slots=slots, tiles_live=live, tiles_kept=total,
            tiles_pruned=live - total, dc_rows=n_cap, dc_rows_dense=slots,
            reads_zero_survivor=int((n_keep == 0).sum()))
        self.last_times = [("prefilter", t0, t1, {})]
        if total == 0:
            return unmapped_result(b, cfg=self.cfg, p_cap=self.p_cap,
                                   device=dev)
        t2 = time.monotonic()
        st = graph_candidate_stage(view, reads, lens, pf=pf, n_cap=n_cap,
                                   use_kernel=backend == "graph_cuda",
                                   **geom, **self._stage_kw)
        _sync(dev)
        t3 = time.monotonic()
        res = align_winners(st, reads, lens, cfg=self.cfg, p_cap=self.p_cap,
                            backend=backend)
        _sync(dev)
        t4 = time.monotonic()
        self.last_times += [("dc_filter", t2, t3, {"dc_rows": n_cap}),
                            ("align", t3, t4, {})]
        return res


def get_map_executor(**kw) -> GraphMapExecutor:
    """A `GraphMapExecutor` for one static-parameter set (``kw`` as its
    constructor takes them).  The reference caches one per set because
    its stages compile; eager PyTorch compiles nothing, so each call
    builds one."""
    return GraphMapExecutor(**kw)


def map_batch(garr: GraphArrays, reads, read_lens, *, tile_stride: int,
              cfg: GenASMConfig = GenASMConfig(), p_cap: int = 256,
              filter_bits: int = 128, filter_k: int = 12,
              max_candidates: int = 4, minimizer_w: int = 10,
              minimizer_k: int = 15, backend: str | None = None,
              prefilter: bool | None = None) -> GraphMapResult:
    """Map a read batch against the tiled graph index.

    ``garr`` is the device half of a `GraphIndex` built with
    ``tile_stride``.  ``backend`` resolves through `repro_torch.align`
    with linear names mapped to their graph twins.  ``prefilter``
    toggles the q-gram tile screen (None: the ``REPRO_GRAPH_PREFILTER``
    default, on unless "0"); results are bitwise identical either way.
    """
    return get_map_executor(
        tile_stride=tile_stride, cfg=cfg, p_cap=p_cap,
        filter_bits=filter_bits, filter_k=filter_k,
        max_candidates=max_candidates, minimizer_w=minimizer_w,
        minimizer_k=minimizer_k, backend=backend,
        prefilter=prefilter)(garr, reads, read_lens)


def map_batch_index(gidx: GraphIndex, reads, read_lens, **kw
                    ) -> GraphMapResult:
    """`map_batch` with the geometry pulled off a `GraphIndex`."""
    kw.setdefault("minimizer_w", gidx.minimizer_w)
    kw.setdefault("minimizer_k", gidx.minimizer_k)
    return map_batch(gidx.arrays, reads, read_lens,
                     tile_stride=gidx.tile_stride, **kw)
