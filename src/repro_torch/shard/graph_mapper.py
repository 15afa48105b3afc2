"""Shard-parallel graph mapping: the GAF twin of `shard.mapper`.

Port of `repro.shard.graph_mapper`.  The whole-graph
`repro_torch.graph.mapper.GraphMapExecutor` pipeline, scattered: every
shard runs the seed + q-gram tile screen (`tile_prefilter`) over its own
:class:`~repro_torch.graph.mapper.GraphView`; the host reads the
per-shard survivor counts and picks one shared `tile_rung`; each shard
compacts its survivors into that many rows and runs the BitAlign filter
over them (`graph_candidate_stage` with ``pf``/``n_cap``; the CUDA
kernel under ``graph_cuda``); the per-shard winners merge on the first
device by an argmin over the packed ``(filter distance, origin node,
tile)`` key (`repro_torch.shard.merge`; ``merge_host`` is its oracle);
and one `align_winners` call aligns them — BitAlign's second call site —
optionally cut into per-shard blocks (``align_sharded``).  Winners carry
their packed window bytes *and* per-node backbone coordinates
(``bwin``), so the align stage needs no graph arrays.  The screen, the
compaction and the merge rule are those of the whole-graph mapper, so
GAF output is byte-identical at 1 and N shards.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.mapper import POS_SENTINEL
from repro_torch.core.segram.graph import HOP_LIMIT
# a name the reference module binds too
from repro_torch.dist import sharding as dist_sharding  # noqa: F401
from repro_torch.graph.mapper import (CandidateStageResult, GraphMapResult,
                                      GraphView, TilePrefilterResult,
                                      _env_prefilter, align_winners,
                                      graph_backend_name,
                                      graph_candidate_stage, tile_prefilter,
                                      tile_rung, unmapped_result)

from . import merge as shard_merge
from .graph_partition import ShardedGraphIndex
# a name the reference module binds too
from .graph_partition import GraphShardArrays  # noqa: F401
from .mapper import (PendingBatch, finish_pending, join_rows, split_rows,
                     sync)


def validate_graph_geometry(sharded: ShardedGraphIndex, *, p_cap: int,
                            filter_k: int, cfg: GenASMConfig) -> None:
    """Raise if the tile/halo geometry cannot cover this mapping setup."""
    t_cap = p_cap + 2 * cfg.w
    span = sharded.tile_len - t_cap
    if span < sharded.tile_stride:
        raise ValueError(
            f"tile_len {sharded.tile_len} leaves a {span}-node anchor "
            f"search span < tile_stride {sharded.tile_stride} at p_cap "
            f"{p_cap}; rebuild the index with window >= {t_cap}")
    need = p_cap + 32 + HOP_LIMIT + filter_k
    if sharded.layout.halo < need:
        raise ValueError(
            f"graph shard halo {sharded.layout.halo} < {need} required "
            f"for p_cap={p_cap}, filter_k={filter_k}; rebuild with "
            f"halo >= {need}")


def shard_view(block, j: int) -> GraphView:
    """Row ``j`` of a `GraphShardArrays` block as a GraphView (offsets as
    0-d tensors on the block's device: no host read)."""
    return GraphView(
        tile_gtext=block.tile_gtext[j], tile_valid=block.tile_valid[j],
        tile_base=block.tile_base[j],
        node_of_backbone=block.node_of_backbone[j],
        nb_offset=block.nb_offset[j], backbone=block.backbone[j],
        node_base=block.node_base[j], idx_hashes=block.hashes[j],
        idx_positions=block.positions[j], tile_bloom=block.tile_bloom[j],
        tile_slack=block.tile_slack[j])


def _views(parts):
    """(view, device) of every shard of a placement, in shard order."""
    return [(shard_view(block, j), block.tile_gtext.device)
            for block in parts
            for j in range(block.tile_gtext.shape[0])]


class ShardedGraphMapExecutor:
    """Scatter/screen/merge/align pipeline for one sharded graph.

    Mirrors `graph.mapper.GraphMapExecutor` across shards: a per-shard
    prefilter, a host read of the survivor counts that picks one
    `tile_rung` from the worst shard, a per-shard compacted candidate
    stage, the device merge and one align stage.  ``last_stats`` carries
    the pruning/occupancy counters for the engine.
    """

    def __init__(self, sharded: ShardedGraphIndex, *,
                 cfg: GenASMConfig = GenASMConfig(),
                 p_cap: int = 256,
                 filter_bits: int = 128,
                 filter_k: int = 12,
                 shard_candidates: int = 4,
                 backend: str | None = None,
                 align_sharded: bool = False,
                 prefilter: bool | None = None):
        validate_graph_geometry(sharded, p_cap=p_cap, filter_k=filter_k,
                                cfg=cfg)
        shard_merge.check_graph_domain(n_tiles=sharded.n_tiles,
                                       filter_k=filter_k)
        self.align_sharded = align_sharded
        self.num_shards = sharded.num_shards
        self.backend = graph_backend_name(backend, sharded.device)
        self.cfg = cfg
        self.p_cap = p_cap
        self.shard_candidates = shard_candidates
        self.prefilter = prefilter = _env_prefilter(prefilter)
        self._align_stage_name = "align_shard" if align_sharded else "align"
        fbits = min(filter_bits, p_cap)
        geom = dict(tile_stride=sharded.tile_stride, n_tiles=sharded.n_tiles,
                    backbone_len=sharded.ref_len, filter_bits=fbits,
                    filter_k=filter_k, max_candidates=shard_candidates,
                    minimizer_w=sharded.minimizer_w,
                    minimizer_k=sharded.minimizer_k)
        self._pf_kw = dict(geom, prefilter=prefilter)
        self._stage_kw = dict(geom, t_cap=p_cap + 2 * cfg.w,
                              use_kernel=self.backend == "graph_cuda")
        self.last_stats: dict = {}
        # (stage, t0, t1, attrs) monotonic windows from the last call —
        # the serve engine replays them as child spans of its flush span
        self.last_times: list[tuple[str, float, float, dict]] = []

    def screen(self, parts, reads, read_lens) -> list[TilePrefilterResult]:
        """Stage A on every shard: seeds + tile screen, one result each."""
        out = []
        for view, dev in _views(parts):
            out.append(tile_prefilter(
                view, torch.as_tensor(reads, device=dev),
                torch.as_tensor(read_lens, device=dev).to(torch.int64),
                **self._pf_kw))
        return out

    def candidates(self, parts, reads, read_lens, pfs, n_cap: int
                   ) -> CandidateStageResult:
        """Stage B on every shard: the compacted BitAlign filter at rung
        ``n_cap`` and each read's winner, stacked ``[S, B, ...]`` on the
        first shard's device."""
        outs = []
        for (view, dev), pf in zip(_views(parts), pfs):
            outs.append(graph_candidate_stage(
                view, torch.as_tensor(reads, device=dev),
                torch.as_tensor(read_lens, device=dev).to(torch.int64),
                pf=pf, n_cap=n_cap, **self._stage_kw))
        home = outs[0].distance.device
        return CandidateStageResult(*(
            torch.stack([o[f].to(home) for o in outs])
            for f in range(len(CandidateStageResult._fields))))

    @staticmethod
    def merge_host(st: CandidateStageResult) -> CandidateStageResult:
        """Host merge: lex ``(distance, origin, tile)`` per read.

        The independently coded oracle of `merge_device` (numpy leaves).
        Identical windows duplicated across neighbouring shards' halos
        collapse because their full sort key is equal.
        """
        d = st.distance.cpu().numpy()
        origin = st.origin.cpu().numpy()
        tile = st.tile.cpu().numpy()
        dm = d.min(axis=0, keepdims=True)
        om = np.where(d == dm, origin, POS_SENTINEL)
        omin = om.min(axis=0, keepdims=True)
        tm = np.where(om == omin, tile, POS_SENTINEL)
        win = tm.argmin(axis=0)
        cols = np.arange(d.shape[1])
        return CandidateStageResult(*(a.cpu().numpy()[win, cols] for a in st))

    @staticmethod
    def merge_device(st: CandidateStageResult) -> CandidateStageResult:
        """Packed-key argmin-reduce on the stage's device: `merge_host`'s
        winner and tie-break, with no host round trip."""
        *fields, _win = shard_merge.merge_graph(*st)
        return CandidateStageResult(*fields)

    def _align(self, merged: CandidateStageResult, reads, read_lens,
               devices=()) -> GraphMapResult:
        """`align_winners` on the merged winners (on their device); with
        ``align_sharded``, ``[S, B/S]`` blocks, block ``i`` on
        ``devices[i]`` when one device per shard is given."""
        home = merged.distance.device
        reads = torch.as_tensor(reads, device=home)
        lens = torch.as_tensor(read_lens, device=home).to(torch.int32)
        kw = dict(cfg=self.cfg, p_cap=self.p_cap, backend=self.backend)
        if not self.align_sharded:
            return align_winners(merged, reads, lens, **kw)
        s = self.num_shards
        n_f = len(merged)
        outs = []
        for i, blk in enumerate(split_rows(s, *merged, reads, lens)):
            dev = devices[i] if len(devices) == s else home
            blk = [x.to(dev) for x in blk]
            outs.append(align_winners(CandidateStageResult(*blk[:n_f]),
                                      blk[n_f], blk[n_f + 1], **kw))
        return join_rows(outs, reads.shape[0], home)

    def start(self, parts, reads, read_lens, *,
              timed: bool = True) -> PendingBatch:
        """Dispatch screen → scatter → device merge → align.

        The host reads the survivor counts after the screen (the rung
        depends on them); everything after stays on the device until
        `finish`.  ``timed=False`` skips the synchronise at each later
        stage boundary.  An all-pruned batch returns the canonical
        unmapped result, already on the host (``tail=None``).
        """
        devices = tuple(p.tile_gtext.device for p in parts)
        b = int(reads.shape[0])
        slots = b * self.shard_candidates
        t0 = time.monotonic()
        pfs = self.screen(parts, reads, read_lens)
        n_keep = torch.stack([pf.n_keep.to(devices[0]) for pf in pfs]
                             ).cpu().numpy()  # [S, B]: ends the prefilter
        t1 = time.monotonic()
        kept = int(n_keep.sum())
        live = int(sum(int(pf.n_live.sum()) for pf in pfs))
        # one rung for all shards: the worst shard's survivor count
        n_cap = tile_rung(int(n_keep.sum(axis=1).max()), slots)
        stats = dict(
            candidate_slots=self.num_shards * slots, tiles_live=live,
            tiles_kept=kept, tiles_pruned=live - kept,
            dc_rows=self.num_shards * n_cap,
            dc_rows_dense=self.num_shards * slots,
            reads_zero_survivor=int((n_keep.sum(axis=0) == 0).sum()))
        self.last_stats = stats
        times = [("prefilter", t0, t1, {"shards": self.num_shards})]
        if n_cap == 0:
            res = unmapped_result(b, cfg=self.cfg, p_cap=self.p_cap,
                                  device="cpu")  # on the host, as documented
            return PendingBatch(res=res, times=tuple(times), t_dispatch=t1,
                                tail=None, stats=stats)
        t2 = time.monotonic()
        st = self.candidates(parts, reads, read_lens, pfs, n_cap)
        if timed:
            sync(devices)
            t3 = time.monotonic()
            times.append(("dc_filter", t2, t3,
                          {"dc_rows": self.num_shards * n_cap}))
        merged = self.merge_device(st)
        if timed:
            sync(devices)
            t4 = time.monotonic()
            times.append(("merge_device", t3, t4,
                          {"shards": self.num_shards}))
        else:
            t4 = time.monotonic()
        res = self._align(merged, reads, read_lens, devices)
        return PendingBatch(res=res, times=tuple(times), t_dispatch=t4,
                            tail=(self._align_stage_name,
                                  {"sharded": self.align_sharded}),
                            stats=stats)

    finish = staticmethod(finish_pending)

    def __call__(self, parts, reads, read_lens) -> GraphMapResult:
        """Map one batch: screen → scatter → device merge → align."""
        res, times = self.finish(self.start(parts, reads, read_lens))
        self.last_times = list(times)
        return res


# bounded LRU, mirroring shard.mapper
_EXECUTORS: OrderedDict[tuple, ShardedGraphMapExecutor] = OrderedDict()
_EXECUTOR_CACHE_CAP = 8


def get_graph_executor(
    sharded: ShardedGraphIndex,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int = 256,
    filter_bits: int = 128,
    filter_k: int = 12,
    shard_candidates: int = 4,
    backend: str | None = None,
    prefilter: bool | None = None,
    align_sharded: bool = False,
) -> ShardedGraphMapExecutor:
    """Cached :class:`ShardedGraphMapExecutor` per (geometry, params)."""
    prefilter = _env_prefilter(prefilter)
    key = (sharded.layout_key, sharded.device, cfg, p_cap, filter_bits,
           filter_k, shard_candidates, backend, prefilter, align_sharded)
    ex = _EXECUTORS.get(key)
    if ex is None:
        ex = ShardedGraphMapExecutor(
            sharded, cfg=cfg, p_cap=p_cap, filter_bits=filter_bits,
            filter_k=filter_k, shard_candidates=shard_candidates,
            backend=backend, prefilter=prefilter,
            align_sharded=align_sharded)
        _EXECUTORS[key] = ex
        while len(_EXECUTORS) > _EXECUTOR_CACHE_CAP:
            _EXECUTORS.popitem(last=False)
    else:
        _EXECUTORS.move_to_end(key)
    return ex


def map_batch_sharded_graph(
    sharded: ShardedGraphIndex,
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
    align_sharded: bool = False,
    pipelined: bool = False,
) -> GraphMapResult:
    """Map a read batch against a sharded variation-graph index.

    Returns the single-device `graph.mapper.map_batch`'s `GraphMapResult`
    (on the host) — byte-identical positions, CIGARs and GAF node paths
    at any shard count, with the tile screen on or off.  ``pipelined``
    dispatches through the untimed `start`/`finish` surface.
    """
    ex = get_graph_executor(
        sharded, cfg=cfg, p_cap=p_cap, filter_bits=filter_bits,
        filter_k=filter_k, shard_candidates=shard_candidates,
        backend=backend, prefilter=prefilter, align_sharded=align_sharded)
    reads = torch.as_tensor(reads)
    if pipelined:
        res, times = ex.finish(ex.start(sharded.parts, reads, read_lens,
                                        timed=False))
        ex.last_times = list(times)
        return res
    return ex(sharded.parts, reads, read_lens)
