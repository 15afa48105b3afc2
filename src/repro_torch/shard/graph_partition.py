"""Variation-graph sharding: per-device tile ranges + backbone slices.

Port of `repro.shard.graph_partition`, the graph twin of `partition.py`
(SeGraM §6.5: each channel owns the sub-graph backing its slice of the
linear backbone).  A shard owns a contiguous *backbone* core range; from
it we take, by pure slicing of the already-built global
`repro_torch.graph.index.GraphIndex` arrays:

* the minimizer-table entries whose (global) backbone positions fall in
  the core;
* a haloed ``node_of_backbone`` slice (candidate backbone coordinate →
  node id);
* the contiguous global **tile** range those nodes map to under
  ``node // tile_stride`` — tiles are sliced from the global
  ``tile_gtext``, so per-tile hop masks (and therefore window bytes),
  Bloom words and slack are bit-identical to the whole-graph index;
* the ``backbone`` (node → backbone coordinate) slice covering every
  node of those tiles, so the merged winner's GAF path translates
  without touching any other shard.

Candidates stay in global coordinates end to end (global backbone
positions, tile ids and origin node ids), so the merge is a pure
lexicographic min.  The slicing runs on the source index's device; the
result is placed like a linear sharded index (`partition.place`).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.segram.graph import Variant
from repro_torch.graph.index import (EpochedGraphIndex, GraphIndex,
                                     build_graph_index)

from .partition import (DEFAULT_HALO, ShardLayout, _PAD_HASH, _PAD_POS,
                        part_row, place, plan_layout, replace_row,
                        stack_parts)


class GraphShardArrays(NamedTuple):
    """Device half of a sharded graph index, stacked ``[S, ...]``.

    Row ``i`` is shard ``i``; all ids/positions are global (tile ids via
    ``tile_base``, node ids via ``node_base``, backbone coordinates via
    ``nb_offset`` — each row's arrays are local slices whose first row
    sits at that global coordinate).  Dtypes are `GraphArrays`'.
    """

    tile_gtext: torch.Tensor  # [S, Ct, tile_len] int32 packed local tiles
    tile_valid: torch.Tensor  # [S, Ct] int64 valid node count per tile
    tile_base: torch.Tensor  # [S] int64 global tile id of local row 0
    node_of_backbone: torch.Tensor  # [S, Lb] int64 backbone→node slice
    nb_offset: torch.Tensor  # [S] int64 global backbone coord of row 0
    backbone: torch.Tensor  # [S, Nb] int64 node→backbone slice (-1 pad)
    node_base: torch.Tensor  # [S] int64 global node id of slice row 0
    hashes: torch.Tensor  # [S, Mm] int64 sorted minimizer hashes (uint32)
    positions: torch.Tensor  # [S, Mm] int64 GLOBAL backbone positions
    tile_bloom: torch.Tensor  # [S, Ct, BLOOM_WORDS] int32 q-gram Blooms
    tile_slack: torch.Tensor  # [S, Ct] int64 q-gram-lemma screen slack


@dataclass
class ShardedGraphIndex:
    """Host handle: the placed graph shards + the global geometry statics."""

    parts: tuple  # placement of GraphShardArrays blocks (`partition.place`)
    layout: ShardLayout
    ref: np.ndarray  # host reference copy (GAF tlen, refresh)
    tile_len: int
    tile_stride: int
    n_tiles: int  # global tile count
    n_nodes: int  # global linearized-graph node count
    minimizer_w: int
    minimizer_k: int
    window: int
    margin: int

    @property
    def arrays(self) -> GraphShardArrays:
        """The stacked ``[S, ...]`` arrays, on the first device."""
        return stack_parts(self.parts)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """One device (every shard on it) or one device per shard."""
        return tuple(p.tile_gtext.device for p in self.parts)

    @property
    def device(self) -> torch.device:
        """The first device: where the merge and the align run."""
        return self.parts[0].tile_gtext.device

    @property
    def num_shards(self) -> int:
        """Number of graph shards."""
        return self.layout.num_shards

    @property
    def ref_len(self) -> int:
        """Backbone (linear reference) length in bases."""
        return self.layout.ref_len

    @property
    def layout_key(self) -> tuple:
        """Hashable geometry key (partition + tile pitch + padded dims)."""
        a = self.parts[0]
        return (self.layout.bounds, self.layout.halo, self.tile_len,
                self.tile_stride, int(a.tile_gtext.shape[1]),
                int(a.node_of_backbone.shape[1]), int(a.backbone.shape[1]),
                int(a.hashes.shape[1]))

    def row(self, i: int) -> GraphShardArrays:
        """Shard ``i``'s one-row arrays, on the device that holds it."""
        return part_row(self.parts, i)


def _padded(rows: list[torch.Tensor], fill) -> torch.Tensor:
    """``[S, n, ...]`` stack of ``rows`` padded to the longest with ``fill``."""
    n = max(1, max(r.shape[0] for r in rows))
    out = torch.full((len(rows), n) + tuple(rows[0].shape[1:]), fill,
                     dtype=rows[0].dtype, device=rows[0].device)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


def shard_graph_index(gidx: GraphIndex, num_shards: int, *,
                      halo: int = DEFAULT_HALO,
                      devices: Sequence[torch.device | str] | None = None
                      ) -> ShardedGraphIndex:
    """Slice a built ``GraphIndex`` into per-device shards.

    Pure slicing of the global arrays — tiles, hop masks and minimizer
    entries are exactly the whole-graph ones, which keeps the sharded
    mapper's windows byte-identical to the single-device path.
    ``devices`` defaults to the index's device.
    """
    a = gidx.arrays
    L = int(a.node_of_backbone.shape[0])
    n_tiles, n_nodes = gidx.n_tiles, gidx.n_nodes
    stride = gidx.tile_stride
    layout = plan_layout(L, num_shards, halo)
    ranges = [layout.slice_range(i) for i in range(num_shards)]
    ends = a.node_of_backbone[[i for r in ranges for i in (r[0], r[1] - 1)]]
    ends = ends.tolist()  # the slices' first and last node ids

    cols = {f: [] for f in GraphShardArrays._fields}
    for i in range(num_shards):
        lo, hi = layout.core(i)
        blo, bhi = ranges[i]
        tlo = int(ends[2 * i]) // stride
        thi = min(n_tiles, int(ends[2 * i + 1]) // stride + 1)
        node_lo = tlo * stride
        node_hi = min(n_nodes, (thi - 1) * stride + gidx.tile_len)
        m = (a.idx_positions >= lo) & (a.idx_positions < hi)
        cols["tile_gtext"].append(a.tile_gtext[tlo:thi])
        cols["tile_valid"].append(a.tile_valid[tlo:thi])
        cols["tile_base"].append(tlo)
        cols["node_of_backbone"].append(a.node_of_backbone[blo:bhi])
        cols["nb_offset"].append(blo)
        cols["backbone"].append(a.backbone[node_lo:node_hi])
        cols["node_base"].append(node_lo)
        cols["hashes"].append(a.idx_hashes[m])
        cols["positions"].append(a.idx_positions[m])
        cols["tile_bloom"].append(a.tile_bloom[tlo:thi])
        cols["tile_slack"].append(a.tile_slack[tlo:thi])

    fills = dict(tile_gtext=0, tile_valid=0, node_of_backbone=0, backbone=-1,
                 hashes=_PAD_HASH, positions=_PAD_POS, tile_bloom=0,
                 tile_slack=0)
    stacked = GraphShardArrays(**{
        f: (torch.tensor(v, dtype=torch.int64, device=gidx.device)
            if f in ("tile_base", "nb_offset", "node_base")
            else _padded(v, fills[f]))
        for f, v in cols.items()})
    return ShardedGraphIndex(
        parts=place(stacked, (gidx.device,) if devices is None else
                    tuple(torch.device(d) for d in devices)),
        layout=layout, ref=np.asarray(gidx.ref, np.int8),
        tile_len=gidx.tile_len, tile_stride=stride, n_tiles=n_tiles,
        n_nodes=n_nodes, minimizer_w=gidx.minimizer_w,
        minimizer_k=gidx.minimizer_k, window=gidx.window, margin=gidx.margin)


class EpochedShardedGraphIndex:
    """Epoch-vector-stamped handle around a ``ShardedGraphIndex``.

    Mirrors `partition.EpochedShardedIndex`: ``refresh()`` rebuilds the
    graph from a new reference/variant set (all epochs bump);
    ``refresh_shard(i)`` re-slices shard ``i`` from the retained
    ``GraphIndex`` (failover re-materialization, epoch ``i`` bumps).
    ``current()`` returns the hashable ``(layout_key, epoch vector)``
    token the serve cache keys on.
    """

    def __init__(self, sharded: ShardedGraphIndex, source: GraphIndex, *,
                 variants: Sequence[Variant] = (),
                 epochs: Sequence[int] | None = None):
        self._lock = threading.Lock()
        self._index = sharded
        self._source = source
        self._variants = tuple(variants)
        self.epochs = list(epochs) if epochs is not None \
            else [0] * sharded.num_shards
        if len(self.epochs) != sharded.num_shards:
            raise ValueError(
                f"epoch vector has {len(self.epochs)} entries for "
                f"{sharded.num_shards} shards")
        self._build_kw = dict(
            w=sharded.minimizer_w, k=sharded.minimizer_k,
            tile_stride=sharded.tile_stride, window=sharded.window,
            margin=sharded.margin, device=source.device)
        self._halo = sharded.layout.halo

    @property
    def index(self) -> ShardedGraphIndex:
        """The current ``ShardedGraphIndex`` (unsynchronized peek)."""
        return self._index

    def epoch_token(self) -> tuple:
        """Hashable (layout, epoch-vector) cache-key component."""
        with self._lock:
            return (self._index.layout_key, tuple(self.epochs))

    def current(self) -> tuple[ShardedGraphIndex, tuple]:
        """Consistent (index, epoch token) pair for one mapping batch."""
        with self._lock:
            return self._index, (self._index.layout_key, tuple(self.epochs))

    def refresh(self, ref: np.ndarray,
                variants: Sequence[Variant] | None = None,
                **build_kw) -> tuple:
        """Rebuild graph + shards from a new reference; bumps all epochs."""
        kw = {**self._build_kw, **build_kw}
        vs = self._variants if variants is None else tuple(variants)
        source = build_graph_index(ref, vs, **kw)
        new = shard_graph_index(source, self._index.num_shards,
                                halo=self._halo, devices=self._index.devices)
        with self._lock:
            self._index = new
            self._source = source
            self._variants = vs
            self._build_kw = kw
            self.epochs = [e + 1 for e in self.epochs]
            return (new.layout_key, tuple(self.epochs))

    def refresh_shard(self, i: int) -> tuple:
        """Re-slice shard ``i`` from the retained graph index."""
        if not 0 <= i < self._index.num_shards:
            raise IndexError(f"shard {i} out of range "
                             f"(num_shards={self._index.num_shards})")
        cur = self._index
        fresh = shard_graph_index(self._source, cur.num_shards,
                                  halo=self._halo, devices=cur.devices)
        with self._lock:
            self._index = ShardedGraphIndex(
                parts=replace_row(cur.parts, i, fresh.row(i)),
                layout=cur.layout, ref=cur.ref, tile_len=cur.tile_len,
                tile_stride=cur.tile_stride, n_tiles=cur.n_tiles,
                n_nodes=cur.n_nodes, minimizer_w=cur.minimizer_w,
                minimizer_k=cur.minimizer_k, window=cur.window,
                margin=cur.margin)
            self.epochs[i] += 1
            return (self._index.layout_key, tuple(self.epochs))


def from_epoched_graph(egi: EpochedGraphIndex | GraphIndex, num_shards: int,
                       *, halo: int = DEFAULT_HALO,
                       devices: Sequence[torch.device | str] | None = None
                       ) -> EpochedShardedGraphIndex:
    """Shard an existing (epoched) graph index, reusing its built arrays."""
    if isinstance(egi, EpochedGraphIndex):
        gidx = egi.index
        variants = egi._variants
    else:
        gidx = egi
        variants = ()
    return EpochedShardedGraphIndex(
        shard_graph_index(gidx, num_shards, halo=halo, devices=devices), gidx,
        variants=variants)
