"""Tiled graph-reference index: graphs far longer than one BitAlign window.

Port of `repro.graph.index`.  The whole linearized graph lives on the
device once, *plus* a tiled view: overlapping fixed-size tiles at
``tile_stride`` node pitch, each packed as graph text
(`windowed.pack_graph_text`) with its hopBits cut at the tile boundary
by the one shared masking rule (`core/segram/graph.hop_boundary_mask`).
A candidate backbone position maps to a tile via ``node //
tile_stride``, so the mapper's candidate windows are one gather
``tile_gtext[tile_ids]`` per batch.

Tile geometry: ``tile_len = tile_stride + margin + window``.  A
candidate's anchor is refined inside ``[0, tile_stride + margin)`` and
``window`` nodes of alignment text always remain past any refined
anchor.

Integer conventions: uint32 arrays of the reference (hopBits, packed
tiles, Bloom words) are int32 bit patterns; hashes, positions, node ids
and counts are int64, as the linear index keeps them.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitvector import SENTINEL
from repro_torch.core.filter import QGRAM_Q, qgram_bloom
from repro_torch.core.segram.graph import (GenomeGraph, Variant, build_graph,
                                           hop_boundary_mask)
from repro_torch.core.segram.minimizer import build_index

from .windowed import pack_graph_text

DEFAULT_WINDOW = 256
DEFAULT_STRIDE = 64
DEFAULT_MARGIN = 64
# tiles built per step: bounds the q-gram Bloom intermediates (~70 MB of
# int64 codes and hashes per 1,024 tiles of 1,536 nodes)
TILE_CHUNK = 1024


class GraphArrays(NamedTuple):
    """Device half of the index."""

    bases: torch.Tensor  # [N] int8 linearized graph
    succ_bits: torch.Tensor  # [N] int32 hopBits
    backbone: torch.Tensor  # [N] int64 backbone coord (-1 for alt nodes)
    node_of_backbone: torch.Tensor  # [L] int64
    tile_gtext: torch.Tensor  # [C, tile_len] int32 packed tiles
    tile_valid: torch.Tensor  # [C] int64 valid node count per tile
    idx_hashes: torch.Tensor  # [M] int64 sorted backbone minimizers
    idx_positions: torch.Tensor  # [M] int64
    tile_bloom: torch.Tensor  # [C, BLOOM_WORDS] int32 per-tile q-gram Bloom
    tile_slack: torch.Tensor  # [C] int64 (q-1)·(hop>1 edges) screen slack


@dataclass
class GraphIndex:
    """Host handle: device arrays + the static geometry the mapper needs."""

    arrays: GraphArrays
    ref: np.ndarray  # host reference copy (GAF tlen, refresh)
    tile_len: int
    tile_stride: int
    minimizer_w: int
    minimizer_k: int
    window: int = DEFAULT_WINDOW  # recorded so refresh() reproduces geometry
    margin: int = DEFAULT_MARGIN

    @property
    def n_nodes(self) -> int:
        return int(self.arrays.bases.shape[0])

    @property
    def n_tiles(self) -> int:
        return int(self.arrays.tile_gtext.shape[0])

    @property
    def ref_len(self) -> int:
        return int(len(self.ref))

    @property
    def device(self) -> torch.device:
        return self.arrays.bases.device


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 bit patterns (SWAR), as int64 counts."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _build_tiles(bases: torch.Tensor, succ: torch.Tensor, *, tile_len: int,
                 tile_stride: int, chunk: int = TILE_CHUNK):
    """(packed tiles, valid counts, Bloom words, slack), built in chunks of
    ``chunk`` tiles on the arrays' device."""
    dev = bases.device
    n = bases.shape[0]
    c = max(1, -(-int(n) // tile_stride))
    parts = []
    for c0 in range(0, c, chunk):
        starts = torch.arange(c0, min(c, c0 + chunk), device=dev) * tile_stride
        idx = starts.unsqueeze(1) + torch.arange(tile_len, device=dev)
        inb = idx < n
        idxc = idx.clamp(0, n - 1)
        tb = torch.where(inb, bases[idxc], SENTINEL).to(torch.int8)
        ts = torch.where(inb, succ[idxc], 0)
        valid = (n - starts).clamp(0, tile_len)
        ts_m = ts & hop_boundary_mask(tile_len, valid)
        # tile pre-filter payload: a Bloom filter over the tile's q-grams and
        # the q-gram-lemma slack for alt paths — a matching path may spell up
        # to q-1 q-grams across each hop>1 edge (bits 1.. of the masked
        # hopBits) that are not substrings of the linearization
        bloom = qgram_bloom(tb, valid)
        in_valid = torch.arange(tile_len, device=dev) < valid.unsqueeze(1)
        hop_edges = torch.where(in_valid, popcount32((ts_m >> 1) & 0x7FFFFFFF),
                                0)
        slack = (QGRAM_Q - 1) * hop_edges.sum(-1)
        parts.append((pack_graph_text(tb, ts_m), valid, bloom, slack))
    return tuple(torch.cat(p) for p in zip(*parts))


# the port's dtype of every GraphArrays field
_DTYPES = dict(bases=np.int8, succ_bits=np.int32, backbone=np.int64,
               node_of_backbone=np.int64, tile_gtext=np.int32,
               tile_valid=np.int64, idx_hashes=np.int64,
               idx_positions=np.int64, tile_bloom=np.int32,
               tile_slack=np.int64)


def _to_device(x, name: str, device) -> torch.Tensor:
    """Host array -> field ``name``'s tensor (uint32 words as int32 bit
    patterns where the field holds words)."""
    x = np.asarray(x)
    dtype = _DTYPES[name]
    if x.dtype == np.uint32 and dtype == np.int32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x.astype(dtype))).to(device)


def _arrays(bases, succ, backbone, node_of_backbone, hashes, positions, *,
            tile_len: int, tile_stride: int, device) -> GraphArrays:
    """`GraphArrays` on ``device`` from host arrays; tiles, Bloom words and
    slack are derived on the device."""
    b = _to_device(bases, "bases", device)
    s = _to_device(succ, "succ_bits", device)
    tiles, valid, bloom, slack = _build_tiles(b, s, tile_len=tile_len,
                                              tile_stride=tile_stride)
    return GraphArrays(
        bases=b, succ_bits=s,
        backbone=_to_device(backbone, "backbone", device),
        node_of_backbone=_to_device(node_of_backbone, "node_of_backbone",
                                    device),
        tile_gtext=tiles, tile_valid=valid,
        idx_hashes=_to_device(hashes, "idx_hashes", device),
        idx_positions=_to_device(positions, "idx_positions", device),
        tile_bloom=bloom, tile_slack=slack)


def build_graph_index(
    ref: np.ndarray,
    variants: Sequence[Variant] = (),
    *,
    w: int = 10,
    k: int = 15,
    freq_frac: float = 0.0002,
    window: int = DEFAULT_WINDOW,
    tile_stride: int = DEFAULT_STRIDE,
    margin: int = DEFAULT_MARGIN,
    graph: GenomeGraph | None = None,
    device: torch.device | str = "cuda",
) -> GraphIndex:
    """Offline pre-processing (paper §6.5): graph + minimizers + tiles.

    The graph is built on the host; minimizer sampling, tiles and Bloom
    filters on ``device`` (the card unless the caller passes
    ``device="cpu"``).  ``window`` must cover the largest alignment text
    cap the mapper will slice (``p_cap + 2·cfg.w``);
    `repro_torch.graph.mapper` checks.
    """
    device = resolve_device(device)
    g = graph if graph is not None else build_graph(ref, list(variants))
    idx = build_index(ref, w=w, k=k, freq_frac=freq_frac, device=device)
    tile_len = tile_stride + margin + window
    arrays = _arrays(g.bases, g.succ_bits, g.backbone, g.node_of_backbone,
                     idx.hashes, idx.positions, tile_len=tile_len,
                     tile_stride=tile_stride, device=device)
    return GraphIndex(arrays=arrays, ref=np.asarray(ref, np.int8),
                      tile_len=tile_len, tile_stride=tile_stride,
                      minimizer_w=w, minimizer_k=k, window=window,
                      margin=margin)


def graph_index_from_arrays(ref, arrays, *, tile_len: int, tile_stride: int,
                            minimizer_w: int, minimizer_k: int, window: int,
                            margin: int,
                            device: torch.device | str = "cuda") -> GraphIndex:
    """A `GraphIndex` on ``device`` from an index built elsewhere.

    ``arrays`` has the fields of the reference's ``GraphArrays`` as
    numpy arrays (``np.asarray`` of each; uint32 words are carried as
    their int32 bit patterns).  Every field is carried over as given,
    tiles, Bloom words and slack included.
    """
    device = resolve_device(device)
    return GraphIndex(
        arrays=GraphArrays(**{
            name: _to_device(getattr(arrays, name), name, device)
            for name in GraphArrays._fields}),
        ref=np.asarray(ref, np.int8), tile_len=tile_len,
        tile_stride=tile_stride, minimizer_w=minimizer_w,
        minimizer_k=minimizer_k, window=window, margin=margin)


class EpochedGraphIndex:
    """Epoch-stamped handle around a ``GraphIndex`` (serving hot swap).

    ``refresh()`` rebuilds from a new reference and/or variant list on
    the same device and bumps ``epoch``; the serve engine's result cache
    keys on the epoch, so every result mapped against the old graph is
    invalidated, and its executors are keyed on the new tile geometry.
    """

    def __init__(self, index: GraphIndex, *, variants: Sequence[Variant] = (),
                 epoch: int = 0, **build_kw):
        self._lock = threading.Lock()
        self._index = index
        self._variants = tuple(variants)
        self.epoch = epoch
        kw = dict(w=index.minimizer_w, k=index.minimizer_k,
                  tile_stride=index.tile_stride, window=index.window,
                  margin=index.margin, device=index.device)
        kw.update(build_kw)  # explicit build kwargs win
        self._build_kw = kw

    @property
    def index(self) -> GraphIndex:
        return self._index

    def current(self) -> tuple[GraphIndex, int]:
        """Consistent (index, epoch) pair for one mapping batch."""
        with self._lock:
            return self._index, self.epoch

    def refresh(self, ref: np.ndarray,
                variants: Sequence[Variant] | None = None, **build_kw) -> int:
        """Rebuild from a new reference/variant set; returns the new epoch."""
        kw = {**self._build_kw, **build_kw}
        vs = self._variants if variants is None else tuple(variants)
        new = build_graph_index(ref, vs, **kw)
        with self._lock:
            self._index = new
            self._variants = vs
            self._build_kw = kw
            self.epoch += 1
            return self.epoch


def build_epoched_graph_index(ref: np.ndarray,
                              variants: Sequence[Variant] = (),
                              **build_kw) -> EpochedGraphIndex:
    """Build a graph index wrapped in an epoch-stamped serving handle."""
    return EpochedGraphIndex(build_graph_index(ref, variants, **build_kw),
                             variants=variants, **build_kw)


def save_graph_index(path: str | Path, gidx: GraphIndex) -> None:
    """Persist to npz in the reference's layout and dtypes (tiles are
    re-derived on load, not stored)."""
    a = gidx.arrays
    np.savez_compressed(
        path,
        bases=a.bases.cpu().numpy(),
        succ_bits=a.succ_bits.cpu().numpy().view(np.uint32),
        backbone=a.backbone.cpu().numpy().astype(np.int32),
        node_of_backbone=a.node_of_backbone.cpu().numpy().astype(np.int32),
        idx_hashes=a.idx_hashes.cpu().numpy().astype(np.uint32),
        idx_positions=a.idx_positions.cpu().numpy().astype(np.int32),
        ref=np.asarray(gidx.ref),
        meta=np.asarray([gidx.tile_len, gidx.tile_stride, gidx.minimizer_w,
                         gidx.minimizer_k, gidx.window, gidx.margin],
                        np.int64),
    )


def load_graph_index(path: str | Path,
                     device: torch.device | str = "cuda") -> GraphIndex:
    """Read an npz written by `save_graph_index` (or by the reference's
    `repro.graph.index.save_graph_index`) onto ``device``."""
    device = resolve_device(device)
    with np.load(path) as z:
        tile_len, tile_stride, w, k, window, margin = (
            int(x) for x in z["meta"])
        arrays = _arrays(z["bases"], z["succ_bits"], z["backbone"],
                         z["node_of_backbone"], z["idx_hashes"],
                         z["idx_positions"], tile_len=tile_len,
                         tile_stride=tile_stride, device=device)
        return GraphIndex(arrays=arrays, ref=z["ref"].astype(np.int8),
                          tile_len=tile_len, tile_stride=tile_stride,
                          minimizer_w=w, minimizer_k=k, window=window,
                          margin=margin)
