"""Reference partitioning: per-device shards with overlap halos.

Port of `repro.shard.partition`.  The survey scales GenASM/SeGraM by
giving every accelerator channel a contiguous slice of the reference
plus the index entries that land in it (GenASM §4, SeGraM §6.5); each
channel seeds and filters independently and a cheap merge picks the
global winner.  This module is that layout for torch devices:

* ``ShardLayout`` cuts ``[0, ref_len)`` into ``num_shards`` contiguous
  *core* ranges.  Shard ``i`` holds the haloed slice ``[lo_i - halo,
  hi_i + halo)``, so every filter region and alignment window anchored
  in its core lies inside the slice; windows that straddle a cut appear
  byte-identically in both neighbours and collapse at the merge.
* The minimizer table is built (or reused) **globally** — frequency
  filtering sees global counts — then split by position: shard ``i``
  owns the entries with ``lo_i <= pos < hi_i``.  Positions stay global,
  so per-shard candidates merge without translation.
* The device half is stacked ``[S, ...]`` and padded to common shapes
  (sentinel bases, a hash that sorts last).  Its **placement** is one
  stacked block on one device (every shard's stage then runs there, one
  row after another), or one one-row block per shard on ``devices[i]``
  when the caller gives one device per shard (`resolve_devices`).

``EpochedShardedIndex`` mirrors the single-device epoch handle, but the
epoch is a **vector** (one counter per shard) and ``current()`` returns
the hashable ``(layout_key, epoch vector)`` token that `serve/cache.py`
keys on, so a single-shard refresh (failover re-materialization) never
aliases a cache entry from another shard state.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitvector import SENTINEL
from repro_torch.core.minimizer_index import EpochedIndex, ReferenceIndex
from repro_torch.core.segram.minimizer import build_index

DEFAULT_HALO = 1024
_PAD_HASH = 0xFFFFFFFF  # held in int64, so it sorts last; no seed hashes it
_PAD_POS = 2 ** 30


def resolve_devices(spec: str, num_shards: int) -> tuple[torch.device, ...]:
    """The shard placement that a ``--device`` string asks for.

    A comma-separated list names one device per shard (``cuda:0,cuda:1``;
    the same device may repeat).  A bare ``cuda`` with at least
    ``num_shards > 1`` visible cards spreads the shards over ``cuda:0``
    .. ``cuda:{S-1}``.  Any other single device holds every shard.  A
    CUDA device must be visible: nothing falls back to the CPU.
    """
    devices = tuple(resolve_device(d.strip()) for d in spec.split(","))
    if len(devices) > 1:
        if len(devices) != num_shards:
            raise ValueError(f"--device lists {len(devices)} devices for "
                             f"{num_shards} shards")
        return devices
    dev = devices[0]
    if (dev.type == "cuda" and dev.index is None and num_shards > 1
            and torch.cuda.device_count() >= num_shards):
        return tuple(torch.device("cuda", i) for i in range(num_shards))
    return devices


class ShardLayout(NamedTuple):
    """Contiguous core partition of ``[0, ref_len)`` plus the halo width.

    ``bounds`` has ``num_shards + 1`` entries; shard ``i`` owns core
    ``[bounds[i], bounds[i+1])`` and holds the slice
    ``[max(0, bounds[i] - halo), min(ref_len, bounds[i+1] + halo))``.
    """

    bounds: tuple[int, ...]
    halo: int
    ref_len: int

    @property
    def num_shards(self) -> int:
        """Number of shards in the layout."""
        return len(self.bounds) - 1

    def core(self, i: int) -> tuple[int, int]:
        """Global ``[lo, hi)`` core range owned by shard ``i``."""
        return self.bounds[i], self.bounds[i + 1]

    def slice_range(self, i: int) -> tuple[int, int]:
        """Global ``[lo, hi)`` range of shard ``i``'s haloed slice."""
        lo, hi = self.core(i)
        return max(0, lo - self.halo), min(self.ref_len, hi + self.halo)

    def shard_of(self, pos: int) -> int:
        """Index of the shard whose core contains global position ``pos``."""
        return int(np.searchsorted(np.asarray(self.bounds), pos,
                                   side="right") - 1)


def plan_layout(ref_len: int, num_shards: int,
                halo: int = DEFAULT_HALO) -> ShardLayout:
    """Equal-size contiguous core partition of a ``ref_len``-bp reference."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    bounds = tuple(round(i * ref_len / num_shards)
                   for i in range(num_shards + 1))
    if len(set(bounds)) != num_shards + 1:
        raise ValueError(
            f"reference of {ref_len} bp is too short for {num_shards} "
            f"shards (empty core range)")
    return ShardLayout(bounds=bounds, halo=halo, ref_len=ref_len)


class ShardArrays(NamedTuple):
    """Device half of a sharded linear index, stacked ``[S, ...]``.

    Row ``i`` is shard ``i``; rows are padded to common shapes (refs
    with sentinel bases, tables with a sorts-last hash), and
    ``positions`` are *global* reference coordinates.
    """

    refs: torch.Tensor  # [S, Lm] int8 haloed slices (sentinel padded)
    offsets: torch.Tensor  # [S] int64 global coord of each slice's base 0
    hashes: torch.Tensor  # [S, Mm] int64 sorted minimizer hashes (uint32)
    positions: torch.Tensor  # [S, Mm] int64 GLOBAL minimizer positions


def rows_of(block, i: int, n: int = 1):
    """Rows ``[i, i+n)`` of a stacked block (any arrays NamedTuple)."""
    return type(block)(*(a[i: i + n] for a in block))


def place(stacked, devices: Sequence[torch.device]) -> tuple:
    """Lay a stacked ``[S, ...]`` block out on ``devices``: one block on
    one device, or one one-row block per shard on ``devices[i]``."""
    kind = type(stacked)
    if len(devices) == 1:
        return (kind(*(a.to(devices[0]) for a in stacked)),)
    s = stacked[0].shape[0]
    if len(devices) != s:
        raise ValueError(f"{len(devices)} devices for {s} shards")
    return tuple(kind(*(a[i: i + 1].to(d) for a in stacked))
                 for i, d in enumerate(devices))


def stack_parts(parts: Sequence):
    """The ``[S, ...]`` stack of a placement's blocks, on the first
    block's device (the block itself when there is only one)."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0][0].device
    return type(parts[0])(*(torch.cat([p[f].to(dev) for p in parts])
                            for f in range(len(parts[0]))))


def part_row(parts: Sequence, i: int):
    """Shard ``i``'s one-row block, on the device that holds it."""
    if len(parts) == 1:
        return rows_of(parts[0], i)
    return parts[i]


def replace_row(parts: Sequence, i: int, row) -> tuple:
    """A new placement with shard ``i``'s row replaced (``row`` is a
    one-row block); the old placement is left as it was."""
    if len(parts) > 1:
        new = list(parts)
        new[i] = type(row)(*(r.to(p.device) for r, p in zip(row, parts[i])))
        return tuple(new)
    out = []
    for a, r in zip(parts[0], row):
        a = a.clone()
        a[i: i + 1] = r.to(a.device)
        out.append(a)
    return (type(parts[0])(*out),)


@dataclass
class ShardedIndex:
    """Host handle: the placed shard arrays + layout + seeding parameters.

    ``parts`` is the placement (see `place`): one stacked block, or one
    one-row block per shard.  ``arrays`` is the ``[S, ...]`` stack.
    """

    parts: tuple
    layout: ShardLayout
    minimizer_w: int
    minimizer_k: int
    freq_frac: float = 0.0002

    @property
    def arrays(self) -> ShardArrays:
        """The stacked ``[S, ...]`` arrays, on the first device."""
        return stack_parts(self.parts)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """One device (every shard on it) or one device per shard."""
        return tuple(p.refs.device for p in self.parts)

    @property
    def device(self) -> torch.device:
        """The first device: where the merge and the align run."""
        return self.parts[0].refs.device

    @property
    def num_shards(self) -> int:
        """Number of reference shards."""
        return self.layout.num_shards

    @property
    def ref_len(self) -> int:
        """Global reference length in bases."""
        return self.layout.ref_len

    @property
    def layout_key(self) -> tuple:
        """Hashable geometry key (partition bounds + padded array dims)."""
        p = self.parts[0]
        return (self.layout.bounds, self.layout.halo, self.layout.ref_len,
                int(p.refs.shape[1]), int(p.hashes.shape[1]))

    def row(self, i: int) -> ShardArrays:
        """Shard ``i``'s one-row arrays, on the device that holds it."""
        return part_row(self.parts, i)


def _partition_table(hashes: np.ndarray, positions: np.ndarray,
                     layout: ShardLayout) -> list[tuple[np.ndarray,
                                                        np.ndarray]]:
    """Split a sorted global (hash, position) table by core ownership.

    Filtering rows preserves the sort (by hash, then position), so each
    shard's subset is directly ``searchsorted``-able.
    """
    out = []
    for i in range(layout.num_shards):
        lo, hi = layout.core(i)
        m = (positions >= lo) & (positions < hi)
        out.append((hashes[m], positions[m]))
    return out


def _stack_shards(ref: np.ndarray, layout: ShardLayout,
                  tables: Sequence[tuple[np.ndarray, np.ndarray]]
                  ) -> ShardArrays:
    """Host ``[S, ...]`` shard arrays (CPU tensors) of a partition."""
    s = layout.num_shards
    ranges = [layout.slice_range(i) for i in range(s)]
    lm = max(hi - lo for lo, hi in ranges)
    mm = max(1, max(len(h) for h, _ in tables))
    refs = np.full((s, lm), SENTINEL, np.int8)
    hashes = np.full((s, mm), _PAD_HASH, np.int64)
    positions = np.full((s, mm), _PAD_POS, np.int64)
    offsets = np.zeros(s, np.int64)
    for i, (lo, hi) in enumerate(ranges):
        refs[i, : hi - lo] = ref[lo:hi]
        offsets[i] = lo
        h, p = tables[i]
        hashes[i, : len(h)] = h
        positions[i, : len(p)] = p
    return ShardArrays(*(torch.from_numpy(a)
                         for a in (refs, offsets, hashes, positions)))


def build_sharded_index(
    ref: np.ndarray,
    num_shards: int,
    *,
    w: int = 10,
    k: int = 15,
    freq_frac: float = 0.0002,
    halo: int = DEFAULT_HALO,
    hashes: np.ndarray | None = None,
    positions: np.ndarray | None = None,
    devices: Sequence[torch.device | str] = ("cuda",),
) -> ShardedIndex:
    """Partition a reference (and its global minimizer table) into shards
    placed on ``devices`` (one device, or one per shard; the card unless
    the caller passes ``("cpu",)``).

    The minimizer table is built globally (global frequency filter, as
    in the paper's offline pre-processing) unless an existing global
    ``hashes``/``positions`` pair is passed — `from_epoched` reuses the
    single-device index's table so 1-shard and N-shard serving seed
    from literally the same entries.
    """
    ref = np.asarray(ref, np.int8)
    devices = tuple(resolve_device(d) for d in devices)
    layout = plan_layout(len(ref), num_shards, halo)
    if hashes is None or positions is None:
        idx = build_index(ref, w=w, k=k, freq_frac=freq_frac,
                          device=devices[0])
        hashes, positions = idx.hashes, idx.positions
    tables = _partition_table(np.asarray(hashes, np.int64),
                              np.asarray(positions, np.int64), layout)
    return ShardedIndex(parts=place(_stack_shards(ref, layout, tables),
                                    devices),
                        layout=layout, minimizer_w=w, minimizer_k=k,
                        freq_frac=freq_frac)


class EpochedShardedIndex:
    """Epoch-vector-stamped handle around a ``ShardedIndex``.

    One epoch counter per shard: ``refresh()`` (new reference) bumps
    every counter, ``refresh_shard(i)`` (failover re-materialization of
    a lost device's slice) bumps only shard ``i``'s.  ``current()``
    returns ``(index, token)`` where the token is the hashable
    ``(layout_key, epoch vector)`` pair the serve cache keys on.
    """

    def __init__(self, index: ShardedIndex, ref: np.ndarray,
                 epochs: Sequence[int] | None = None):
        self._lock = threading.Lock()
        self._index = index
        self._ref = np.asarray(ref, np.int8)
        self.epochs = list(epochs) if epochs is not None \
            else [0] * index.num_shards
        if len(self.epochs) != index.num_shards:
            raise ValueError(
                f"epoch vector has {len(self.epochs)} entries for "
                f"{index.num_shards} shards")
        self._build_kw = dict(w=index.minimizer_w, k=index.minimizer_k,
                              freq_frac=index.freq_frac,
                              halo=index.layout.halo, devices=index.devices)

    @property
    def index(self) -> ShardedIndex:
        """The current ``ShardedIndex`` (unsynchronized peek)."""
        return self._index

    def epoch_token(self) -> tuple:
        """Hashable (layout, epoch-vector) cache-key component."""
        with self._lock:
            return (self._index.layout_key, tuple(self.epochs))

    def current(self) -> tuple[ShardedIndex, tuple]:
        """Consistent (index, epoch token) pair for one mapping batch."""
        with self._lock:
            return self._index, (self._index.layout_key, tuple(self.epochs))

    def refresh(self, ref: np.ndarray, **build_kw) -> tuple:
        """Re-partition from a new reference; bumps every shard's epoch."""
        kw = {**self._build_kw, **build_kw}
        new = build_sharded_index(ref, self._index.num_shards, **kw)
        with self._lock:
            self._index = new
            self._ref = np.asarray(ref, np.int8)
            self._build_kw = kw
            self.epochs = [e + 1 for e in self.epochs]
            return (new.layout_key, tuple(self.epochs))

    def refresh_shard(self, i: int) -> tuple:
        """Re-materialize shard ``i`` from the retained host reference.

        Failover path: a shard whose device was lost is rebuilt in place
        (same layout, same global table) and only its epoch counter
        bumps; keying the cache on the whole vector keeps it
        conservative and correct.
        """
        if not 0 <= i < self._index.num_shards:
            raise IndexError(f"shard {i} out of range "
                             f"(num_shards={self._index.num_shards})")
        cur = self._index
        dev = cur.row(i).refs.device
        idx = build_index(self._ref, w=cur.minimizer_w, k=cur.minimizer_k,
                          freq_frac=cur.freq_frac, device=dev)
        layout = cur.layout
        lo, hi = layout.core(i)
        slo, shi = layout.slice_range(i)
        g_pos = idx.positions.astype(np.int64)
        m = (g_pos >= lo) & (g_pos < hi)
        h, p = idx.hashes[m].astype(np.int64), g_pos[m]
        lm, mm = cur.parts[0].refs.shape[1], cur.parts[0].hashes.shape[1]
        row_h = np.full(mm, _PAD_HASH, np.int64)
        row_p = np.full(mm, _PAD_POS, np.int64)
        row_h[: len(h)] = h[:mm]
        row_p[: len(p)] = p[:mm]
        row_r = np.full(lm, SENTINEL, np.int8)
        row_r[: shi - slo] = self._ref[slo:shi]
        row = ShardArrays(torch.from_numpy(row_r)[None],
                          torch.tensor([slo], dtype=torch.int64),
                          torch.from_numpy(row_h)[None],
                          torch.from_numpy(row_p)[None])
        with self._lock:
            self._index = ShardedIndex(
                parts=replace_row(cur.parts, i, row), layout=layout,
                minimizer_w=cur.minimizer_w, minimizer_k=cur.minimizer_k,
                freq_frac=cur.freq_frac)
            self.epochs[i] += 1
            return (self._index.layout_key, tuple(self.epochs))


def from_epoched(epi: EpochedIndex | ReferenceIndex, num_shards: int, *,
                 halo: int = DEFAULT_HALO,
                 w: int | None = None, k: int | None = None,
                 freq_frac: float | None = None,
                 devices: Sequence[torch.device | str] | None = None
                 ) -> EpochedShardedIndex:
    """Shard an existing (epoched) single-device index.

    Reuses the host copy of the reference *and* the already-built global
    minimizer table, so the sharded index seeds from exactly the entries
    the single-device path seeds from (frequency filtering depends on
    global counts).  ``devices`` defaults to the index's device.
    """
    if isinstance(epi, EpochedIndex):
        kw = epi._build_kw
        w = kw["w"] if w is None else w
        k = kw["k"] if k is None else k
        freq_frac = kw.get("freq_frac", 0.0002) if freq_frac is None \
            else freq_frac
        ridx = epi.index
    else:
        ridx = epi
        if w is None or k is None:
            raise ValueError("sharding a bare ReferenceIndex needs explicit "
                             "w/k (it does not record its build params)")
        freq_frac = 0.0002 if freq_frac is None else freq_frac
    ref = ridx.ref.cpu().numpy()
    sharded = build_sharded_index(
        ref, num_shards, w=w, k=k, freq_frac=freq_frac, halo=halo,
        hashes=ridx.hashes.cpu().numpy(), positions=ridx.positions.cpu().numpy(),
        devices=(ridx.device,) if devices is None else devices)
    return EpochedShardedIndex(sharded, ref)
