"""Shard-parallel linear mapping: scatter reads, merge candidates, align.

Port of `repro.shard.mapper`.  Per flush (DESIGN.md §11):

1. **Scatter** — the read batch goes to every shard; each shard seeds
   against its own minimizer-table slice and filters its own
   ``shard_candidates`` best diagonals inside its haloed slice, through
   `repro_torch.core.mapper.seed_filter_rows` — the body the
   single-device mapper runs with offset 0, which is what makes 1-shard
   and N-shard PAF byte-identical.  The shards of one device run one
   after another; shards placed on their own devices (`partition.place`)
   are launched one after another and run side by side.
2. **Merge** — the per-shard winners (global filter distance, refined
   position, ``[t_cap]`` window bytes) meet on the first device and an
   argmin over the packed ``(distance, position)`` key
   (`repro_torch.shard.merge`) picks each read's winner there.
   ``merge_host`` is the host oracle it is held against.  Halo windows
   are byte-identical across neighbours, so duplicates collapse.
3. **Align** — one `repro_torch.align.align_batch` call on the winning
   windows, on the first device.  With ``align_sharded=True`` the
   winners are cut into ``[S, B/S]`` blocks, each aligned on its shard's
   device; results are per read, so the cut is bit-neutral.

``start`` dispatches the three stages without synchronising with the
host (no ``.item()``, ``.cpu()`` or mask indexing between them) and
returns a :class:`PendingBatch`; ``finish`` waits and brings the result
to the host.  ``__call__`` is ``finish(start(...))`` with a device
synchronise and a span at each stage boundary.

Identity caveat (the reference's): each shard keeps its top
``shard_candidates`` diagonals *by local votes*, so the merged set holds
the single-device winner only while that winner ranks within
``shard_candidates`` in its owning shard; serve with the full per-shard
budget (the default) when output must not depend on the shard count.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import align as align_dispatch
from repro_torch.core import mapper as core_mapper
from repro_torch.core.bitvector import WILDCARD
from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.mapper import MapResult, POS_SENTINEL
# a name the reference module binds too
from repro_torch.dist import sharding as dist_sharding  # noqa: F401

from . import merge as shard_merge
from .partition import ShardedIndex
# a name the reference module binds too
from .partition import ShardArrays  # noqa: F401


class ShardStageResult(NamedTuple):
    """Per-(shard, read) winner of the scatter stage, global coordinates."""

    distance: torch.Tensor  # [S, B] int32 filter distance (filter_k+1 = none)
    position: torch.Tensor  # [S, B] int32 refined global start (sentinel=none)
    text: torch.Tensor  # [S, B, t_cap] int8 alignment window at position
    t_len: torch.Tensor  # [S, B] int32 valid window length


class PendingBatch(NamedTuple):
    """In-flight batch from ``start()``: device results + closed spans.

    ``res`` holds the result tensors on the device (their kernels may
    still run); ``times`` the closed ``(stage, t0, t1, attrs)`` windows;
    ``tail`` the name/attrs of the span ``finish()`` closes from
    ``t_dispatch`` to the host copy (None when ``res`` is already on the
    host, as the graph's zero-survivor batch is); ``stats`` the graph
    executor's counters (None for linear).
    """

    res: object
    times: tuple
    t_dispatch: float
    tail: tuple | None  # (stage_name, attrs)
    stats: dict | None = None


def required_halo(*, p_cap: int, filter_bits: int, filter_k: int,
                  t_cap: int) -> int:
    """Smallest overlap halo that loses no boundary mapping.

    Left of a core: a candidate diagonal seeded at the core boundary can
    start up to ``p_cap`` bases earlier plus 32 of diagonal-bucket
    rounding, and the filter reads ``margin = filter_k + 32`` bases of
    drift before it.  Right of a core: the filter region extends
    ``filter_bits + margin`` past the candidate and the refined anchor
    needs ``t_cap`` bases of alignment text after it.
    """
    margin = filter_k + 32
    left = p_cap + 32 + margin
    right = filter_bits + 2 * margin + t_cap
    return max(left, right)


def validate_geometry(sharded: ShardedIndex, *, p_cap: int, filter_bits: int,
                      filter_k: int, t_cap: int) -> None:
    """Raise if the layout's halo cannot cover this mapping geometry."""
    need = required_halo(p_cap=p_cap, filter_bits=filter_bits,
                         filter_k=filter_k, t_cap=t_cap)
    if sharded.layout.halo < need:
        raise ValueError(
            f"shard halo {sharded.layout.halo} < {need} required for "
            f"p_cap={p_cap}, filter_bits={filter_bits}, "
            f"filter_k={filter_k}, t_cap={t_cap}; rebuild the sharded "
            f"index with halo >= {need}")


def sync(devices) -> None:
    """Wait for every CUDA device in ``devices``."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def to_host(tree):
    """A result NamedTuple with every tensor copied to the CPU."""
    return type(tree)(*(x.cpu() for x in tree))


def finish_pending(pending: PendingBatch):
    """Wait for a `start` batch → ``(result on the host, stage times)``."""
    if pending.tail is None:
        return pending.res, pending.times
    res = to_host(pending.res)
    name, attrs = pending.tail
    return res, pending.times + ((name, pending.t_dispatch, time.monotonic(),
                                  attrs),)


def split_rows(n_blocks: int, *xs):
    """``[B, ...]`` tensors zero-padded to ``n_blocks * ceil(B/n)`` rows
    and cut into ``n_blocks`` equal blocks: a list of per-block tuples."""
    b = xs[0].shape[0]
    bs = -(-b // n_blocks)
    padded = [torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1)
                                      + (0, bs * n_blocks - b))
              for x in xs]
    return [tuple(x[i * bs: (i + 1) * bs] for x in padded)
            for i in range(n_blocks)]


def join_rows(outs: Sequence, b: int, device: torch.device):
    """Concatenate per-block result NamedTuples on ``device``, first ``b``
    rows (the inverse of `split_rows`)."""
    return type(outs[0])(*(torch.cat([o[f].to(device) for o in outs])[:b]
                           for f in range(len(outs[0]))))


class ShardedMapExecutor:
    """Scatter/merge/align pipeline for one sharded geometry.

    Construct once per (index geometry, mapping parameters) and call
    with ``(parts, reads, lens)``, ``parts`` being a `ShardedIndex`'s
    placement (a sequence of `ShardArrays` blocks); the serve engine
    caches executors like its single-device ones.
    """

    def __init__(self, sharded: ShardedIndex, *,
                 cfg: GenASMConfig = GenASMConfig(),
                 p_cap: int = 256,
                 filter_bits: int = 128,
                 filter_k: int = 12,
                 shard_candidates: int = 4,
                 minimizer_w: int | None = None,
                 minimizer_k: int | None = None,
                 backend: str | None = None,
                 align_sharded: bool = False):
        t_cap = p_cap + 2 * cfg.w
        filter_bits = min(filter_bits, p_cap)
        validate_geometry(sharded, p_cap=p_cap, filter_bits=filter_bits,
                          filter_k=filter_k, t_cap=t_cap)
        self.num_shards = sharded.num_shards
        self.filter_k = filter_k
        self.cfg = cfg
        self.p_cap = p_cap
        self.backend = align_dispatch.resolve_backend(
            backend, sharded.device).name
        self.align_sharded = align_sharded
        self._align_stage_name = "align_shard" if align_sharded else "align"
        self._sf_kw = dict(
            ref_len=sharded.ref_len, p_cap=p_cap, t_cap=t_cap,
            filter_bits=filter_bits, filter_k=filter_k,
            max_candidates=shard_candidates,
            minimizer_w=sharded.minimizer_w if minimizer_w is None
            else minimizer_w,
            minimizer_k=sharded.minimizer_k if minimizer_k is None
            else minimizer_k)
        # (stage, t0, t1, attrs) monotonic windows from the last call —
        # the serve engine replays them as child spans of its flush span
        self.last_times: list[tuple[str, float, float, dict]] = []

    def stage(self, parts, reads, read_lens) -> ShardStageResult:
        """The scatter stage: each shard's winners for the whole batch,
        stacked ``[S, B, ...]`` on the first block's device."""
        outs = []
        for block in parts:
            dev = block.refs.device
            r = torch.as_tensor(reads, device=dev)
            lens = torch.as_tensor(read_lens, device=dev)
            for j in range(block.refs.shape[0]):
                sf = core_mapper.seed_filter_rows(
                    block.refs[j], block.offsets[j], hashes=block.hashes[j],
                    positions=block.positions[j], reads=r, read_lens=lens,
                    **self._sf_kw)
                outs.append((sf.distance, sf.position, sf.text, sf.t_len))
        home = parts[0].refs.device
        return ShardStageResult(*(torch.stack([o[f].to(home) for o in outs])
                                  for f in range(4)))

    @staticmethod
    def merge_host(stage: ShardStageResult):
        """Host merge: lex-min ``(distance, position)`` per read.

        The independently coded oracle of `merge_device` (the packed-key
        argmin must match it bit for bit, low-shard tie-break included).
        Returns ``(fd, pos, text, t_len, winner_shard)`` numpy arrays.
        """
        fd = stage.distance.cpu().numpy()
        pos = stage.position.cpu().numpy()
        m = fd.min(axis=0)
        pm = np.where(fd == m[None, :], pos, POS_SENTINEL)
        win = pm.argmin(axis=0)
        cols = np.arange(fd.shape[1])
        return (m, pm[win, cols], stage.text.cpu().numpy()[win, cols],
                stage.t_len.cpu().numpy()[win, cols], win)

    @staticmethod
    def merge_device(stage: ShardStageResult):
        """Packed-key argmin-reduce on the stage's device.

        Returns ``(fd, pos, text, t_len, winner_shard)`` as device
        tensors — the `merge_host` contract, with no host round trip.
        """
        return shard_merge.merge_linear(stage.distance, stage.position,
                                        stage.text, stage.t_len)

    def _align_core(self, text, reads, lens, t_len, pos, fd) -> MapResult:
        p_cap = self.p_cap
        lens = lens.to(torch.int32)
        r = reads[:, :p_cap]
        if r.shape[1] < p_cap:
            r = torch.nn.functional.pad(r, (0, p_cap - r.shape[1]),
                                        value=WILDCARD)
        pat = torch.where(torch.arange(p_cap, device=r.device) < lens[:, None],
                          r, WILDCARD).to(torch.int8)
        res = align_dispatch.align_batch(text, pat, lens, t_len, cfg=self.cfg,
                                         backend=self.backend, p_cap=p_cap)
        failed = res.failed | (fd > self.filter_k)
        return MapResult(
            position=torch.where(failed, -1, pos).to(torch.int32),
            distance=torch.where(failed, -1, res.distance).to(torch.int32),
            ops=res.ops, n_ops=res.n_ops, failed=failed)

    def _align(self, text, reads, lens, t_len, pos, fd,
               devices: Sequence[torch.device] = ()) -> MapResult:
        """The align stage on the merged winners (on ``text``'s device);
        with ``align_sharded``, ``[S, B/S]`` blocks, block ``i`` on
        ``devices[i]`` when one device per shard is given."""
        home = text.device
        reads = torch.as_tensor(reads, device=home)
        lens = torch.as_tensor(lens, device=home).to(torch.int32)
        if not self.align_sharded:
            return self._align_core(text, reads, lens, t_len, pos, fd)
        s = self.num_shards
        outs = []
        for i, blk in enumerate(split_rows(s, text, reads, lens, t_len, pos,
                                           fd)):
            dev = devices[i] if len(devices) == s else home
            outs.append(self._align_core(*(x.to(dev) for x in blk)))
        return join_rows(outs, text.shape[0], home)

    def start(self, parts, reads, read_lens, *,
              timed: bool = True) -> PendingBatch:
        """Dispatch scatter → device merge → align without waiting.

        ``timed=False`` skips the synchronise (and span) at each stage
        boundary — the dispatch of pipelined serving.
        """
        devices = tuple(p.refs.device for p in parts)
        times: list[tuple[str, float, float, dict]] = []
        t0 = time.monotonic()
        st = self.stage(parts, reads, read_lens)
        if timed:
            sync(devices)
            t1 = time.monotonic()
            times.append(("scatter", t0, t1, {"shards": self.num_shards}))
        fd, pos, text, t_len, _win = self.merge_device(st)
        if timed:
            sync(devices)
            t2 = time.monotonic()
            times.append(("merge_device", t1, t2,
                          {"shards": self.num_shards}))
        else:
            t2 = time.monotonic()
        res = self._align(text, reads, read_lens, t_len, pos, fd, devices)
        return PendingBatch(res=res, times=tuple(times), t_dispatch=t2,
                            tail=(self._align_stage_name,
                                  {"sharded": self.align_sharded}))

    finish = staticmethod(finish_pending)

    def __call__(self, parts, reads, read_lens) -> MapResult:
        """Map one batch: scatter → device merge → batched align."""
        res, times = self.finish(self.start(parts, reads, read_lens))
        self.last_times = list(times)
        return res


# bounded LRU: a long-running process whose refresh() cycles through
# reference lengths must not accumulate executors forever
_EXECUTORS: OrderedDict[tuple, ShardedMapExecutor] = OrderedDict()
_EXECUTOR_CACHE_CAP = 8


def get_executor(
    sharded: ShardedIndex,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int = 256,
    filter_bits: int = 128,
    filter_k: int = 12,
    shard_candidates: int = 4,
    backend: str | None = None,
    align_sharded: bool = False,
) -> ShardedMapExecutor:
    """Cached :class:`ShardedMapExecutor` for one (geometry, params) key,
    shared by `map_batch_sharded` and `failover.map_batch_with_failover`."""
    key = (sharded.layout_key, sharded.minimizer_w, sharded.minimizer_k,
           sharded.device, cfg, p_cap, filter_bits, filter_k,
           shard_candidates, backend, align_sharded)
    ex = _EXECUTORS.get(key)
    if ex is None:
        ex = ShardedMapExecutor(
            sharded, cfg=cfg, p_cap=p_cap, filter_bits=filter_bits,
            filter_k=filter_k, shard_candidates=shard_candidates,
            backend=backend, align_sharded=align_sharded)
        _EXECUTORS[key] = ex
        while len(_EXECUTORS) > _EXECUTOR_CACHE_CAP:
            _EXECUTORS.popitem(last=False)
    else:
        _EXECUTORS.move_to_end(key)
    return ex


def map_batch_sharded(
    sharded: ShardedIndex,
    reads,
    read_lens,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int = 256,
    filter_bits: int = 128,
    filter_k: int = 12,
    shard_candidates: int = 4,
    backend: str | None = None,
    align_sharded: bool = False,
    pipelined: bool = False,
) -> MapResult:
    """Map a read batch against a sharded reference index.

    ``reads`` is ``[B, >=p_cap] int8`` with ``read_lens [B]`` valid
    lengths; returns the single-device `core.mapper.map_batch`'s
    `MapResult` (on the host) — byte-identical positions, distances and
    CIGARs at any shard count, with the align stage split or not, and
    through the untimed (``pipelined``) dispatch or the timed one.
    """
    ex = get_executor(
        sharded, cfg=cfg, p_cap=p_cap, filter_bits=filter_bits,
        filter_k=filter_k, shard_candidates=shard_candidates,
        backend=backend, align_sharded=align_sharded)
    if pipelined:
        res, times = ex.finish(ex.start(sharded.parts, reads, read_lens,
                                        timed=False))
        ex.last_times = list(times)
        return res
    return ex(sharded.parts, reads, read_lens)
