"""Sharded host→device input pipeline for read mapping.

Port of `repro.genomics.pipeline`.  Each host process owns a disjoint
slice of the read stream (process-index striding), builds fixed-shape
batches, and hands them to the device.  Batches are stateless work
quanta: fault tolerance is a (batch cursor, results offset) checkpoint,
and straggler mitigation is work-stealing over unclaimed batch ids
(`dist/fault.py`).  A double-buffered prefetch thread overlaps host
encode and the host→device copy with device compute.

:func:`map_stream` closes the loop: it drives each prefetched batch
through `core/mapper.map_batch`, whose alignment stage dispatches by
registry name — so the offline pipeline runs on any backend (``torch``,
``cuda_dc``, ``cuda_dc_v2``) with one argument.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .encode import batch_reads


class ReadBatches:
    """Deterministic batch iterator over a read list (host shard aware)."""

    def __init__(self, reads, *, batch: int, cap: int, process_index: int = 0,
                 process_count: int = 1, start_batch: int = 0):
        self.reads = reads
        self.batch = batch
        self.cap = cap
        self.pi = process_index
        self.pc = process_count
        self.start_batch = start_batch

    def __iter__(self) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        n = len(self.reads)
        ids = np.arange(self.pi, n, self.pc)
        n_batches = -(-len(ids) // self.batch)
        for b in range(self.start_batch, n_batches):
            sel = ids[b * self.batch: (b + 1) * self.batch]
            reads = [self.reads[i] for i in sel]
            while len(reads) < self.batch:  # tail padding (masked by lens=0)
                reads.append(np.zeros(0, np.int8))
            arr, lens = batch_reads(reads, self.cap)
            yield b, arr, lens


def device_putter(device):
    """numpy -> tensor on ``device``: through pinned memory and a
    non-blocking copy on a CUDA device (the copy is ordered on the
    device's current stream, before the consumer's kernels)."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
        dev, non_blocking=True)


class Prefetcher:
    """Double-buffered background prefetch (host encode ∥ device compute).

    ``device`` (default ``cuda``, which raises without a card) receives
    each batch through ``device_putter``; ``device_put`` overrides that.
    A worker-thread exception is captured and re-raised in the consumer's
    ``__iter__`` (a silent worker death would otherwise hang or truncate
    the stream).  ``close()`` (or exiting the context manager) stops the
    worker and joins it, even mid-stream with a full queue.
    """

    _DONE = object()  # stream-end sentinel (worker exception rides in _exc)

    def __init__(self, it, device_put=None, depth: int = 2, *,
                 device="cuda"):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.device_put = device_put or device_putter(device)
        self._exc: BaseException | None = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts when close() raises the stop flag."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            for b, arr, lens in it:
                if not self._put((b, self.device_put(arr),
                                  self.device_put(lens))):
                    return  # closed mid-stream
        except BaseException as e:  # noqa: BLE001 — hand it to the consumer
            self._exc = e
        self._put(self._DONE)

    def __iter__(self):
        while True:
            try:
                item = self.q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():  # closed elsewhere: no sentinel comes
                    return
                continue
            if item is self._DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def close(self) -> None:
        """Stop the worker and join it (idempotent; safe mid-stream)."""
        self._stop.set()
        while self._t.is_alive():  # drain so a blocked put can observe stop
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def map_stream(index, batches, *, backend: str | None = None, **map_kw
               ) -> Iterator[tuple[int, object]]:
    """Map every (batch_id, reads, lens) triple; yields (batch_id, MapResult).

    ``batches`` is any iterator in the `ReadBatches`/`Prefetcher` shape.
    ``backend`` names an alignment backend (None/"auto" picks the
    device's default); remaining kwargs forward to `mapper.map_batch`
    (p_cap, filter_k, ...).
    """
    from repro_torch.core import mapper

    for b, arr, lens in batches:
        yield b, mapper.map_batch(index, arr, lens, backend=backend, **map_kw)
