"""Device-resident reference index for the linear mapper.

Port of `repro.core.minimizer_index`, plus :func:`index_from_arrays`,
which carries an index built elsewhere (e.g. by the JAX reference,
given as numpy arrays) into this package's form.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device

from .segram.minimizer import build_index


class ReferenceIndex(NamedTuple):
    ref: torch.Tensor  # [L] int8 reference bases
    hashes: torch.Tensor  # [M] int64 sorted minimizer hashes (uint32 values)
    positions: torch.Tensor  # [M] int64 reference positions

    @property
    def device(self) -> torch.device:
        return self.ref.device


def index_from_arrays(ref, hashes, positions, *,
                      device: torch.device | str = "cuda") -> ReferenceIndex:
    """A `ReferenceIndex` on ``device`` from host arrays.

    ``ref`` int8 bases, ``hashes`` uint32 sorted hashes, ``positions``
    int32 positions — the fields of the reference's ``ReferenceIndex``
    as ``np.asarray`` gives them.  ``device`` defaults to the card (a CUDA
    device must be visible; pass ``device="cpu"`` for the CPU).
    """
    device = resolve_device(device)
    return ReferenceIndex(
        ref=torch.as_tensor(np.array(ref, np.int8), device=device),
        hashes=torch.as_tensor(np.asarray(hashes, np.uint32).astype(np.int64),
                               device=device),
        positions=torch.as_tensor(np.asarray(positions).astype(np.int64),
                                  device=device),
    )


def build_reference_index(ref: np.ndarray, *, w: int = 10, k: int = 15,
                          freq_frac: float = 0.0002,
                          device: torch.device | str = "cuda") -> ReferenceIndex:
    """Minimizer table and reference bases on ``device`` (the card unless
    the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    idx = build_index(ref, w=w, k=k, freq_frac=freq_frac, device=device)
    return index_from_arrays(ref, idx.hashes, idx.positions, device=device)


class EpochedIndex:
    """Epoch-stamped handle around a ``ReferenceIndex``.

    The serving layer keys its result cache on ``(read digest, epoch)``
    (`serve/cache.py`), so swapping in a rebuilt reference must be
    observable: ``refresh()`` replaces the index and bumps ``epoch``,
    which invalidates every result cached against the old reference.
    Readers grab ``(index, epoch)`` pairs under the lock via
    ``current()``.
    """

    def __init__(self, index: ReferenceIndex, *, w: int, k: int,
                 epoch: int = 0, freq_frac: float = 0.0002):
        # w/k are required: ReferenceIndex doesn't carry its build params
        self._lock = threading.Lock()
        self._index = index
        self.epoch = epoch
        self._build_kw = dict(w=w, k=k, freq_frac=freq_frac)

    @property
    def index(self) -> ReferenceIndex:
        return self._index

    def current(self) -> tuple[ReferenceIndex, int]:
        """Consistent (index, epoch) pair for one mapping batch."""
        with self._lock:
            return self._index, self.epoch

    def refresh(self, ref: np.ndarray, **build_kw) -> int:
        """Rebuild the index from a new reference on the same device;
        returns the new epoch."""
        kw = {**self._build_kw, **build_kw}
        new = build_reference_index(ref, device=self._index.device, **kw)
        with self._lock:
            self._index = new
            self._build_kw = kw
            self.epoch += 1
            return self.epoch


def build_epoched_index(ref: np.ndarray, *, w: int = 10, k: int = 15,
                        freq_frac: float = 0.0002,
                        device: torch.device | str = "cuda") -> EpochedIndex:
    """Build a reference index wrapped in an epoch-stamped serving handle
    (on the card unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    return EpochedIndex(
        build_reference_index(ref, w=w, k=k, freq_frac=freq_frac, device=device),
        w=w, k=k, freq_frac=freq_frac)
