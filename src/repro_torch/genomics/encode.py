"""Base encoding, 2-bit packing, and fixed-shape batching (numpy).

Copied from `repro.genomics.encode`.
"""
from __future__ import annotations

import numpy as np

# id 4: the text SENTINEL and the pattern WILDCARD (core/bitvector.py)
SENTINEL = 4
WILDCARD = 4

_BASE_TO_ID = np.full(256, SENTINEL, np.int8)
for i, b in enumerate(b"ACGT"):
    _BASE_TO_ID[b] = i
    _BASE_TO_ID[ord(chr(b).lower())] = i
_ID_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> int8 ids (non-ACGT -> sentinel)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_TO_ID[np.frombuffer(seq, np.uint8)].copy()


def decode(ids: np.ndarray) -> str:
    return _ID_TO_BASE[np.clip(ids, 0, 4)].tobytes().decode()


def pack_2bit(ids: np.ndarray) -> np.ndarray:
    """2-bit pack ACGT ids (the paper's 715 MB GRCh38 representation).

    Non-ACGT collapse to A; keep a separate mask if needed.
    """
    ids = np.clip(ids, 0, 3).astype(np.uint8)
    pad = (-len(ids)) % 16
    ids = np.concatenate([ids, np.zeros(pad, np.uint8)])
    ids = ids.reshape(-1, 16)
    shifts = np.arange(16, dtype=np.uint32) * 2
    return (ids.astype(np.uint32) << shifts).sum(axis=1).astype(np.uint32)


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    shifts = np.arange(16, dtype=np.uint32) * 2
    out = ((packed[:, None] >> shifts) & 3).astype(np.int8).reshape(-1)
    return out[:n]


def batch_reads(reads: list[np.ndarray], cap: int, pad_value: int = WILDCARD):
    """Fixed-shape [B, cap] batch + lengths; reads longer than cap are trimmed."""
    b = len(reads)
    out = np.full((b, cap), pad_value, np.int8)
    lens = np.zeros(b, np.int32)
    for i, r in enumerate(reads):
        L = min(len(r), cap)
        out[i, :L] = r[:L]
        lens[i] = L
    return out, lens
