"""Multi-word bitvectors of the Bitap family, in plain PyTorch.

A frozen copy, for the benchmark's plain reference, of the bitvector
algebra that GenASM and BitAlign are defined on.  A bitvector of
``n_bits`` is ``n_bits // 32`` little-endian words, each uint32 held as
its int32 bit pattern; pattern character ``j`` is bit ``n_bits - 1 - j``.
Bases are A=0 C=1 G=2 T=3; 4 is the pattern wildcard and the text
sentinel, and ``match(p, c) = (p == c) | (p == 4)``.
"""
from __future__ import annotations

import torch

WORD_BITS = 32
NUM_CHARS = 5
WILDCARD = 4
SENTINEL = 4
ALL_ONES = -1


def n_words(n_bits: int) -> int:
    if n_bits % WORD_BITS:
        raise ValueError(f"n_bits must be a multiple of {WORD_BITS}, got {n_bits}")
    return n_bits // WORD_BITS


def ones(shape, device=None) -> torch.Tensor:
    return torch.full(shape, ALL_ONES, dtype=torch.int32, device=device)


def shl1(x: torch.Tensor) -> torch.Tensor:
    """Shift ``[..., nw]`` bitvectors left by one, shifting in a 0."""
    carry = (x >> 31) & 1
    incoming = torch.cat([torch.zeros_like(x[..., :1]), carry[..., :-1]], dim=-1)
    return (x << 1) | incoming


def get_bit(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos[b]`` of each ``[B, nw]`` bitvector, as 0/1."""
    word = torch.gather(x, -1, (pos // WORD_BITS).unsqueeze(-1)).squeeze(-1)
    return (word >> (pos % WORD_BITS)) & 1


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> their int32 bit patterns."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pattern_bitmasks(pattern: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``[..., n_bits]`` bases -> ``[..., 5, nw]`` masks: bit ``n_bits-1-j``
    of mask ``c`` is 0 iff pattern char ``j`` matches text char ``c``."""
    nw = n_words(n_bits)
    rev = pattern.to(torch.int64).flip(-1)
    chars = torch.arange(NUM_CHARS, device=pattern.device)
    m = (rev.unsqueeze(-2) == chars[:, None]) | (rev.unsqueeze(-2) == WILDCARD)
    mm = (~m).to(torch.int64).reshape(m.shape[:-1] + (nw, WORD_BITS))
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=pattern.device) \
        << torch.arange(WORD_BITS, device=pattern.device)
    return to_i32((mm * weights).sum(-1))


def first_match_distance(msbs: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., k+1]`` MSBs -> the first ``d`` whose MSB is 0, else ``k+1``."""
    found = msbs == 0
    return torch.where(found.any(-1), found.to(torch.int8).argmax(-1),
                       k + 1).to(torch.int32)
