"""Multi-word bitvector algebra for the Bitap family (GenASM-DC/TB).

Conventions (DESIGN.md §7), the same as the JAX reference:
  * A bitvector of ``n_bits`` is ``nw = n_bits // 32`` little-endian
    words: word ``j`` holds bits ``32j .. 32j+31``.
  * Pattern character ``j`` maps to bit ``n_bits - 1 - j`` (MSB =
    pattern[0]).
  * Base alphabet A=0 C=1 G=2 T=3; id 4 is the WILDCARD as a pattern
    char and the SENTINEL as a text char: ``match(p, c) = (p == c) |
    (p == 4)``.

Word type: each uint32 word is held as its ``torch.int32`` bit pattern,
because PyTorch's ``uint32`` lacks shifts, ``~`` and comparisons on the
CPU.  Left shifts and bitwise ops are the same on both; every right
shift that must be logical is masked (``(x >> s) & mask``).
"""
from __future__ import annotations

import torch

WORD_BITS = 32
NUM_CHARS = 5  # A, C, G, T, sentinel/wildcard
WILDCARD = 4
SENTINEL = 4
ALL_ONES = -1  # 0xFFFFFFFF as an int32 bit pattern


def n_words(n_bits: int) -> int:
    if n_bits % WORD_BITS != 0:
        raise ValueError(f"n_bits must be a multiple of {WORD_BITS}, got {n_bits}")
    return n_bits // WORD_BITS


def ones(shape, device=None) -> torch.Tensor:
    """All-ones bitvector(s); trailing axis is the word axis."""
    return torch.full(shape, ALL_ONES, dtype=torch.int32, device=device)


def shl1(x: torch.Tensor) -> torch.Tensor:
    """Shift the whole multi-word bitvector left by one, shifting in a 0.

    ``x``: ``[..., nw] int32``.  Word ``j-1``'s MSB carries into word
    ``j``'s LSB.
    """
    carry = (x >> 31) & 1
    incoming = torch.cat([torch.zeros_like(x[..., :1]), carry[..., :-1]], dim=-1)
    return (x << 1) | incoming


def msb(x: torch.Tensor) -> torch.Tensor:
    """Most significant bit (bit ``n_bits-1``) of ``[..., nw]`` bitvector(s)."""
    return (x[..., -1] >> 31) & 1


def get_bit(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit at per-lane position ``pos`` of ``[B, nw]`` bitvectors -> 0/1.

    ``pos``: ``[B]`` integer tensor; gathers along the word axis.
    """
    word = torch.gather(x, -1, (pos // WORD_BITS).unsqueeze(-1)).squeeze(-1)
    return (word >> (pos % WORD_BITS)) & 1


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Values in ``[0, 2**32)`` (int64) -> their int32 bit patterns."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pattern_bitmasks(pattern: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Build the PM table for (sub-)patterns.

    ``pattern``: ``[..., L]`` base ids with ``L == n_bits`` (pad with
    WILDCARD).  Returns ``[..., NUM_CHARS, nw] int32`` where ``PM[c]`` has
    bit ``n_bits-1-j`` equal to **0** iff pattern char ``j`` matches text
    char ``c`` (0 = match, as in Bitap).
    """
    nw = n_words(n_bits)
    if pattern.shape[-1] != n_bits:
        raise ValueError(f"pattern length {pattern.shape[-1]} != n_bits {n_bits}")
    rev = pattern.to(torch.int64).flip(-1)  # rev[..., g] = pattern char at bit g
    chars = torch.arange(NUM_CHARS, device=pattern.device)
    m = (rev.unsqueeze(-2) == chars[:, None]) | (rev.unsqueeze(-2) == WILDCARD)
    mm = (~m).to(torch.int64).reshape(m.shape[:-1] + (nw, WORD_BITS))
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=pattern.device) << \
        torch.arange(WORD_BITS, device=pattern.device)
    return to_i32((mm * weights).sum(-1))
