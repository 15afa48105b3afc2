"""Myers' 1999 bit-parallel edit distance — the Edlib software baseline.

Port of `repro.core.myers` batched over ``[B]`` lanes, and the plain
version of the CUDA kernel `repro_torch.kernels.myers` (it follows the
Pallas kernel `repro.kernels.myers._myers_kernel`).  The paper's Use
Case 3 (§4.10.4) compares GenASM against Edlib, whose core is Myers'
bitvector algorithm.  Bit convention differs from Bitap: bit ``j`` ↔
pattern position ``j`` (LSB = pattern[0]) and 1 = match in ``PEq``.

Supports the global (NW) score and the semi-global search score (min
over text end positions, free text start), per Hyyrö's formulation.
`myers_distance` is the reference's one-pair entry point, a batch of one
through the kernel's wrapper.

Edge cases follow the Pallas kernel: the score bit ``m_len - 1`` lives
in no word when ``m_len`` is 0 or above ``m_bits``, so the score never
moves from ``m_len`` (0 for an empty pattern).  `repro.core.myers`
differs at ``m_len = 0``: its ``jnp.take(Ph, -1)`` reads a wrapped word.
A text char outside 0..4 matches no pattern char, as in the kernel.

Words are int32 bit patterns (`bitvector`); the multi-word add with
carry runs in int64, and its carry chain across words is resolved with
a handful of vector ops per text char (a ``cummax`` over word indices),
not a loop over words.
"""
from __future__ import annotations

import torch

from .bitvector import NUM_CHARS, WILDCARD, WORD_BITS, n_words, to_i32

MASK32 = 0xFFFFFFFF
MODES = ("global", "semiglobal")


def peq_table(patterns: torch.Tensor, m_bits: int) -> torch.Tensor:
    """``[B, NUM_CHARS + 1, nw]`` int32: bit ``j`` of ``PEq[c]`` is 1 iff
    ``pattern[j] == c`` or ``pattern[j]`` is the wildcard.  Row
    ``NUM_CHARS`` is all zero: the row a text char outside 0..4 selects."""
    nw = n_words(m_bits)
    if patterns.shape[-1] != m_bits:
        raise ValueError(f"pattern length {patterns.shape[-1]} != m_bits {m_bits}")
    p = patterns.to(torch.int64).unsqueeze(-2)  # [B, 1, m_bits]
    chars = torch.arange(NUM_CHARS, device=patterns.device).unsqueeze(-1)
    m = ((p == chars) | (p == WILDCARD)).to(torch.int64)
    m = m.reshape(m.shape[:-1] + (nw, WORD_BITS))
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=patterns.device) \
        << torch.arange(WORD_BITS, device=patterns.device)
    peq = to_i32((m * weights).sum(-1))
    return torch.cat([peq, torch.zeros_like(peq[..., :1, :])], dim=-2)


def add_with_carry(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-word add of ``[B, nw]`` int32 bit patterns (little-endian word
    axis), dropping the final carry.

    Each word's 33-bit sum either generates a carry (bit 32 set),
    propagates one (low word all ones) or kills it.  The carry into word
    ``w`` is decided by the nearest word below ``w`` that does not
    propagate: a running ``cummax`` of those words' indices finds it.
    """
    s = (a.to(torch.int64) & MASK32) + (b.to(torch.int64) & MASK32)
    low = s & MASK32
    gen = s > MASK32
    idx = torch.arange(s.shape[-1], device=s.device).expand_as(s)
    decider = torch.where(gen | (low != MASK32), idx, -1).cummax(-1).values
    below = torch.cat([torch.full_like(decider[..., :1], -1),
                       decider[..., :-1]], dim=-1)
    carry = (below >= 0) & gen.gather(-1, below.clamp(min=0))
    return to_i32((low + carry.to(torch.int64)) & MASK32)


def _shl1_in(x: torch.Tensor, bit_in: torch.Tensor) -> torch.Tensor:
    """Shift ``[B, nw]`` left by one, shifting ``bit_in [B]`` into bit 0."""
    incoming = torch.cat([bit_in.unsqueeze(-1), (x[..., :-1] >> 31) & 1], dim=-1)
    return (x << 1) | incoming


def score_bit_mask(m_lens: torch.Tensor, m_bits: int) -> torch.Tensor:
    """``[B, nw]`` int32 with only bit ``m_len - 1`` set (none when
    ``m_len`` is outside ``[1, m_bits]``)."""
    nw = n_words(m_bits)
    pos = m_lens.to(torch.int64) - 1
    word = torch.arange(nw, device=m_lens.device)
    hit = (pos >= 0).unsqueeze(-1) & (word == (pos // WORD_BITS).unsqueeze(-1))
    return to_i32(torch.where(hit, 1 << (pos % WORD_BITS).unsqueeze(-1), 0))


def myers_distance_batch(texts: torch.Tensor, patterns: torch.Tensor,
                         m_lens: torch.Tensor, *, m_bits: int,
                         mode: str = "global") -> torch.Tensor:
    """Edit distance by Myers' algorithm, one pair per lane.

    ``texts``: ``[B, n]`` int8; ``patterns``: ``[B, m_bits]`` int8
    wildcard-padded (wildcards match everything, so ``m_lens [B]`` gives
    the real lengths and the score is read at bit ``m_len - 1``).

    ``mode``: ``"global"`` (NW distance of pattern vs full text) or
    ``"semiglobal"`` (min over text prefixes, free start — Edlib's
    HW/search mode, never above ``m_len``).  Returns ``[B]`` int32.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, n = texts.shape
    nw = n_words(m_bits)
    dev = texts.device
    peq = peq_table(patterns, m_bits)  # [B, 6, nw]
    sel = score_bit_mask(m_lens.to(dev), m_bits)
    chars = texts.to(torch.int64)
    chars = torch.where((chars >= 0) & (chars < NUM_CHARS), chars, NUM_CHARS)
    lanes = torch.arange(b, device=dev)
    cin = torch.full((b,), 1 if mode == "global" else 0, dtype=torch.int32,
                     device=dev)
    zero = torch.zeros_like(cin)
    Pv = torch.full((b, nw), -1, dtype=torch.int32, device=dev)
    Mv = torch.zeros((b, nw), dtype=torch.int32, device=dev)
    score = m_lens.to(device=dev, dtype=torch.int32).clone()
    best = score.clone()
    for j in range(n):
        Eq = peq[lanes, chars[:, j]]
        Xv = Eq | Mv
        Xh = (add_with_carry(Eq & Pv, Pv) ^ Pv) | Eq
        Ph = Mv | ~(Xh | Pv)
        Mh = Pv & Xh
        score += ((Ph & sel) != 0).any(-1).to(torch.int32) \
            - ((Mh & sel) != 0).any(-1).to(torch.int32)
        Ph = _shl1_in(Ph, cin)
        Mh = _shl1_in(Mh, zero)
        Pv = Mh | ~(Xv | Ph)
        Mv = Ph & Xv
        torch.minimum(best, score, out=best)
    return score if mode == "global" else best


def myers_distance(text: torch.Tensor, pattern: torch.Tensor, m_len, *,
                   m_bits: int, mode: str = "global") -> torch.Tensor:
    """Myers distance of one pair: ``text [n]``, ``pattern [m_bits]``
    (wildcard-padded), ``m_len`` its real length.  A batch of one through
    `repro_torch.kernels.myers.myers_distance_batch` (the CUDA kernel on a
    CUDA tensor, `myers_distance_batch` here on a CPU tensor); returns a
    0-d int32 tensor."""
    from repro_torch.kernels.myers import myers_distance_batch as kernel

    text = torch.as_tensor(text)
    pattern = torch.as_tensor(pattern, device=text.device)
    m_lens = torch.as_tensor(m_len, device=text.device).reshape(1)
    return kernel(text[None], pattern[None], m_lens, m_bits=m_bits,
                  mode=mode)[0]
