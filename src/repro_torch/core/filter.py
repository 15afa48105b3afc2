"""Use case 2: pre-alignment filtering (paper §4.8, §4.10.3), and the
q-gram tile screen in front of it.

Port of `repro.core.filter`.  GenASM-DC (no traceback) computes the
*exact* semi-global distance of a short read against each candidate
region (`filter_candidates`, on the device of its inputs with the plain
`bitap_search`: no Pallas kernel computes it in the reference either);
candidates above the edit threshold are rejected before the expensive
alignment step.  Because the distance is exact, the false-accept rate
is ~0 by construction — the paper's headline accuracy result.

The q-gram primitives serve the cheap-screen-before-exact-filter
cascade of the graph mapper: per-tile Bloom filters over
the tile's q-grams let the graph mapper reject candidate tiles that
cannot contain a ≤k mapping with one vectorized count — no BitAlign
launch at all.  Soundness comes from the q-gram lemma: a pattern of
length m within edit distance k of some text shares at least
``(m - q + 1) - q·k`` q-grams with it, so a tile whose Bloom filter
confirms fewer (minus a slack term for q-grams the graph linearization
cannot represent as substrings) is provably distance > k.  Bloom false
positives and wildcard-touching q-grams only *raise* the confirmed
count, keeping the screen one-sided.

Conventions: q-gram codes and hashes are int64 holding uint32 values
(`segram.minimizer`); Bloom words are int32 bit patterns
(`bitvector`).  Every function takes leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch

from .bitvector import SENTINEL, WILDCARD, WORD_BITS, to_i32
from .genasm_dc import bitap_search
from .segram.minimizer import INVALID, hash32, kmer_codes

QGRAM_Q = 8  # q-gram width of the tile screen (2-bit packed, 16 bits)
BLOOM_BITS = 4096  # per-tile Bloom width: 128 uint32 words
BLOOM_WORDS = BLOOM_BITS // WORD_BITS


def qgram_codes(seq: torch.Tensor, q: int = QGRAM_Q) -> torch.Tensor:
    """Packed 2-bit q-gram codes per position (``0xFFFFFFFF`` where the
    window touches a non-ACGT char) — `kmer_codes` at the screen's q."""
    return kmer_codes(seq, q)


def _bloom_probes(codes: torch.Tensor):
    """Two bit positions per code from one murmur-mixed hash."""
    h = hash32(codes)
    return h & (BLOOM_BITS - 1), (h >> 13) & (BLOOM_BITS - 1)


def qgram_bloom(bases: torch.Tensor, n_valid, *, q: int = QGRAM_Q
                ) -> torch.Tensor:
    """``[..., n]`` int8 bases → ``[..., BLOOM_WORDS]`` int32 Bloom words.

    Only windows fully inside the first ``n_valid`` chars (``[...]``) are
    inserted; windows touching non-ACGT chars (sentinel padding) are
    skipped — queries count those read-side as hits, so skipping stays
    sound.
    """
    codes = qgram_codes(bases, q)
    lead = codes.shape[:-1]
    npos = codes.shape[-1]
    dev = codes.device
    n_valid = torch.as_tensor(n_valid, device=dev).unsqueeze(-1)
    ok = (torch.arange(npos, device=dev) + q <= n_valid) & (codes != INVALID)
    bits = torch.zeros(lead + (BLOOM_BITS + 1,), dtype=torch.bool, device=dev)
    for probe in _bloom_probes(codes):
        # slot BLOOM_BITS takes the skipped windows and is dropped
        bits.scatter_(-1, torch.where(ok, probe, BLOOM_BITS), True)
    packed = bits[..., :BLOOM_BITS].reshape(lead + (BLOOM_WORDS, WORD_BITS))
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=dev) << \
        torch.arange(WORD_BITS, device=dev)
    return to_i32((packed.to(torch.int64) * weights).sum(-1))


def qgram_hits(codes: torch.Tensor, pos_ok: torch.Tensor, bloom: torch.Tensor
               ) -> torch.Tensor:
    """Count query q-grams the Bloom filter *may* contain.

    ``codes``/``pos_ok`` are ``[..., P]`` (uint32-valued int64 codes, bool
    real-window mask), ``bloom`` is ``[..., BLOOM_WORDS]`` with identical
    leading dims.  Invalid (wildcard-touching) codes count as hits — the
    screen must never undercount against a text that could match them.
    Returns ``[...] int64`` counts.
    """
    may = codes == INVALID
    hit = torch.ones_like(may)
    for probe in _bloom_probes(codes):
        word = torch.gather(bloom, -1, probe >> 5)
        hit = hit & (((word >> (probe & 31)) & 1) != 0)
    return ((hit | may) & pos_ok).sum(-1)


def qgram_min_hits(n_pos, k: int, slack, *, q: int = QGRAM_Q):
    """q-gram-lemma lower bound on confirmed q-grams at distance ≤ k.

    ``n_pos`` is the pattern's real q-gram count (``m - q + 1``), each
    edit can destroy at most ``q`` of them, and ``slack`` bounds the
    q-grams a matching graph path may spell across hop>1 edges (chains
    that are not substrings of the tile linearization, hence absent from
    the Bloom filter).  Non-positive bounds mean "cannot prune".
    """
    return n_pos - q * k - slack


def filter_candidates(texts: torch.Tensor, reads: torch.Tensor, read_lens=None,
                      *, m_bits: int, k: int):
    """Batch pre-alignment filter.

    ``texts``: ``[B, n]`` int8 candidate regions (sentinel-padded by the
    caller to at least read_len + k + pad).  ``reads``: ``[B, m_bits]``
    int8 wildcard-padded reads (``read_lens`` is unused, as in the
    reference: the wildcard tail matches everything).  Returns ``(accept
    [B] bool, dist [B] int32)`` where dist is the exact semi-global
    distance (``k+1`` ⇒ rejected).
    """
    dist = bitap_search(texts, reads, m_bits=m_bits, k=k).min(-1).values
    return dist <= k, dist


def prepare_read(read, m_bits: int) -> np.ndarray:
    """Host-side helper: wildcard-pad a 1-D numpy read to ``m_bits``."""
    buf = np.full((m_bits,), WILDCARD, np.int8)
    buf[: len(read)] = read
    return buf


def prepare_region(region, n: int) -> np.ndarray:
    """Host-side helper: sentinel-pad a candidate region to ``n``."""
    buf = np.full((n,), SENTINEL, np.int8)
    buf[: len(region)] = region
    return buf
