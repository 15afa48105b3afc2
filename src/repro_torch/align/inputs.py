"""Shared seeded input generators for benchmarks and conformance tests.

Port of `repro.align.inputs`: the same generators, seeds and draws, so
the port's tests and tools feed the reference's inputs.  Everything
returns host numpy; callers move to device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitvector import SENTINEL, WILDCARD


def random_windows(batch: int, w: int, *, seed: int = 13,
                   n_chars: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """[batch, w] int8 (texts, patterns) window pairs (uniform bases)."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, n_chars, size=(batch, w)).astype(np.int8)
    pats = rng.integers(0, n_chars, size=(batch, w)).astype(np.int8)
    return texts, pats


def mutate(seq: np.ndarray, n_sub: int, n_ins: int, n_del: int,
           rng: np.random.Generator) -> np.ndarray:
    """Inject exactly the given numbers of substitutions/insertions/deletions."""
    s = list(int(c) for c in seq)
    for _ in range(n_sub):
        i = int(rng.integers(0, len(s)))
        s[i] = (s[i] + int(rng.integers(1, 4))) % 4
    for _ in range(n_ins):
        i = int(rng.integers(0, len(s) + 1))
        s.insert(i, int(rng.integers(0, 4)))
    for _ in range(n_del):
        i = int(rng.integers(0, len(s)))
        del s[i]
    return np.array(s, np.int8)


def mutated_pair(rng: np.random.Generator, m: int, *, n_sub: int = 0,
                 n_ins: int = 0, n_del: int = 0,
                 t_extra: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """One (pattern, text) pair: the pattern is a mutated copy of the
    text's first ``m`` bases; the text carries ``t_extra`` trailing bases
    so deletions never run off its end."""
    text = rng.integers(0, 4, size=m + t_extra).astype(np.int8)
    pattern = mutate(text[:m], n_sub, n_ins, n_del, rng)
    return pattern, text


def padded_batch(pairs: list[tuple[np.ndarray, np.ndarray]], p_cap: int,
                 t_cap: int):
    """Sentinel/wildcard-pad a ragged pair list into fixed-shape buffers.

    Returns ``(texts [B, t_cap], patterns [B, p_cap], p_lens, t_lens)``
    with wildcard-padded pattern tails and sentinel-padded text tails —
    the exact layout `align_batch` consumes.
    """
    b = len(pairs)
    texts = np.full((b, t_cap), SENTINEL, np.int8)
    pats = np.full((b, p_cap), WILDCARD, np.int8)
    p_lens = np.zeros((b,), np.int32)
    t_lens = np.zeros((b,), np.int32)
    for i, (pattern, text) in enumerate(pairs):
        pl_, tl = min(len(pattern), p_cap), min(len(text), t_cap)
        pats[i, :pl_] = pattern[:pl_]
        texts[i, :tl] = text[:tl]
        p_lens[i], t_lens[i] = pl_, tl
    return texts, pats, p_lens, t_lens


def aligned_read_batch(batch: int, read_len: int, *, p_cap: int | None = None,
                       t_extra: int = 128, n_sub: int = 2, n_ins: int = 1,
                       n_del: int = 1, seed: int = 29):
    """Fixed-shape batch of read-vs-region pairs for dispatch benchmarks."""
    rng = np.random.default_rng(seed)
    pairs = [mutated_pair(rng, read_len, n_sub=n_sub, n_ins=n_ins,
                          n_del=n_del, t_extra=t_extra) for _ in range(batch)]
    p_cap = p_cap or ((read_len + n_ins + 31) // 32) * 32
    return padded_batch(pairs, p_cap, read_len + t_extra)


def variant_graph(n_nodes: int, *, seed: int, n_snp: int, n_ins: int,
                  n_del: int, ref_margin: int = 12,
                  variant_seed: int | None = None):
    """One random reference + simulated-variant graph: ``(g, refseq)``.

    ``variant_seed`` defaults to ``seed`` so one seed pins the whole
    graph; pass it explicitly to reproduce a historical input set.
    """
    from repro_torch.core.segram import graph
    from repro_torch.genomics import simulate

    rng = np.random.default_rng(seed)
    refseq = rng.integers(0, 4, size=n_nodes - ref_margin).astype(np.int8)
    g = graph.build_graph(refseq, simulate.simulate_variants(
        refseq, n_snp=n_snp, n_ins=n_ins, n_del=n_del,
        seed=seed if variant_seed is None else variant_seed))
    return g, refseq


def graph_read_batch(batch: int, n_nodes: int, m_bits: int, *, k_read: int,
                     seed: int = 17, n_snp: int = 4, n_ins: int = 2,
                     n_del: int = 2, variant_seed: int | None = None):
    """Batched (bases, succ_bits, patterns, p_lens) over one variant graph,
    patterns sampled as exact reference substrings of ``m_bits - k_read``."""
    from repro_torch.core.segram import graph

    g, refseq = variant_graph(n_nodes, seed=seed, n_snp=n_snp, n_ins=n_ins,
                              n_del=n_del, variant_seed=variant_seed)
    b_, s_ = graph.extract_subgraph(g, 0, n_nodes)
    bases = np.broadcast_to(b_, (batch, n_nodes)).copy()
    succ = np.broadcast_to(s_, (batch, n_nodes)).copy()
    rng = np.random.default_rng(seed + 1)
    pats = np.full((batch, m_bits), WILDCARD, np.int8)
    plen = m_bits - k_read
    for i in range(batch):
        st = int(rng.integers(0, max(len(refseq) - plen, 1)))
        pats[i, :plen] = refseq[st: st + plen]
    p_lens = np.full((batch,), plen, np.int32)
    return bases, succ, pats, p_lens


def profile_read_patterns(refseq: np.ndarray, batch: int, read_len: int,
                          m_bits: int, *, profile, seed: int):
    """Error-profile-mutated reference substrings, wildcard-padded to
    ``[batch, m_bits]``."""
    from repro_torch.genomics import simulate

    rng = np.random.default_rng(seed)
    pats = np.full((batch, m_bits), WILDCARD, np.int8)
    for i in range(batch):
        s = int(rng.integers(0, max(len(refseq) - read_len - 4, 1)))
        r = simulate.mutate(refseq[s: s + read_len], profile, rng)
        pats[i, : min(len(r), m_bits)] = r[:m_bits]
    p_lens = np.full((batch,), read_len, np.int32)
    return pats, p_lens
