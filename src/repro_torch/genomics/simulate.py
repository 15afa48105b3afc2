"""Reference & read simulators with per-technology error profiles.

Mirrors the paper's methodology (§4.9): PBSIM-style long reads (PacBio CLR
~10% error, ONT R9 ~15%) and Mason-style short Illumina reads (~5% in the
paper's datasets).  Error composition follows the cited profiles:
PacBio/ONT are indel-dominated, Illumina substitution-dominated.

Copied from `repro.genomics.simulate`, so the same seeds draw the same
reference, reads and variants.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ErrorProfile(NamedTuple):
    name: str
    error_rate: float
    frac_sub: float
    frac_ins: float
    frac_del: float


ILLUMINA = ErrorProfile("illumina", 0.05, 0.80, 0.10, 0.10)
PACBIO_CLR = ErrorProfile("pacbio", 0.10, 0.20, 0.45, 0.35)
ONT_R9 = ErrorProfile("ont", 0.15, 0.25, 0.30, 0.45)

PROFILES = {p.name: p for p in (ILLUMINA, PACBIO_CLR, ONT_R9)}


def random_reference(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length).astype(np.int8)


def mutate(seq: np.ndarray, profile: ErrorProfile, rng: np.random.Generator
           ) -> np.ndarray:
    """Apply the profile's edits to a sequence."""
    out: list[int] = []
    p_err = profile.error_rate
    for b in seq:
        r = rng.random()
        if r >= p_err:
            out.append(int(b))
            continue
        kind = rng.random()
        if kind < profile.frac_sub:
            out.append(int((b + rng.integers(1, 4)) % 4))
        elif kind < profile.frac_sub + profile.frac_ins:
            out.append(int(rng.integers(0, 4)))
            out.append(int(b))
        # else: deletion — emit nothing
    return np.array(out, np.int8)


class ReadSet(NamedTuple):
    reads: list[np.ndarray]
    true_pos: np.ndarray  # [B] int32 source positions


def simulate_reads(ref: np.ndarray, *, n_reads: int, read_len: int,
                   profile: ErrorProfile = ILLUMINA, seed: int = 0) -> ReadSet:
    rng = np.random.default_rng(seed)
    L = len(ref)
    pos = rng.integers(0, max(L - read_len, 1), size=n_reads).astype(np.int32)
    reads = [mutate(ref[p: p + read_len], profile, rng) for p in pos]
    return ReadSet(reads=reads, true_pos=pos)


def spell_graph_path(graph, start: int, length: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Spell a read along a random successor walk of ``graph`` from
    ``start`` (ground-truth reads for sequence-to-graph tests)."""
    seq: list[int] = []
    cur = int(start)
    while len(seq) < length and cur < graph.n_nodes:
        seq.append(int(graph.bases[cur]))
        bits = int(graph.succ_bits[cur])
        if not bits:
            break
        hops = [h for h in range(32) if (bits >> h) & 1]
        cur = cur + 1 + int(rng.choice(hops))
    return np.array(seq, np.int8)


def simulate_variants(ref: np.ndarray, *, n_snp=10, n_ins=4, n_del=4, seed=0):
    """Variant list for genome-graph construction (spread, non-overlapping)."""
    from repro_torch.core.segram.graph import Variant

    rng = np.random.default_rng(seed)
    L = len(ref)
    n_total = n_snp + n_ins + n_del
    pos = np.sort(rng.choice(np.arange(4, L - 8, 6), size=min(n_total, (L - 12) // 6),
                             replace=False))
    variants = []
    kinds = (["snp"] * n_snp + ["ins"] * n_ins + ["del"] * n_del)[: len(pos)]
    rng.shuffle(kinds)
    for p, kind in zip(pos, kinds):
        if kind == "snp":
            variants.append(Variant(int(p), "snp", (int((ref[p] + 1) % 4),)))
        elif kind == "ins":
            variants.append(Variant(int(p), "ins",
                                    tuple(int(x) for x in rng.integers(0, 4, 2))))
        else:
            variants.append(Variant(int(p), "del", span=2))
    return variants
