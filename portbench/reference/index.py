"""Minimizer index and seeding in plain PyTorch (MinSeed, paper §6.1, §6.5).

A frozen copy, for the benchmark's plain reference, of (w, k)-minimizer
sampling, the sorted (hash, position) table with its frequency filter,
and the query that turns a read's minimizers into candidate diagonals.
The table is sorted on the device here (the program sorts on the host):
the same stable order gives the same table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INVALID = MASK32
_NO_DIAG = -(2 ** 30)


def kmer_codes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """2-bit packed k-mer codes ``[..., n-k+1] int64`` (``INVALID`` where a
    k-mer touches a base outside 0..3)."""
    s = seq.to(torch.int64)
    n_k = s.shape[-1] - k + 1
    code = torch.zeros(s.shape[:-1] + (n_k,), dtype=torch.int64, device=s.device)
    valid = torch.ones_like(code, dtype=torch.bool)
    for j in range(k):
        base = s[..., j: j + n_k]
        valid &= (base >= 0) & (base < 4)
        code |= (base & 3) << (2 * (k - 1 - j))
    return torch.where(valid, code & MASK32, INVALID)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on values in ``[0, 2**32)``."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def minimizers(seq: torch.Tensor, *, w: int, k: int):
    """``(is_min, hashes)`` over ``[..., n-k+1]`` k-mer positions: a k-mer
    is sampled when it is the first least hash of some ``w``-window."""
    codes = kmer_codes(seq, k)
    h = torch.where(codes == INVALID, INVALID, hash32(codes))
    n_win = h.shape[-1] - w + 1
    best = h[..., :n_win]
    arg = torch.zeros_like(best)
    for j in range(1, w):
        cand = h[..., j: j + n_win]
        less = cand < best
        best = torch.where(less, cand, best)
        arg = torch.where(less, j, arg)
    arg = arg + torch.arange(n_win, device=h.device)
    is_min = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    is_min.scatter_(-1, arg, True)
    return is_min & (h != INVALID), h


class Index(NamedTuple):
    hashes: torch.Tensor  # [M] int64, sorted
    positions: torch.Tensor  # [M] int64


def build_index(ref: torch.Tensor, *, w: int, k: int, freq_frac: float) -> Index:
    """The sorted minimizer table of ``ref`` without the hashes that occur
    more often than the ``1 - freq_frac`` quantile of the counts."""
    is_min, h = minimizers(ref, w=w, k=k)
    pos = torch.nonzero(is_min).squeeze(1)
    hh, order = torch.sort(h[pos], stable=True)
    pos = pos[order]
    uniq_counts = torch.unique_consecutive(hh, return_counts=True)[1]
    cap = max(1, int(np.quantile(uniq_counts.cpu().numpy(), 1.0 - freq_frac)))
    keep = torch.repeat_interleave(uniq_counts <= cap, uniq_counts)
    return Index(hashes=hh[keep], positions=pos[keep])


def seed_candidates(reads, idx: Index, *, w: int, k: int, max_candidates: int,
                    max_seeds: int = 64):
    """Each read's ``max_candidates`` best-supported diagonals: up to 4
    table hits for each of its ``max_seeds`` least minimizers, diagonals
    bucketed by 32, ties in bucket order.  ``(starts, votes)``, ``[B, C]``;
    an empty slot has 0 votes."""
    is_min, h = minimizers(reads, w=w, k=k)
    score = torch.where(is_min, h, INVALID)
    order = torch.argsort(score, dim=-1, stable=True)[..., :max_seeds]
    seed_hash = torch.gather(h, -1, order)
    seed_valid = torch.gather(is_min, -1, order)
    lo = torch.searchsorted(idx.hashes, seed_hash, side="left")
    hi = torch.searchsorted(idx.hashes, seed_hash, side="right")
    hit = lo.unsqueeze(-1) + torch.arange(4, device=reads.device)
    hit_ok = (hit < hi.unsqueeze(-1)) & seed_valid.unsqueeze(-1)
    ref_pos = idx.positions[hit.clamp(0, idx.positions.shape[0] - 1)]
    diag = torch.where(hit_ok, ref_pos - order.unsqueeze(-1), _NO_DIAG).flatten(-2)
    bucket = torch.where(diag <= -(2 ** 29), _NO_DIAG, diag >> 5)
    sortb = torch.sort(bucket, dim=-1).values
    first = torch.ones_like(sortb[..., :1], dtype=torch.bool)
    run_id = torch.cumsum(torch.cat([first, sortb[..., 1:] != sortb[..., :-1]],
                                    dim=-1).to(torch.int64), dim=-1) - 1
    live = sortb > -(2 ** 29)
    votes = torch.zeros_like(sortb).scatter_add_(-1, run_id, live.to(torch.int64))
    starts = torch.zeros_like(sortb).scatter_reduce_(
        -1, run_id, torch.where(live, sortb << 5, _NO_DIAG), reduce="amax",
        include_self=True)
    top = torch.argsort(-votes, dim=-1, stable=True)[..., :max_candidates]
    return (torch.gather(starts, -1, top).clamp(min=0),
            torch.gather(votes, -1, top))
