"""MinSeed: minimizer-based indexing & seeding (paper §6.1, §6.5, §6.6).

Port of `repro.core.segram.minimizer`.  (w, k)-minimizers: in every
window of ``w`` consecutive k-mers the one with the smallest hash is
sampled.  The reference index is a sorted (hash, position) table built
offline; queries are ``searchsorted`` lookups on the device.

Integer conventions: the reference's uint32 k-mer codes and hashes are
carried in ``int64`` (values in ``[0, 2**32)``), so the ``0xFFFFFFFF``
invalid/unsampled sentinel orders above every real hash exactly as it
does in uint32; positions and diagonals are ``int64`` too.  Every
function takes any number of leading (lane) dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device

MASK32 = 0xFFFFFFFF
INVALID = MASK32  # code/hash of a k-mer touching a non-ACGT char
_NO_DIAG = -(2 ** 30)


def kmer_codes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """Packed 2-bit k-mer codes ``[..., n-k+1] int64`` of ``[..., n]`` bases.

    Positions whose k-mer touches a non-ACGT char get ``INVALID``.
    """
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
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)``, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Invertible 32-bit mix (murmur3 finalizer) — the minimizer ordering.

    ``x``: int64 values in ``[0, 2**32)``; the result is too.
    """
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def minimizers(seq: torch.Tensor, *, w: int, k: int):
    """Minimizer sampling (paper Figure 6-4).

    Returns ``(is_min [..., n-k+1] bool, hashes [..., n-k+1] int64)``:
    positions that are the minimum-hash k-mer of at least one w-window
    (the first minimum on ties, as ``argmin`` picks it).
    """
    codes = kmer_codes(seq, k)
    h = torch.where(codes == INVALID, INVALID, hash32(codes))
    n_k = h.shape[-1]
    n_win = n_k - w + 1
    best = h[..., :n_win]
    arg = torch.zeros_like(best)
    for j in range(1, w):  # running first-argmin over the window
        cand = h[..., j: j + n_win]
        less = cand < best
        best = torch.where(less, cand, best)
        arg = torch.where(less, j, arg)
    arg = arg + torch.arange(n_win, device=h.device)
    is_min = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    is_min.scatter_(-1, arg, True)
    return is_min & (h != INVALID), h


class MinimizerIndex(NamedTuple):
    """Sorted minimizer table (host arrays, as the reference builds it)."""

    hashes: np.ndarray  # [M] uint32 sorted
    positions: np.ndarray  # [M] int32 reference positions
    freq_cap: int


def build_index(ref: np.ndarray, *, w: int = 10, k: int = 15,
                freq_frac: float = 0.0002,
                device: torch.device | str = "cuda") -> MinimizerIndex:
    """Offline index construction (paper §6.5) with frequency filtering.

    Sampling runs on ``device`` (the card unless the caller passes
    ``device="cpu"``); the sort and the frequency filter run in numpy, as
    in the reference.
    """
    device = resolve_device(device)
    is_min, h = minimizers(torch.as_tensor(np.asarray(ref, np.int8), device=device),
                           w=w, k=k)
    is_min = is_min.cpu().numpy()
    h = h.cpu().numpy().astype(np.uint32)
    pos = np.nonzero(is_min)[0].astype(np.int32)
    hh = h[pos]
    order = np.argsort(hh, kind="stable")
    hh, pos = hh[order], pos[order]
    # frequency filter: drop hashes occurring more than cap times
    uniq, counts = np.unique(hh, return_counts=True)
    if len(uniq):
        cap = max(1, int(np.quantile(counts, 1.0 - freq_frac)))
        bad = uniq[counts > cap]
        keep = ~np.isin(hh, bad)
        hh, pos = hh[keep], pos[keep]
    else:
        cap = 1
    return MinimizerIndex(hashes=hh, positions=pos, freq_cap=cap)


def seed_candidates(reads: torch.Tensor, idx_hashes: torch.Tensor,
                    idx_positions: torch.Tensor, *, w: int = 10, k: int = 15,
                    max_seeds: int = 64, max_candidates: int = 8):
    """MinSeed query: read minimizers → candidate mapping locations.

    ``reads``: ``[B, n]``; ``idx_hashes``/``idx_positions``: ``[M]``
    int64 sorted table.  Candidate region start = ref_pos − read_pos
    (paper Figure 6-5); diagonal votes are bucketed (``>> 5``) and the
    ``max_candidates`` most-supported diagonals returned, ties in
    bucket order.  Returns ``(starts [B, C] int64, votes [B, C] int64)``;
    empty slots have votes == 0.
    """
    is_min, h = minimizers(reads, w=w, k=k)
    score = torch.where(is_min, h, INVALID)
    order = torch.argsort(score, dim=-1, stable=True)[..., :max_seeds]
    seed_hash = torch.gather(h, -1, order)
    seed_valid = torch.gather(is_min, -1, order)

    lo = torch.searchsorted(idx_hashes, seed_hash, side="left")
    hi = torch.searchsorted(idx_hashes, seed_hash, side="right")
    # take up to 4 index hits per seed
    hit = lo.unsqueeze(-1) + torch.arange(4, device=reads.device)
    hit_ok = (hit < hi.unsqueeze(-1)) & seed_valid.unsqueeze(-1)
    ref_pos = idx_positions[hit.clamp(0, idx_positions.shape[0] - 1)]
    diag = torch.where(hit_ok, ref_pos - order.unsqueeze(-1), _NO_DIAG)
    diag = diag.flatten(-2)

    # bucket diagonals (tolerance via >> 5) and vote
    bucket = torch.where(diag <= -(2 ** 29), _NO_DIAG, diag >> 5)
    sortb = torch.sort(bucket, dim=-1).values
    first = torch.ones_like(sortb[..., :1], dtype=torch.bool)
    uniq_mask = torch.cat([first, sortb[..., 1:] != sortb[..., :-1]], dim=-1)
    run_id = torch.cumsum(uniq_mask.to(torch.int64), dim=-1) - 1
    live = sortb > -(2 ** 29)
    votes = torch.zeros_like(sortb).scatter_add_(-1, run_id, live.to(torch.int64))
    # the zero-initialised buffer takes part in the max, as .at[].max does
    starts_sorted = torch.zeros_like(sortb).scatter_reduce_(
        -1, run_id, torch.where(live, sortb << 5, _NO_DIAG), reduce="amax",
        include_self=True)
    top = torch.argsort(-votes, dim=-1, stable=True)[..., :max_candidates]
    return (torch.gather(starts_sorted, -1, top).clamp(min=0),
            torch.gather(votes, -1, top))
