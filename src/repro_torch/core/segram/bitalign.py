"""BitAlign's DC recurrence and tail mask (paper §6.7, §6.8.2).

Port of `repro.core.segram.bitalign._tail_mask`, plus `bitalign_rows`:
the DC scan batched over ``[B]`` subgraphs, which the graph window loop
and the mapper's filter run (`graph/windowed.py`) and which is the plain
version of the CUDA kernel `repro_torch.kernels.bitalign`.  The
whole-subgraph ``bitalign_dc``/``bitalign_tb`` serve only
`core/segram/segram.py`, which is not ported yet.
"""
from __future__ import annotations

import torch

from ..bitvector import (ALL_ONES, WORD_BITS, n_words, pattern_bitmasks, shl1,
                         to_i32)
from ..genasm_dc import first_match_distance
from .graph import HOP_LIMIT


def _tail_mask(p_len, m_bits: int) -> torch.Tensor:
    """``[..., nw]`` int32 bit patterns: ones with the low ``m_bits -
    p_len`` bits cleared, one row per entry of ``p_len``.

    Word-aligned patterns shorter than ``m_bits`` are handled by treating
    the wildcard tail as *pre-matched everywhere*: every status bitvector
    keeps its low ``pad`` bits at 0, so the tail never consumes graph
    nodes.
    """
    nw = n_words(m_bits)
    p_len = torch.as_tensor(p_len, dtype=torch.int64)
    word = torch.arange(nw, dtype=torch.int64, device=p_len.device)
    bits_below = (m_bits - p_len.unsqueeze(-1) - WORD_BITS * word).clamp(0, 32)
    low = torch.where(bits_below >= 32, 0xFFFFFFFF, (1 << bits_below) - 1)
    return to_i32(0xFFFFFFFF ^ low)


def _and_over_hops(x: torch.Tensor) -> torch.Tensor:
    """AND-reduce ``[B, HOP_LIMIT, ...]`` over the hop axis (a tree of
    halvings; HOP_LIMIT is a power of two)."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] & x[:, half:]
    return x[:, 0]


def bitalign_rows(bases: torch.Tensor, succ: torch.Tensor,
                  patterns: torch.Tensor, p_lens: torch.Tensor, *,
                  m_bits: int, k: int, store_r: bool = True):
    """BitAlign DC over ``[B, N]`` linearized subgraphs, one per lane.

    ``bases`` int8, ``succ`` int32 hopBits, ``patterns [B, m_bits]`` int8
    wildcard-padded, ``p_lens [B]`` the patterns' real lengths (the tail
    past them is pre-matched, `_tail_mask`).  Nodes are scanned ``i =
    N-1 .. 0``; a ring of the last ``HOP_LIMIT`` nodes' status rows,
    initialised to the tail rows, supplies each node's successors (hops
    past N read the initial tail rows).

    Returns ``(dists [B, N] int32, R [B, N, k+1, nw] int32 or None)``:
    ``dists[b, i]`` is the least ``d ≤ k`` aligning the full pattern to a
    path starting at node ``i`` (``k+1`` when none), ``R`` the status rows
    of every node when ``store_r``.
    """
    b, n = bases.shape
    nw = n_words(m_bits)
    dev = bases.device
    H = HOP_LIMIT
    pm = pattern_bitmasks(patterns, m_bits)  # [B, 5, nw]
    # a base outside 0..4 selects an all-zero mask, as the kernel does
    pm = torch.cat([pm, torch.zeros_like(pm[:, :1])], dim=1)
    base = bases.to(torch.int64)
    base = torch.where((base >= 0) & (base <= 4), base, 5)
    tail = _tail_mask(p_lens.to(dev), m_bits)  # [B, nw]
    tail_rows = tail.unsqueeze(1).expand(b, k + 1, nw)
    # ring slot j holds the rows of the last scanned node i with i % H == j
    ring = tail_rows.unsqueeze(1).repeat(1, H, 1, 1)  # [B, H, k+1, nw]
    lanes = torch.arange(b, device=dev)
    slots = torch.arange(H, device=dev)
    top = torch.empty((b, n, k + 1), dtype=torch.int32, device=dev)
    store = (torch.empty((b, n, k + 1, nw), dtype=torch.int32, device=dev)
             if store_r else None)
    for i in range(n - 1, -1, -1):
        # slot j holds node i+1+h for hop h = (j - i - 1) mod H
        hop_of_slot = (slots - i - 1) % H
        use = ((succ[:, i:i + 1] >> hop_of_slot) & 1).to(torch.bool)  # [B, H]
        comb = _and_over_hops(torch.where(use[:, :, None, None], ring,
                                          ALL_ONES)) & tail_rows
        cur_pm = pm[lanes, base[:, i]]  # [B, nw]
        rows = [(shl1(comb[:, 0]) | cur_pm) & tail]
        if k > 0:
            D = comb[:, :-1]
            DSM = D & shl1(D) & (shl1(comb[:, 1:]) | cur_pm.unsqueeze(1)) \
                & tail.unsqueeze(1)
            for d in range(k):  # I = shl1(R[d-1]) is the only serial term
                rows.append(DSM[:, d] & shl1(rows[-1]))
        R = torch.stack(rows, dim=1)  # [B, k+1, nw]
        ring[:, i % H] = R
        top[:, i] = R[..., -1]
        if store is not None:
            store[:, i] = R
    return first_match_distance((top >> 31) & 1, k), store
