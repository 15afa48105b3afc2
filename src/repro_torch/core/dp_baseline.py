"""Dynamic-programming alignment baselines (the paper's software comparison).

Port of `repro.core.dp_baseline`, batched over ``[B]`` pairs.  The paper
benchmarks GenASM against the DP alignment kernels inside
BWA-MEM/Minimap2 (affine-gap Smith-Waterman/Needleman-Wunsch) and
against GACT's tiled DP.  These are those recurrences, row by row over
the pattern with O(n) memory per pair — the quadratic cost GenASM
replaces.  No timed path runs them: they are integer DP held bitwise
against the reference, so plain loops are kept where they read most
directly (the affine recurrence walks its columns in Python).
"""
from __future__ import annotations

import torch

NEG = -(10 ** 7)
BIG = 10 ** 6


def nw_edit_distance(text: torch.Tensor, pattern: torch.Tensor,
                     p_len: torch.Tensor, t_len: torch.Tensor) -> torch.Tensor:
    """Unit-cost semi-global distance (anchored start, free text end).

    ``text [B, n]``, ``pattern [B, m]`` int8 buffers, masked past
    ``p_len`` / ``t_len`` ``[B]`` so fixed buffers work.  Returns ``[B]``
    int32 (``10**6`` when ``p_len`` is 0, as in the reference).

    The in-row recurrence ``cur[j] = min(diag[j], up[j], cur[j-1] + 1)``
    is ``j + cummin(min(diag, up)[l] - l)`` over ``l <= j``, exact in
    integers.
    """
    b, m_cap = pattern.shape
    n_cap = text.shape[-1]
    dev = text.device
    t_len = t_len.to(device=dev, dtype=torch.int64).unsqueeze(-1)
    p_len = p_len.to(device=dev, dtype=torch.int64)
    cols = torch.arange(n_cap + 1, device=dev)
    outside = cols > t_len  # [B, n+1]
    prev = torch.where(outside, BIG, cols.expand(b, -1))  # dp[0][j] = j
    best = torch.full((b,), BIG, dtype=torch.int64, device=dev)
    for pi in range(m_cap):
        cost = (pattern[:, pi:pi + 1] != text).to(torch.int64)
        step = torch.minimum(prev[:, :-1] + cost, prev[:, 1:] + 1)
        first = torch.full((b, 1), pi + 1, dtype=torch.int64, device=dev)
        lead = torch.cat([first, step], dim=-1) - cols
        row = torch.where(outside, BIG, lead.cummin(-1).values + cols)
        active = (pi < p_len).unsqueeze(-1)
        prev = torch.where(active, row, prev)
        best = torch.where(p_len - 1 == pi, row.min(-1).values, best)
    return best.to(torch.int32)


def affine_align_score(text: torch.Tensor, pattern: torch.Tensor,
                       p_len: torch.Tensor, t_len: torch.Tensor, *,
                       match: int = 2, subs: int = -4, gap_open: int = -4,
                       gap_extend: int = -2, local: bool = False) -> torch.Tensor:
    """Affine-gap alignment score (Gotoh).  ``local=True`` → Smith-Waterman.

    Semi-global otherwise: pattern fully consumed, free text end, anchored
    text start.  A gap of length L costs open + L·extend (minimap2
    convention).  Shapes as `nw_edit_distance`; returns ``[B]`` int32.
    """
    b, m_cap = pattern.shape
    n_cap = text.shape[-1]
    dev = text.device
    t_len = t_len.to(device=dev, dtype=torch.int64).unsqueeze(-1)
    p_len = p_len.to(device=dev, dtype=torch.int64)
    cols = torch.arange(n_cap + 1, device=dev).expand(b, -1)
    outside = cols > t_len
    # H: best score; E: gap-in-pattern (deletion run); F: gap-in-text
    if local:
        H = torch.zeros((b, n_cap + 1), dtype=torch.int64, device=dev)
    else:  # leading deletions
        H = torch.where(cols == 0, 0, gap_open + gap_extend * cols)
    E = torch.full((b, n_cap + 1), NEG, dtype=torch.int64, device=dev)
    best = torch.full((b,), NEG, dtype=torch.int64, device=dev)
    for pi in range(m_cap):
        sub = torch.where(pattern[:, pi:pi + 1] == text, match, subs)
        diag = H[:, :-1] + sub
        e_row = torch.maximum(E[:, 1:] + gap_extend,
                              H[:, 1:] + gap_open + gap_extend)
        h = torch.full((b,), 0 if local else gap_open + gap_extend * (pi + 1),
                       dtype=torch.int64, device=dev)
        f = torch.full((b,), NEG, dtype=torch.int64, device=dev)
        row = [h]
        for j in range(n_cap):
            f = torch.maximum(f + gap_extend, h + gap_open + gap_extend)
            h = torch.maximum(torch.maximum(diag[:, j], e_row[:, j]), f)
            if local:
                h = h.clamp(min=0)
            row.append(h)
        h_row = torch.where(outside, NEG, torch.stack(row, dim=-1))
        e_full = torch.cat([torch.full_like(e_row[:, :1], NEG), e_row], dim=-1)
        active = (pi < p_len).unsqueeze(-1)
        H = torch.where(active, h_row, H)
        E = torch.where(active, e_full, E)
        if local:
            best = torch.maximum(best, H.max(-1).values)
        else:
            best = torch.where(p_len - 1 == pi, H.max(-1).values, best)
    return best.to(torch.int32)
