"""GenASM in plain PyTorch: the Bitap filter and the windowed DC + TB aligner.

A frozen copy, for the benchmark's plain reference, of the algorithms
the paper defines (GenASM-DC, Algorithm 1; GenASM-TB, Algorithm 2; the
chained divide-and-conquer windows of Figure 4-3), batched over lanes
and run as Python loops of whole-batch tensor operations.  It uses no
kernel and nothing of the program.
"""
from __future__ import annotations

import torch

from .bits import (SENTINEL, WILDCARD, first_match_distance, get_bit, n_words,
                   ones, pattern_bitmasks, shl1)

TB_MATCH, TB_INS, TB_DEL = 0, 1, 2
OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3
OP_PAD = -1
AFFINE_CODES = (OP_I, OP_D, OP_M, OP_X, OP_I, OP_D)


class Geometry:
    """Window geometry: width ``w``, overlap ``o``, errors a window ``k``."""

    def __init__(self, w: int, o: int, k: int):
        self.w, self.o, self.k = w, o, k
        self.commit = w - o

    def n_windows(self, p_cap: int) -> int:
        return -(-p_cap // self.commit) + 2


def dc_step(R_old, cur_pm, k: int, with_store: bool = True):
    """One text character of GenASM-DC over every lane: the new status
    rows ``[..., k+1, nw]`` and, with the store, the (M, I, D) rows."""
    R0 = shl1(R_old[..., 0, :]) | cur_pm
    rows = [R0]
    D = R_old[..., :-1, :]
    M = shl1(R_old[..., 1:, :]) | cur_pm.unsqueeze(-2)
    DSM = D & shl1(D) & M
    for d in range(k):
        rows.append(DSM[..., d, :] & shl1(rows[-1]))
    R_new = torch.stack(rows, dim=-2)
    if not with_store:
        return R_new, None
    bound = ones(R0.shape[:-1] + (1,) + R0.shape[-1:], device=R0.device)
    M_all = torch.cat([R0.unsqueeze(-2), M], dim=-2)
    I_all = torch.cat([bound, shl1(R_new[..., :-1, :])], dim=-2)
    D_all = torch.cat([bound, D], dim=-2)
    return R_new, torch.stack([M_all, I_all, D_all], dim=-2)


def dc_scan(text, pattern, n_bits: int, k: int, with_store: bool):
    """Scan each lane's text from its last character to its first;
    yields ``(i, R, store)`` per character."""
    n_lanes, n = text.shape
    pm = pattern_bitmasks(pattern, n_bits)
    txt = text.to(torch.int64)
    lanes = torch.arange(n_lanes, device=text.device)
    R = ones((n_lanes, k + 1, n_words(n_bits)), device=text.device)
    for i in range(n - 1, -1, -1):
        R, store = dc_step(R, pm[lanes, txt[:, i]], k, with_store)
        yield i, R, store


def window_dc(sub_text, sub_pattern, *, w: int, k: int):
    """GenASM-DC of one ``w``-wide window per lane: ``(d_min [B], store
    [B, w, k+1, 3, nw])``, anchored at text position 0."""
    b = sub_text.shape[0]
    tb = torch.empty((b, w, k + 1, 3, n_words(w)), dtype=torch.int32,
                     device=sub_text.device)
    for i, R, store in dc_scan(sub_text, sub_pattern, w, k, True):
        tb[:, i] = store
    return first_match_distance((R[..., -1] >> 31) & 1, k), tb


def bitap_search(text, pattern, *, m_bits: int, k: int):
    """The least ``d <= k`` matching each lane's whole pattern at each
    text position (``k+1`` where none): ``[N, n] int32``."""
    n_lanes, n = text.shape
    top = torch.empty((n_lanes, n, k + 1), dtype=torch.int32, device=text.device)
    for i, R, _ in dc_scan(text, pattern, m_bits, k, False):
        top[:, i] = R[..., -1]
    return first_match_distance((top >> 31) & 1, k)


def window_tb(tb, d_start, cap_p, *, w: int, o: int, k: int):
    """GenASM-TB over one window per lane, affine gaps preferred, then
    match > substitution > insertion > deletion.  Returns ``(pc, tc, err,
    ops [B, 2(w-o)] int8, n_ops, stuck)``."""
    dev = d_start.device
    b = d_start.shape[0]
    max_steps, cap_t = 2 * (w - o), w - o
    cap_p = cap_p.to(torch.int64)
    d_start = d_start.to(torch.int64)
    codes = torch.tensor(AFFINE_CODES, dtype=torch.int64, device=dev)
    lanes = torch.arange(b, device=dev)
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    pattern_i = torch.full((b,), w - 1, dtype=torch.int64, device=dev)
    text_i, pc, tc, n_ops = zeros, zeros, zeros, zeros
    cur_error = d_start
    prev_op = torch.full((b,), OP_PAD, dtype=torch.int64, device=dev)
    ops = torch.full((b, max_steps), OP_PAD, dtype=torch.int8, device=dev)
    stuck = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        active = (pc < cap_p) & (tc < cap_t) & (pattern_i >= 0) & (~stuck)
        ti = text_i.clamp(0, w - 1)
        de = cur_error.clamp(0, k)
        pi = pattern_i.clamp(0, w - 1)
        vec = tb[lanes, ti, de]
        dvec = vec[:, TB_DEL]
        m_ok = get_bit(vec[:, TB_MATCH], pi) == 0
        has_err = cur_error > 0
        i_ok = (get_bit(vec[:, TB_INS], pi) == 0) & has_err
        d_ok = (get_bit(dvec, pi) == 0) & has_err
        s_ok = ((pi == 0) | (get_bit(dvec, (pi - 1).clamp(min=0)) == 0)) & has_err
        cands = torch.stack([i_ok & (prev_op == OP_I), d_ok & (prev_op == OP_D),
                             m_ok, s_ok, i_ok, d_ok], dim=1)
        any_ok = cands.any(1)
        op = codes[cands.to(torch.int8).argmax(1)]
        stuck = stuck | (active & ~any_ok)
        take = active & any_ok
        consume_p = (take & ((op == OP_M) | (op == OP_X) | (op == OP_I))).long()
        consume_t = (take & ((op == OP_M) | (op == OP_X) | (op == OP_D))).long()
        ops[lanes, n_ops] = torch.where(take, op.to(torch.int8), ops[lanes, n_ops])
        pattern_i = pattern_i - consume_p
        text_i = text_i + consume_t
        cur_error = cur_error - (take & (op != OP_M)).long()
        prev_op = torch.where(take, op, prev_op)
        pc, tc = pc + consume_p, tc + consume_t
        n_ops = n_ops + take.long()
    return pc, tc, d_start - cur_error, ops, n_ops, stuck


def pad_to(buf, lens, size: int, fill: int):
    """``[B, *]`` int8 buffers -> ``[B, size]``, ``fill`` from ``lens`` on."""
    out = torch.full((buf.shape[0], size), fill, dtype=buf.dtype, device=buf.device)
    n = min(buf.shape[1], size)
    out[:, :n] = buf[:, :n]
    idx = torch.arange(size, device=buf.device)
    return torch.where(idx < lens.unsqueeze(1), out, fill)


def slice_windows(buf, start, w: int):
    """Per-lane ``[B, w]`` windows at ``start``, clamped to fit."""
    start = start.clamp(0, buf.shape[1] - w)
    return torch.gather(buf, 1, start.unsqueeze(1) + torch.arange(w, device=buf.device))


def window_commit(carry, *, d_min, pc, tc, err, n_ops, stuck, p_len, k):
    """Advance ``(pattern, text, distance, failed, done)`` by one window."""
    cur_p, cur_t, dist, failed, done = carry
    this_fail = ((d_min > k) | stuck) & (~done)
    skip = done | this_fail
    adv_p = torch.where(skip, 0, pc)
    n_emit = torch.where(skip, 0, n_ops)
    new = (cur_p + adv_p, cur_t + torch.where(skip, 0, tc),
           dist + torch.where(skip, 0, err), failed | this_fail,
           skip | (cur_p + adv_p >= p_len))
    return new, n_emit


def scatter_windows(vals_w, n_ops_w, cap: int, fill: int):
    """Concatenate each lane's per-window op buffers ``[B, n_win, steps]``
    into one ``[B, cap]`` buffer."""
    b, _, steps = vals_w.shape
    offsets = torch.cumsum(n_ops_w, dim=1) - n_ops_w
    step_idx = torch.arange(steps, device=vals_w.device)
    pos = torch.where(step_idx < n_ops_w.unsqueeze(-1),
                      offsets.unsqueeze(-1) + step_idx, cap)
    out = torch.full((b, cap + 1), fill, dtype=vals_w.dtype, device=vals_w.device)
    out.scatter_(1, pos.reshape(b, -1), vals_w.reshape(b, -1))
    return out[:, :cap]


def align(texts, patterns, p_lens, t_lens, *, geo: Geometry, p_cap: int):
    """Windowed GenASM of ``patterns[b, :p_len]`` against ``texts[b,
    :t_len]``, anchored at text 0, the whole pattern consumed, trailing
    text free.  Returns ``(distance [B] (-1 failed), ops [B, cap] int8,
    n_ops [B], failed [B])``."""
    w, o, k = geo.w, geo.o, geo.k
    n_win = geo.n_windows(p_cap)
    dev = texts.device
    b = texts.shape[0]
    p_lens = p_lens.to(dev, torch.int64)
    t_lens = t_lens.to(dev, torch.int64)
    pats = pad_to(patterns, p_lens, p_cap + w, WILDCARD)
    txts = pad_to(texts, t_lens, p_cap + n_win * geo.commit + w, SENTINEL)
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    carry = (zeros, zeros, zeros, torch.zeros(b, dtype=torch.bool, device=dev),
             p_lens <= 0)
    ops_w, n_ops_w = [], []
    for _ in range(n_win):
        sub_p = slice_windows(pats, carry[0], w)
        sub_t = slice_windows(txts, carry[1], w)
        d_min, store = window_dc(sub_t, sub_p, w=w, k=k)
        d_min = d_min.to(torch.int64)
        cap_p = torch.clamp(p_lens - carry[0], max=geo.commit)
        pc, tc, err, ops, n_ops, stuck = window_tb(
            store, d_min.clamp(max=k), cap_p, w=w, o=o, k=k)
        carry, n_emit = window_commit(carry, d_min=d_min, pc=pc, tc=tc, err=err,
                                      n_ops=n_ops, stuck=stuck, p_len=p_lens, k=k)
        ops_w.append(ops)
        n_ops_w.append(n_emit)
    _, _, dist, failed, done = carry
    failed = failed | (~done)
    n_ops_w = torch.stack(n_ops_w, dim=1)
    out = scatter_windows(torch.stack(ops_w, dim=1), n_ops_w,
                          n_win * 2 * geo.commit, OP_PAD)
    return (torch.where(failed, -1, dist).to(torch.int32), out,
            n_ops_w.sum(1).to(torch.int32), failed)
