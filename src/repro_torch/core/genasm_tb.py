"""GenASM-TB: the paper's Bitap-compatible traceback (Algorithm 2).

Batched port of `repro.core.genasm_tb`.  Each lane walks its window's
intermediate bitvectors from the MSB (pattern[0]) toward the LSB,
following the chain of 0s and reverting the DC bitwise operations, and
emits packed CIGAR ops:

    0 = M (match)   1 = X (substitution)   2 = I (insertion)   3 = D (deletion)
    -1 = padding

The reference runs a fixed-trip ``fori_loop`` under ``vmap``; here the
``2·(w−o)`` steps are a Python loop over ``[B]``-lane state tensors, with
inactive lanes masked exactly as the reference masks them.  With
``affine=True`` a gap extension is preferred; the remaining priority is
match > substitution > insertion > deletion.
"""
from __future__ import annotations

import torch

from .bitvector import get_bit
from .genasm_dc import TB_DEL, TB_INS, TB_MATCH

OP_M, OP_X, OP_I, OP_D = 0, 1, 2, 3
OP_PAD = -1

_AFFINE_CODES = (OP_I, OP_D, OP_M, OP_X, OP_I, OP_D)
_PLAIN_CODES = (OP_M, OP_X, OP_I, OP_D)


def _walk(check_bits, d_start, cap_p, *, w: int, o: int, k: int, affine: bool):
    """The traceback walk shared by both store layouts.

    ``check_bits(ti, de, pi, cur_error)`` returns the per-lane booleans
    ``(mbit, sbit, ibit, dbit)`` — bit ``pi`` of the M/S/I/D check vectors
    at text position ``ti`` and distance ``de`` (0 = available).
    Returns ``(pc, tc, err_used, ops [B, 2(w-o)] int8, n_ops, stuck)``.
    """
    dev = d_start.device
    b = d_start.shape[0]
    max_steps = 2 * (w - o)
    cap_t = w - o
    cap_p = cap_p.to(torch.int64)
    d_start = d_start.to(torch.int64)
    codes = torch.tensor(_AFFINE_CODES if affine else _PLAIN_CODES,
                         dtype=torch.int64, device=dev)
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
        mbit, sbit, ibit, dbit = check_bits(ti, de, pi, cur_error)

        has_err = cur_error > 0
        m_ok = mbit
        s_ok = sbit & has_err
        i_ok = ibit & has_err
        d_ok = dbit & has_err
        if affine:
            cands = torch.stack([i_ok & (prev_op == OP_I), d_ok & (prev_op == OP_D),
                                 m_ok, s_ok, i_ok, d_ok], dim=1)
        else:
            cands = torch.stack([m_ok, s_ok, i_ok, d_ok], dim=1)

        any_ok = cands.any(1)
        op = codes[cands.to(torch.int8).argmax(1)]
        stuck = stuck | (active & ~any_ok)
        take = active & any_ok
        consume_p = (take & ((op == OP_M) | (op == OP_X) | (op == OP_I))).to(torch.int64)
        consume_t = (take & ((op == OP_M) | (op == OP_X) | (op == OP_D))).to(torch.int64)
        err_dec = (take & (op != OP_M)).to(torch.int64)

        ops[lanes, n_ops] = torch.where(take, op.to(torch.int8), ops[lanes, n_ops])
        pattern_i = pattern_i - consume_p
        text_i = text_i + consume_t
        cur_error = cur_error - err_dec
        prev_op = torch.where(take, op, prev_op)
        pc = pc + consume_p
        tc = tc + consume_t
        n_ops = n_ops + take.to(torch.int64)

    return pc, tc, d_start - cur_error, ops, n_ops, stuck


def window_tb(tb: torch.Tensor, d_start: torch.Tensor, cap_p: torch.Tensor, *,
              w: int, o: int, k: int, affine: bool = True):
    """Traceback over one window per lane.

    ``tb``: ``[B, w, k+1, 3, nw]`` from `window_dc` (or the v1 kernel);
    ``d_start``: ``[B]`` window minimum distances; ``cap_p``: ``[B]``
    pattern commit caps, ``min(w - o, remaining pattern)``.

    Returns ``(pc, tc, err_used, ops [B, 2(w-o)] int8, n_ops, stuck)``.
    """
    lanes = torch.arange(tb.shape[0], device=tb.device)

    def check_bits(ti, de, pi, cur_error):
        vec = tb[lanes, ti, de]  # [B, 3, nw]
        dvec = vec[:, TB_DEL]
        mbit = get_bit(vec[:, TB_MATCH], pi) == 0
        ibit = get_bit(vec[:, TB_INS], pi) == 0
        dbit = get_bit(dvec, pi) == 0
        # substitution vector = shl1(deletion vector): bit pi of S is bit
        # pi-1 of D, and the shifted-in LSB is 0 (always "available")
        sbit = (pi == 0) | (get_bit(dvec, (pi - 1).clamp(min=0)) == 0)
        return mbit, sbit, ibit, dbit

    return _walk(check_bits, d_start, cap_p, w=w, o=o, k=k, affine=affine)


def window_tb_r(store_r: torch.Tensor, sub_text: torch.Tensor, pm: torch.Tensor,
                d_start: torch.Tensor, cap_p: torch.Tensor, *,
                w: int, o: int, k: int, affine: bool = True):
    """Traceback over R-only storage (the v2 kernel's store).

    ``store_r``: ``[B, w+1, k+1, nw]`` from `window_dc_r` / kernel v2;
    ``sub_text``: ``[B, w]``; ``pm``: ``[B, 5, nw]`` pattern bitmasks of
    the sub-patterns.  Check vectors: D=R(i+1,d−1), S=shl1(D),
    I=shl1(R(i,d−1)), M=shl1(R(i+1,d)) | PM[text[i]].
    """
    lanes = torch.arange(store_r.shape[0], device=store_r.device)
    text = sub_text.to(torch.int64)

    def bit_or_true_at0(vec, bit):
        # bit ``bit`` of shl1(vec): the shifted-in 0 at bit 0 is "available"
        return (bit == 0) | (get_bit(vec, (bit - 1).clamp(min=0)) == 0)

    def check_bits(ti, de, pi, cur_error):
        dem1 = (cur_error - 1).clamp(0, k)
        r_next_d = store_r[lanes, ti + 1, de]  # R(i+1, d)
        r_next_dm1 = store_r[lanes, ti + 1, dem1]  # R(i+1, d-1)
        r_here_dm1 = store_r[lanes, ti, dem1]  # R(i, d-1)
        pm_bit = get_bit(pm[lanes, text[lanes, ti]], pi) == 0
        mbit = pm_bit & bit_or_true_at0(r_next_d, pi)
        ibit = bit_or_true_at0(r_here_dm1, pi)
        dbit = get_bit(r_next_dm1, pi) == 0
        sbit = bit_or_true_at0(r_next_dm1, pi)
        return mbit, sbit, ibit, dbit

    return _walk(check_bits, d_start, cap_p, w=w, o=o, k=k, affine=affine)


def cigar_counts(ops: torch.Tensor, n_ops: torch.Tensor) -> torch.Tensor:
    """Counts of (M, X, I, D) over the valid prefix of packed op buffers."""
    idx = torch.arange(ops.shape[-1], device=ops.device)
    valid = idx < n_ops.unsqueeze(-1)
    return torch.stack([(valid & (ops == code)).sum(-1)
                        for code in (OP_M, OP_X, OP_I, OP_D)], dim=-1)


def cigar_score(ops: torch.Tensor, n_ops: torch.Tensor, *, match: int = 2,
                subs: int = -4, gap_open: int = -4,
                gap_extend: int = -2) -> torch.Tensor:
    """Affine-gap score of packed CIGARs (Minimap2-style defaults).

    ``ops [..., S]``, ``n_ops [...]``; a gap of length L costs open +
    L·extend.  Returns ``[...]`` int32.
    """
    valid = torch.arange(ops.shape[-1], device=ops.device) < n_ops.unsqueeze(-1)
    prev = torch.cat([torch.full_like(ops[..., :1], OP_PAD), ops[..., :-1]], -1)
    is_gap = (ops == OP_I) | (ops == OP_D)
    opens = is_gap & (ops != prev)
    s = (match * (valid & (ops == OP_M)).sum(-1)
         + subs * (valid & (ops == OP_X)).sum(-1)
         + gap_open * (valid & opens).sum(-1)
         + gap_extend * (valid & is_gap).sum(-1))
    return s.to(torch.int32)
