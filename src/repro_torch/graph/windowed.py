"""Windowed BitAlign: sequence-to-graph alignment as chained DC+TB windows.

Port of `repro.graph.windowed`, batched over ``[B]`` lanes as
`core/genasm.py` batches the linear aligner.  BitAlign (paper §6.7) is
GenASM's divide-and-conquer dataflow with one generalization: scanning
the linearized subgraph in reverse topological order, the "previous
text character" status bitvectors are the AND of every successor's
bitvectors within the hopBits window (Figure 6-9).  The window loop
shares `core/genasm.window_commit` with the linear aligner, so on a
pure-backbone graph the results equal the linear ones bit for bit.

Packed graph text: one int32 per node, base id in the low 8 bits and
the window-masked hopBits in bits 8..8+HOP_LIMIT (24 bits used, so the
uint32 values of the reference fit int32 unchanged).
``pack_linear_text`` packs a plain int8 text as a hop-0 chain.

Both plain DCs here run `core/segram/bitalign.bitalign_rows`, which is
also the plain version of the CUDA kernel
`repro_torch.kernels.bitalign.bitalign_dc_batch`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.bitvector import (ALL_ONES, SENTINEL, get_bit,
                                        pattern_bitmasks)
# a name the reference module binds too
from repro_torch.core.bitvector import msb, n_words, ones, shl1  # noqa: F401
from repro_torch.core.genasm import (AlignResult, GenASMConfig, pad_pattern,
                                     slice_windows, window_commit)
from repro_torch.core.genasm_tb import OP_D, OP_I, OP_M, OP_PAD, OP_X
from repro_torch.core.segram.bitalign import bitalign_rows
from repro_torch.core.segram.graph import HOP_LIMIT

_HOP_MASK = (1 << HOP_LIMIT) - 1
# sentinel pad node: matches nothing, chains to its neighbour (hop 0) so a
# packed linear text and the linear aligner's sentinel tail agree bitwise
SENT_NODE = (1 << 8) | SENTINEL

_AFFINE_CODES = (OP_I, OP_D, OP_M, OP_X, OP_I, OP_D)
_PLAIN_CODES = (OP_M, OP_X, OP_I, OP_D)


def pack_graph_text(bases: torch.Tensor, succ_bits: torch.Tensor) -> torch.Tensor:
    """``[..., n]`` (int8 bases, int32 hopBits) -> packed int32 graph text."""
    b = bases.to(torch.int32) & 0xFF
    s = succ_bits.to(torch.int32) & _HOP_MASK
    return (s << 8) | b


def pack_linear_text(text: torch.Tensor) -> torch.Tensor:
    """Pack a plain int8 text as a hop-0 chain graph."""
    return pack_graph_text(text, torch.ones_like(text, dtype=torch.int32))


def unpack_graph_text(gtext: torch.Tensor):
    """Packed int32 graph text -> (bases int8, succ_bits int32)."""
    base = (gtext & 0xFF).to(torch.int8)
    succ = (gtext >> 8) & _HOP_MASK
    return base, succ


def pad_graph_text(gtext: torch.Tensor, t_len: torch.Tensor, cap: int,
                   cfg: GenASMConfig) -> torch.Tensor:
    """Pad/trim ``[B, n]`` packed graph text to ``[B, cap + w]`` with
    sentinel chain nodes from ``t_len`` on (the graph twin of
    `genasm.pad_text`)."""
    size = cap + cfg.w
    out = torch.full((gtext.shape[0], size), SENT_NODE, dtype=torch.int32,
                     device=gtext.device)
    n = min(gtext.shape[1], size)
    out[:, :n] = gtext[:, :n]
    idx = torch.arange(size, device=gtext.device)
    return torch.where(idx < t_len.unsqueeze(1), out, SENT_NODE)


def _graph_buf_cap(p_cap: int, cfg: GenASMConfig) -> int:
    # a window's node advance can overshoot the linear commit by up to one
    # hop, so the buffer carries HOP_LIMIT extra nodes per window
    return p_cap + cfg.n_windows(p_cap) * (cfg.commit + HOP_LIMIT)


def window_dc_graph(bases: torch.Tensor, succ: torch.Tensor,
                    sub_pattern: torch.Tensor, *, w: int, k: int):
    """BitAlign DC over one ``w``-node subgraph window per lane (R-only
    store).

    ``bases``/``succ``/``sub_pattern``: ``[B, w]``.  Returns ``(d_min [B]
    int32, store [B, w, k+1, nw] int32)`` — ``d_min`` is anchored at node
    0, ``store[:, i]`` the status rows of node ``i``.  On a hop-0 chain
    this equals `core/genasm_dc.window_dc_r` bitwise.
    """
    p_lens = torch.full((bases.shape[0],), w, dtype=torch.int64,
                        device=bases.device)  # no tail: full windows
    dists, store = bitalign_rows(bases, succ, sub_pattern, p_lens, m_bits=w,
                                 k=k, store_r=True)
    return dists[:, 0], store


def bitalign_search(bases: torch.Tensor, succ: torch.Tensor,
                    pattern: torch.Tensor, p_len: torch.Tensor, *,
                    m_bits: int, k: int) -> torch.Tensor:
    """Distances-only whole-pattern BitAlign over ``[B, N]`` subgraphs.

    The graph mapper's pre-alignment filter: ``dists[b, i]`` is the
    minimum ``d ≤ k`` aligning the full (tail-masked) pattern to a path
    starting at node ``i`` (``k + 1`` when none) — one pass both filters
    a candidate window and refines its anchor node (argmin).
    """
    return bitalign_rows(bases, succ, pattern, p_len, m_bits=m_bits, k=k,
                         store_r=False)[0]


def window_tb_graph(store: torch.Tensor, succ: torch.Tensor,
                    bases: torch.Tensor, pm: torch.Tensor,
                    d_start: torch.Tensor, cap_p: torch.Tensor, *, w: int,
                    o: int, k: int, affine: bool = True):
    """Graph traceback over each lane's window R-only store.

    ``store [B, w, k+1, nw]``, ``succ``/``bases [B, w]``, ``pm [B, 5,
    nw]`` the sub-patterns' masks, ``d_start``/``cap_p [B]``.  The check
    vectors mirror `genasm_tb.window_tb_r` with the single-successor row
    replaced by the hop combine: an op that consumes a node is valid iff
    some in-window successor's R continues the 0-chain, and the
    successor taken (lowest qualifying hop) is how the walk advances.

    Returns ``(pc, tc, err_used, ops [B, 2(w-o)] int8, n_ops, nodes [B,
    2(w-o)] int32 window-local node per op (-1 for I), stuck)``; ``tc``
    is the node advance for the next window (hops included).
    """
    dev = store.device
    b = store.shape[0]
    H = HOP_LIMIT
    max_steps = 2 * (w - o)
    cap_t = w - o
    cap_p = cap_p.to(torch.int64)
    d_start = d_start.to(torch.int64)
    lanes = torch.arange(b, device=dev)
    lanes2 = lanes.unsqueeze(1)
    hop_rng = torch.arange(H, device=dev)
    no_hops = torch.zeros((b, H), dtype=torch.bool, device=dev)
    codes = torch.tensor(_AFFINE_CODES if affine else _PLAIN_CODES,
                         dtype=torch.int64, device=dev)
    base = bases.to(torch.int64)

    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    pattern_i = torch.full((b,), w - 1, dtype=torch.int64, device=dev)
    text_i, pc, tc, n_ops = zeros, zeros, zeros, zeros
    cur_error = d_start
    prev_op = torch.full((b,), OP_PAD, dtype=torch.int64, device=dev)
    ops = torch.full((b, max_steps), OP_PAD, dtype=torch.int8, device=dev)
    nodes = torch.full((b, max_steps), -1, dtype=torch.int32, device=dev)
    stuck = torch.zeros(b, dtype=torch.bool, device=dev)

    def succ_rows(ti, de):
        """``[B, H, nw]`` successor rows, all ones past the window end."""
        pos = ti.unsqueeze(1) + 1 + hop_rng
        rows = store[lanes2, pos.clamp(0, w - 1), de.unsqueeze(1)]
        return torch.where((pos < w).unsqueeze(-1), rows, ALL_ONES)

    def bits0(rows, bit):
        return get_bit(rows, bit.unsqueeze(1).expand(b, H)) == 0

    for _ in range(max_steps):
        active = (pc < cap_p) & (tc < cap_t) & (pattern_i >= 0) & (~stuck)
        ti = text_i.clamp(0, w - 1)
        de = cur_error.clamp(0, k)
        dem1 = (cur_error - 1).clamp(0, k)
        pi = pattern_i.clamp(0, w - 1)
        pim1 = (pi - 1).clamp(min=0)
        at0 = pi == 0  # shl1's shifted-in 0: the check bit is always clear

        smask = ((succ[lanes, ti].unsqueeze(1) >> hop_rng) & 1).to(torch.bool)
        rows_d = succ_rows(ti, de)
        rows_dm1 = succ_rows(ti, dem1)
        at0_h = at0.unsqueeze(1)
        m_hops = smask & (at0_h | bits0(rows_d, pim1))
        s_hops = smask & (at0_h | bits0(rows_dm1, pim1))
        d_hops = smask & bits0(rows_dm1, pi)

        pm_bit = get_bit(pm[lanes, base[lanes, ti]], pi) == 0
        mbit = pm_bit & (at0 | m_hops.any(1))
        sbit = at0 | s_hops.any(1)
        ibit = at0 | (get_bit(store[lanes, ti, dem1], pim1) == 0)
        dbit = d_hops.any(1)

        has_err = cur_error > 0
        m_ok = mbit
        s_ok = sbit & has_err
        i_ok = ibit & has_err
        d_ok = dbit & has_err
        if affine:
            cands = torch.stack([i_ok & (prev_op == OP_I),
                                 d_ok & (prev_op == OP_D),
                                 m_ok, s_ok, i_ok, d_ok], dim=1)
            hopsets = torch.stack([no_hops, d_hops, m_hops, s_hops, no_hops,
                                   d_hops], dim=1)
        else:
            cands = torch.stack([m_ok, s_ok, i_ok, d_ok], dim=1)
            hopsets = torch.stack([m_hops, s_hops, no_hops, d_hops], dim=1)

        any_ok = cands.any(1)
        sel = cands.to(torch.int8).argmax(1)
        op = codes[sel]
        stuck = stuck | (active & ~any_ok)
        take = active & any_ok
        consume_p = take & ((op == OP_M) | (op == OP_X) | (op == OP_I))
        consume_t = take & ((op == OP_M) | (op == OP_X) | (op == OP_D))
        err_dec = (take & (op != OP_M)).to(torch.int64)
        # lowest qualifying hop; hop 0 (the chain neighbour) when no
        # successor constraint applies
        h_star = hopsets[lanes, sel].to(torch.int8).argmax(1)
        adv = torch.where(consume_t, 1 + h_star, 0)

        ops[lanes, n_ops] = torch.where(take, op.to(torch.int8),
                                        ops[lanes, n_ops])
        nodes[lanes, n_ops] = torch.where(
            consume_t, ti.to(torch.int32),
            torch.where(take, -1, nodes[lanes, n_ops]))
        pattern_i = pattern_i - consume_p.to(torch.int64)
        text_i = text_i + adv
        cur_error = cur_error - err_dec
        prev_op = torch.where(take, op, prev_op)
        pc = pc + consume_p.to(torch.int64)
        tc = tc + adv
        n_ops = n_ops + take.to(torch.int64)

    return pc, tc, d_start - cur_error, ops, n_ops, nodes, stuck


def _scatter_windows(vals_w: torch.Tensor, n_ops_w: torch.Tensor, cap: int,
                     fill: int) -> torch.Tensor:
    """Concatenate per-window op-aligned ``[B, n_win, max_steps]`` buffers
    into one ``[B, cap]`` buffer per lane."""
    b, _, max_steps = vals_w.shape
    offsets = torch.cumsum(n_ops_w, dim=1) - n_ops_w  # exclusive prefix
    step_idx = torch.arange(max_steps, device=vals_w.device)
    valid = step_idx < n_ops_w.unsqueeze(-1)
    # slot ``cap`` takes the invalid steps and is dropped, as the
    # reference's ``.at[pos].set(mode="drop")`` drops them
    pos = torch.where(valid, offsets.unsqueeze(-1) + step_idx, cap)
    out = torch.full((b, cap + 1), fill, dtype=vals_w.dtype,
                     device=vals_w.device)
    out.scatter_(1, pos.reshape(b, -1), vals_w.reshape(b, -1))
    return out[:, :cap]


def graph_align(gtexts: torch.Tensor, patterns: torch.Tensor,
                p_lens: torch.Tensor, t_lens: torch.Tensor, *,
                cfg: GenASMConfig = GenASMConfig(), p_cap: int | None = None,
                emit_cigar: bool = True,
                dc_fn: Callable | None = None) -> AlignResult:
    """Align ``patterns[b, :p_len]`` to the packed subgraph
    ``gtexts[b, :t_len]``, anchored at node 0, for every lane ``b`` (the
    graph twin of `core/genasm.align`).

    Semi-global: the pattern must be fully consumed, trailing graph is
    free.  ``dc_fn(bases, succ, sub_patterns) -> (d_min, store)`` runs one
    window step's DC over all lanes; the default is the plain
    `window_dc_graph`.  ``AlignResult.nodes`` carries the
    window-relative node offset each op consumed (-1 for insertions) —
    the path GAF reports.
    """
    if p_cap is None:
        p_cap = int(patterns.shape[-1])
    n_win = cfg.n_windows(p_cap)
    max_steps = 2 * cfg.commit
    w, o, k = cfg.w, cfg.o, cfg.k
    dev = gtexts.device
    b = gtexts.shape[0]
    p_lens = p_lens.to(device=dev, dtype=torch.int64)
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    if dc_fn is None:
        def dc_fn(bases, succ, sub_p):
            return window_dc_graph(bases, succ, sub_p, w=w, k=k)

    pats = pad_pattern(patterns, p_lens, p_cap, cfg)
    gbufs = pad_graph_text(gtexts, t_lens, _graph_buf_cap(p_cap, cfg), cfg)

    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    carry = (zeros, zeros, zeros, torch.zeros(b, dtype=torch.bool, device=dev),
             p_lens <= 0)
    ops_w, nodes_w, n_ops_w = [], [], []
    for _ in range(n_win):
        cur_p, cur_t = carry[0], carry[1]
        sub_p = slice_windows(pats, cur_p, w)
        bases, succ = unpack_graph_text(slice_windows(gbufs, cur_t, w))
        d_min, store = dc_fn(bases, succ, sub_p)
        d_min = d_min.to(torch.int64)
        cap_p = torch.clamp(p_lens - cur_p, max=cfg.commit)
        pm = pattern_bitmasks(sub_p, w)
        pc, tc, err, ops, n_ops, nodes, stuck = window_tb_graph(
            store, succ, bases, pm, torch.clamp(d_min, max=k), cap_p,
            w=w, o=o, k=k, affine=cfg.affine)
        carry, n_emit = window_commit(
            carry, d_min=d_min, pc=pc, tc=tc, err=err, n_ops=n_ops,
            stuck=stuck, p_len=p_lens, k=k)
        ops_w.append(ops)
        nodes_w.append(torch.where(nodes >= 0, nodes + cur_t.unsqueeze(1),
                                   -1).to(torch.int32))
        n_ops_w.append(n_emit)

    _, fin_t, dist, failed, done = carry
    failed = failed | (~done)
    n_ops_w = torch.stack(n_ops_w, dim=1)  # [B, n_win]
    if emit_cigar:
        cap = n_win * max_steps
        out_ops = _scatter_windows(torch.stack(ops_w, dim=1), n_ops_w, cap,
                                   OP_PAD)
        out_nodes = _scatter_windows(torch.stack(nodes_w, dim=1), n_ops_w,
                                     cap, -1)
    else:
        out_ops = torch.full((b, 1), OP_PAD, dtype=torch.int8, device=dev)
        out_nodes = None
    return AlignResult(
        distance=torch.where(failed, -1, dist).to(torch.int32),
        ops=out_ops,
        n_ops=n_ops_w.sum(dim=1).to(torch.int32),
        text_consumed=fin_t.to(torch.int32),
        failed=failed,
        nodes=out_nodes,
    )
