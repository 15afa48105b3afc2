"""BitAlign: bitvector-based sequence-to-graph alignment (paper §6.7, §6.8.2).

Port of `repro.core.segram.bitalign`, batched over ``[B]`` subgraphs.
Two DC scans live here:

  * `bitalign_rows`, the R rows only with the tail mask applied to every
    row, which the graph window loop and the mapper's filter run
    (`graph/windowed.py`) and which is the plain version of the CUDA
    kernel `repro_torch.kernels.bitalign`;
  * `bitalign_dc`, the reference's whole-subgraph scan with the full
    (R, M, I, D) store that `bitalign_tb` reads, which only
    `core/segram/segram.py` runs (as in the reference, where `segram.py`
    calls no Pallas kernel).

Scanning the linearized subgraph in *reverse topological order*, the
"previous text character" bitvectors are the AND-combination of all
successors' status bitvectors within the hop window (0 = match, so AND
is the union of matching paths — the paper's hopBits combine, Figure
6-9).  Traceback re-derives the chosen successor at each step from the
stored per-node status bitvectors: an op that consumes a graph node is
valid only if some successor's R continues the 0-chain, and the
successor taken is recorded as the path.
"""
from __future__ import annotations

import torch

from ..bitvector import (ALL_ONES, WORD_BITS, n_words, pattern_bitmasks, shl1,
                         to_i32)
# a name the reference module binds too
from ..bitvector import get_bit, msb, ones  # noqa: F401
from ..genasm_dc import first_match_distance
from ..genasm_tb import OP_D, OP_I, OP_M, OP_PAD, OP_X
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


def bitalign_dc(bases: torch.Tensor, succ_bits: torch.Tensor,
                patterns: torch.Tensor, p_lens: torch.Tensor, *, m_bits: int,
                k: int):
    """DC over ``[B, N]`` linearized subgraphs with the full store.

    ``bases``: int8 (4 = sentinel pad); ``succ_bits``: int32 hopBits;
    ``patterns``: ``[B, m_bits]`` int8 wildcard-padded; ``p_lens [B]``
    their real lengths.  Unlike `bitalign_rows`, the tail mask only
    stands in for missing successors (and initialises the ring), as in
    the reference's ``bitalign_dc``: rows are not masked.

    Returns ``(dists [B, N] int32, store [B, N, k+1, 4, nw] int32)``
    where ``dists[b, i]`` is the least ``d <= k`` aligning the full
    pattern to a path starting at node ``i`` (``k+1`` if none) and
    ``store`` holds (R, M, I, D) per row.
    """
    b, n = bases.shape
    nw = n_words(m_bits)
    dev = bases.device
    H = HOP_LIMIT
    pm = pattern_bitmasks(patterns, m_bits)  # [B, 5, nw]
    base = bases.to(torch.int64)
    tail = _tail_mask(p_lens.to(dev), m_bits)  # [B, nw]
    tail_rows = tail.unsqueeze(1).expand(b, k + 1, nw)
    # ring slot j holds the rows of the last scanned node i with i % H == j
    ring = tail_rows.unsqueeze(1).repeat(1, H, 1, 1)  # [B, H, k+1, nw]
    lanes = torch.arange(b, device=dev)
    slots = torch.arange(H, device=dev)
    ones_row = torch.full((b, 1, nw), ALL_ONES, dtype=torch.int32, device=dev)
    top = torch.empty((b, n, k + 1), dtype=torch.int32, device=dev)
    store = torch.empty((b, n, k + 1, 4, nw), dtype=torch.int32, device=dev)
    for i in range(n - 1, -1, -1):
        hop_of_slot = (slots - i - 1) % H
        use = ((succ_bits[:, i:i + 1] >> hop_of_slot) & 1).to(torch.bool)
        comb = _and_over_hops(torch.where(use[:, :, None, None], ring,
                                          tail_rows.unsqueeze(1)))
        cur_pm = pm[lanes, base[:, i]]  # [B, nw]
        rows = [shl1(comb[:, 0]) | cur_pm]
        D = comb[:, :-1]  # [B, k, nw]
        M = shl1(comb[:, 1:]) | cur_pm.unsqueeze(1)
        DSM = D & shl1(D) & M
        ins = []
        for d in range(k):  # I = shl1(R[d-1]) is the only serial term
            ins.append(shl1(rows[-1]))
            rows.append(DSM[:, d] & ins[-1])
        R = torch.stack(rows, dim=1)  # [B, k+1, nw]
        store[:, i, :, 0] = R
        store[:, i, :, 1] = torch.cat([R[:, :1], M], dim=1)
        store[:, i, :, 2] = torch.cat([ones_row] + [x.unsqueeze(1) for x in ins],
                                      dim=1)
        store[:, i, :, 3] = torch.cat([ones_row, D], dim=1)
        ring[:, i % H] = R
        top[:, i] = R[..., -1]
    return first_match_distance((top >> 31) & 1, k), store


def _bits_at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` (``[B]``, in range) of ``[B, ..., nw]`` bitvectors -> 0/1
    of shape ``[B, ...]``."""
    lead = x.shape[:-1]
    shape = (pos.shape[0],) + (1,) * (len(lead) - 1)
    word = (pos // WORD_BITS).reshape(shape).expand(lead).unsqueeze(-1)
    w = torch.gather(x, -1, word).squeeze(-1)
    return (w >> (pos % WORD_BITS).reshape(shape)) & 1


def bitalign_tb(store: torch.Tensor, succ_bits: torch.Tensor,
                start_node: torch.Tensor, d_start: torch.Tensor,
                p_lens: torch.Tensor, *, m_bits: int, k: int,
                max_steps: int | None = None):
    """Graph traceback from ``start_node`` with ``d_start`` errors, per lane.

    ``store``: ``[B, N, k+1, 4, nw]`` from :func:`bitalign_dc`;
    ``succ_bits [B, N]``; ``start_node``, ``d_start``, ``p_lens`` ``[B]``.
    Returns ``(ops [B, steps] int8, n_ops [B] int32, nodes [B, steps]
    int32, stuck [B] bool)`` where ``nodes[b, s]`` is the graph node
    consumed at step ``s`` (-1 for I ops).  The ``steps`` loop runs in
    Python over ``[B]``-lane state, inactive lanes masked as the
    reference's ``fori_loop`` masks them.
    """
    H = HOP_LIMIT
    b, n = store.shape[:2]
    dev = store.device
    if max_steps is None:
        max_steps = m_bits + k
    lanes = torch.arange(b, device=dev)
    hop_rng = torch.arange(H, device=dev)
    codes = torch.tensor([OP_M, OP_X, OP_I, OP_D], device=dev)
    p_len = p_lens.to(device=dev, dtype=torch.int64)

    def succ_ok(node, d_next, bit_next, succ_mask):
        nxt = node.unsqueeze(-1) + 1 + hop_rng  # [B, H]
        pos = nxt.clamp(0, n - 1)
        rn = store[lanes.unsqueeze(-1), pos,
                   d_next.clamp(0, k).unsqueeze(-1), 0]  # [B, H, nw]
        bits = _bits_at(rn, bit_next.clamp(0, m_bits - 1))
        ok = (d_next >= 0) & (bit_next >= 0)
        return succ_mask & (bits == 0) & (nxt < n) & ok.unsqueeze(-1)

    node = start_node.to(device=dev, dtype=torch.int64).clone()
    bit = torch.full((b,), m_bits - 1, dtype=torch.int64, device=dev)
    d = d_start.to(device=dev, dtype=torch.int64).clone()
    pc = torch.zeros((b,), dtype=torch.int64, device=dev)
    n_ops = torch.zeros((b,), dtype=torch.int64, device=dev)
    ops = torch.full((b, max_steps), OP_PAD, dtype=torch.int8, device=dev)
    nodes = torch.full((b, max_steps), -1, dtype=torch.int32, device=dev)
    stuck = torch.zeros((b,), dtype=torch.bool, device=dev)
    done = p_len <= 0
    for _ in range(max_steps):
        active = ~done & ~stuck
        ni = node.clamp(0, n - 1)
        vec = store[lanes, ni, d.clamp(0, k)]  # [B, 4, nw]
        pi = bit.clamp(0, m_bits - 1)
        mbit = _bits_at(vec[:, 1], pi) == 0
        ibit = _bits_at(vec[:, 2], pi) == 0
        dbit = _bits_at(vec[:, 3], pi) == 0
        sbit = (pi == 0) | (_bits_at(vec[:, 3], (pi - 1).clamp(min=0)) == 0)
        has_err = d > 0
        succ_mask = ((succ_bits[lanes, ni].unsqueeze(-1) >> hop_rng) & 1) \
            .to(torch.bool)
        last_p = pc >= p_len - 1  # this op consumes the final pattern char
        ok_m_h = succ_ok(node, d, bit - 1, succ_mask)
        ok_s_h = succ_ok(node, d - 1, bit - 1, succ_mask)
        ok_d_h = succ_ok(node, d - 1, bit, succ_mask)
        cands = torch.stack([
            mbit & (last_p | ok_m_h.any(-1)),
            sbit & has_err & (last_p | ok_s_h.any(-1)),
            ibit & has_err,
            dbit & has_err & ok_d_h.any(-1)], dim=-1)
        any_ok = cands.any(-1)
        sel = cands.to(torch.int8).argmax(-1)
        op = codes[sel]
        take = active & any_ok
        stuck = stuck | (active & ~any_ok)

        hops = torch.stack([ok_m_h, ok_s_h, ok_d_h, ok_d_h], dim=1)[lanes, sel]
        h_star = hops.to(torch.int8).argmax(-1)
        consume_node = take & ((op == OP_M) | (op == OP_X) | (op == OP_D))
        consume_pat = take & ((op == OP_M) | (op == OP_X) | (op == OP_I))
        err_dec = take & (op != OP_M)

        ends_walk = consume_pat & last_p
        slot = (lanes, n_ops)
        ops[slot] = torch.where(take, op.to(torch.int8), ops[slot])
        nodes[slot] = torch.where(take & consume_node, node.to(torch.int32),
                                  torch.where(take, -1, nodes[slot]))
        node = torch.where(consume_node & ~ends_walk, node + 1 + h_star, node)
        bit = bit - consume_pat.to(torch.int64)
        d = d - err_dec.to(torch.int64)
        pc = pc + consume_pat.to(torch.int64)
        n_ops = n_ops + take.to(torch.int64)
        done = done | (take & (pc >= p_len))
    return ops, n_ops.to(torch.int32), nodes, stuck | ~done


def bitalign(bases: torch.Tensor, succ_bits: torch.Tensor,
             patterns: torch.Tensor, p_lens: torch.Tensor, *, m_bits: int,
             k: int, traceback: bool = True) -> dict:
    """Distance (+ optional CIGAR/path) of each pattern vs its subgraph,
    free start node.

    Returns a dict of ``[B]``-leading tensors: distance, start_node,
    failed, and with ``traceback`` ops, n_ops, nodes.
    """
    dists, store = bitalign_dc(bases, succ_bits, patterns, p_lens,
                               m_bits=m_bits, k=k)
    best = dists.argmin(-1)  # the first minimum, as jnp.argmin
    d = dists.gather(-1, best.unsqueeze(-1)).squeeze(-1)
    out = {"distance": torch.where(d > k, -1, d).to(torch.int32),
           "start_node": best.to(torch.int32), "failed": d > k}
    if traceback:
        ops, n_ops, nodes, stuck = bitalign_tb(
            store, succ_bits, best, d.clamp(max=k), p_lens, m_bits=m_bits, k=k)
        out.update(ops=ops, n_ops=n_ops, nodes=nodes,
                   failed=out["failed"] | stuck)
    return out
