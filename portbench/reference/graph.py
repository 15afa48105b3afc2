"""The sequence-to-graph read mapper in plain PyTorch (SeGraM, paper §6).

The benchmark's reference answer for the graph cells, built from the
benchmark's own reference sequence and variants with nothing taken from
the program:

* `build` makes the variation graph (one base a node, in topological
  order, each node's successors as hopBits: bit ``h`` set means node
  ``i + h + 1`` follows ``i``), vectorised over the variants.
* `map_reads` seeds on the backbone, runs the BitAlign filter over the
  tile of every seeded candidate (no q-gram screen: the screen may only
  drop candidates the filter would reject), keeps the least
  ``(distance, origin node, tile)`` and aligns it with windowed BitAlign
  (GenASM's windows with the successors' rows AND-combined).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import genasm, index
from .bits import (ALL_ONES, SENTINEL, WILDCARD, WORD_BITS, first_match_distance,
                   get_bit, n_words, pattern_bitmasks, shl1, to_i32)
from .genasm import AFFINE_CODES, OP_D, OP_I, OP_M, OP_PAD, OP_X
from .linear import POS_SENTINEL

HOP_LIMIT = 16
_HOP_MASK = (1 << HOP_LIMIT) - 1
SENT_NODE = (1 << 8) | SENTINEL  # a sentinel node chained to the next one


class Graph(NamedTuple):
    bases: np.ndarray  # [N] int8
    succ: np.ndarray  # [N] int64 hopBits
    backbone: np.ndarray  # [N] int64 backbone coordinate, -1 on alt nodes
    node_of_backbone: np.ndarray  # [L] int64


def build(ref: np.ndarray, var) -> Graph:
    """The variation graph of ``ref`` and ``var`` (a `generate.Variants`:
    positions at least 6 apart, SNPs of one base, insertions of two bases
    after their position, deletions of two bases).  At position ``p`` the
    backbone node comes first, then the variant's alt nodes."""
    length = len(ref)
    pos, kind = var.pos, var.kind
    if len(pos) and (np.diff(pos).min(initial=99) < 6 or pos.max() + 3 >= length):
        raise ValueError("variants must be 6 apart and end 3 before the reference")
    extra = np.zeros(length, np.int64)
    extra[pos] = np.where(kind == 0, 1, np.where(kind == 1, 2, 0))
    nob = np.arange(length) + np.concatenate([[0], np.cumsum(extra)[:-1]])
    n = length + int(extra.sum())
    bases = np.empty(n, np.int8)
    bases[nob] = ref
    backbone = np.full(n, -1, np.int64)
    backbone[nob] = np.arange(length)
    src = [nob[:-1]]
    dst = [nob[1:]]
    snp, ins, dele = pos[kind == 0], pos[kind == 1], pos[kind == 2]
    a = nob[snp] + 1  # the SNP's alt node: after the predecessor, before the next
    bases[a] = var.alt[kind == 0, 0]
    src += [nob[snp - 1], a]
    dst += [a, nob[snp + 1]]
    a1 = nob[ins] + 1
    bases[a1] = var.alt[kind == 1, 0]
    bases[a1 + 1] = var.alt[kind == 1, 1]
    src += [nob[ins], a1, a1 + 1]
    dst += [a1, a1 + 1, nob[ins + 1]]
    src.append(nob[dele])
    dst.append(nob[dele + 3])
    src, dst = np.concatenate(src), np.concatenate(dst)
    hop = dst - src - 1
    if hop.min() < 0 or hop.max() >= HOP_LIMIT:
        raise ValueError("an edge leaves the hop window")
    succ = np.zeros(n, np.int64)
    np.bitwise_or.at(succ, src, np.int64(1) << hop)
    return Graph(bases=bases, succ=succ, backbone=backbone, node_of_backbone=nob)


def hops_per_node(ref_len: int, counts: dict) -> float:
    """Successor edges per node of `build`'s graph, from the variant counts."""
    edges = ref_len - 1 + 2 * counts["snp"] + 3 * counts["ins"] + counts["del"]
    return edges / (ref_len + counts["snp"] + 2 * counts["ins"])


class DeviceGraph(NamedTuple):
    bases: torch.Tensor
    succ: torch.Tensor
    backbone: torch.Tensor
    node_of_backbone: torch.Tensor


def to_device(g: Graph, device) -> DeviceGraph:
    return DeviceGraph(*(torch.as_tensor(x, device=device) for x in g))


def hop_boundary_mask(length: int, valid: torch.Tensor) -> torch.Tensor:
    """Keep hop ``h`` of position ``i`` iff ``i + h + 1 < valid``."""
    room = (valid.unsqueeze(-1) - 1 - torch.arange(length, device=valid.device)).clamp(0, 32)
    return to_i32(torch.where(room >= 32, 0xFFFFFFFF, (1 << room) - 1))


def tiles(g: DeviceGraph, tile_ids: torch.Tensor, *, tile_len: int, stride: int):
    """Packed tiles ``[R, tile_len]`` (base in bits 0-7, hopBits cut at the
    tile's end in bits 8-23) starting at node ``tile · stride``, and their
    valid node counts."""
    n = g.bases.shape[0]
    start = tile_ids * stride
    idx = start.unsqueeze(1) + torch.arange(tile_len, device=start.device)
    inb = idx < n
    idxc = idx.clamp(0, n - 1)
    b = torch.where(inb, g.bases[idxc].to(torch.int64), SENTINEL)
    valid = (n - start).clamp(0, tile_len)
    s = torch.where(inb, g.succ[idxc], 0) & hop_boundary_mask(tile_len, valid).long()
    return (((s & _HOP_MASK) << 8) | (b & 0xFF)).to(torch.int32), valid


def unpack(gtext):
    return (gtext & 0xFF).to(torch.int8), (gtext >> 8) & _HOP_MASK


def _tail_mask(p_len, m_bits: int):
    nw = n_words(m_bits)
    word = torch.arange(nw, dtype=torch.int64, device=p_len.device)
    below = (m_bits - p_len.to(torch.int64).unsqueeze(-1) - WORD_BITS * word).clamp(0, 32)
    return to_i32(0xFFFFFFFF ^ torch.where(below >= 32, 0xFFFFFFFF, (1 << below) - 1))


def _and_over_hops(x):
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] & x[:, half:]
    return x[:, 0]


def bitalign_rows(bases, succ, patterns, p_lens, *, m_bits: int, k: int,
                  store_r: bool):
    """BitAlign DC over ``[B, N]`` subgraphs, nodes from last to first, the
    successors' rows AND-combined; the pattern tail past ``p_len`` is
    pre-matched.  ``(dists [B, N], R [B, N, k+1, nw] or None)``."""
    b, n = bases.shape
    nw = n_words(m_bits)
    dev = bases.device
    pm = pattern_bitmasks(patterns, m_bits)
    pm = torch.cat([pm, torch.zeros_like(pm[:, :1])], dim=1)
    base = bases.to(torch.int64)
    base = torch.where((base >= 0) & (base <= 4), base, 5)
    tail = _tail_mask(p_lens.to(dev), m_bits)
    tail_rows = tail.unsqueeze(1).expand(b, k + 1, nw)
    ring = tail_rows.unsqueeze(1).repeat(1, HOP_LIMIT, 1, 1)
    lanes = torch.arange(b, device=dev)
    slots = torch.arange(HOP_LIMIT, device=dev)
    top = torch.empty((b, n, k + 1), dtype=torch.int32, device=dev)
    store = (torch.empty((b, n, k + 1, nw), dtype=torch.int32, device=dev)
             if store_r else None)
    for i in range(n - 1, -1, -1):
        use = ((succ[:, i:i + 1] >> ((slots - i - 1) % HOP_LIMIT)) & 1).to(torch.bool)
        comb = _and_over_hops(torch.where(use[:, :, None, None], ring, ALL_ONES)) \
            & tail_rows
        cur_pm = pm[lanes, base[:, i]]
        rows = [(shl1(comb[:, 0]) | cur_pm) & tail]
        D = comb[:, :-1]
        DSM = D & shl1(D) & (shl1(comb[:, 1:]) | cur_pm.unsqueeze(1)) & tail.unsqueeze(1)
        for d in range(k):
            rows.append(DSM[:, d] & shl1(rows[-1]))
        R = torch.stack(rows, dim=1)
        ring[:, i % HOP_LIMIT] = R
        top[:, i] = R[..., -1]
        if store is not None:
            store[:, i] = R
    return first_match_distance((top >> 31) & 1, k), store


def window_tb_graph(store, succ, bases, pm, d_start, cap_p, *, w: int, o: int,
                    k: int):
    """Graph traceback over each lane's window store: an op that consumes a
    node needs a successor whose row continues the chain of 0s, and the
    lowest such hop is the one taken.  ``(pc, tc, err, ops, n_ops, nodes,
    stuck)``, ``nodes`` the window node of each op (-1 for I)."""
    dev = store.device
    b = store.shape[0]
    H = HOP_LIMIT
    max_steps, cap_t = 2 * (w - o), w - o
    cap_p = cap_p.to(torch.int64)
    d_start = d_start.to(torch.int64)
    lanes = torch.arange(b, device=dev)
    lanes2 = lanes.unsqueeze(1)
    hop_rng = torch.arange(H, device=dev)
    no_hops = torch.zeros((b, H), dtype=torch.bool, device=dev)
    codes = torch.tensor(AFFINE_CODES, dtype=torch.int64, device=dev)
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
        p = ti.unsqueeze(1) + 1 + hop_rng
        rows = store[lanes2, p.clamp(0, w - 1), de.unsqueeze(1)]
        return torch.where((p < w).unsqueeze(-1), rows, ALL_ONES)

    def bits0(rows, bit):
        return get_bit(rows, bit.unsqueeze(1).expand(b, H)) == 0

    for _ in range(max_steps):
        active = (pc < cap_p) & (tc < cap_t) & (pattern_i >= 0) & (~stuck)
        ti = text_i.clamp(0, w - 1)
        de = cur_error.clamp(0, k)
        dem1 = (cur_error - 1).clamp(0, k)
        pi = pattern_i.clamp(0, w - 1)
        pim1 = (pi - 1).clamp(min=0)
        at0 = pi == 0
        smask = ((succ[lanes, ti].unsqueeze(1) >> hop_rng) & 1).to(torch.bool)
        rows_dm1 = succ_rows(ti, dem1)
        at0_h = at0.unsqueeze(1)
        m_hops = smask & (at0_h | bits0(succ_rows(ti, de), pim1))
        s_hops = smask & (at0_h | bits0(rows_dm1, pim1))
        d_hops = smask & bits0(rows_dm1, pi)
        has_err = cur_error > 0
        m_ok = (get_bit(pm[lanes, base[lanes, ti]], pi) == 0) & (at0 | m_hops.any(1))
        s_ok = (at0 | s_hops.any(1)) & has_err
        i_ok = (at0 | (get_bit(store[lanes, ti, dem1], pim1) == 0)) & has_err
        d_ok = d_hops.any(1) & has_err
        cands = torch.stack([i_ok & (prev_op == OP_I), d_ok & (prev_op == OP_D),
                             m_ok, s_ok, i_ok, d_ok], dim=1)
        hopsets = torch.stack([no_hops, d_hops, m_hops, s_hops, no_hops, d_hops], dim=1)
        any_ok = cands.any(1)
        sel = cands.to(torch.int8).argmax(1)
        op = codes[sel]
        stuck = stuck | (active & ~any_ok)
        take = active & any_ok
        consume_p = take & ((op == OP_M) | (op == OP_X) | (op == OP_I))
        consume_t = take & ((op == OP_M) | (op == OP_X) | (op == OP_D))
        adv = torch.where(consume_t, 1 + hopsets[lanes, sel].to(torch.int8).argmax(1), 0)
        ops[lanes, n_ops] = torch.where(take, op.to(torch.int8), ops[lanes, n_ops])
        nodes[lanes, n_ops] = torch.where(consume_t, ti.to(torch.int32),
                                          torch.where(take, -1, nodes[lanes, n_ops]))
        pattern_i = pattern_i - consume_p.long()
        text_i = text_i + adv
        cur_error = cur_error - (take & (op != OP_M)).long()
        prev_op = torch.where(take, op, prev_op)
        pc, tc = pc + consume_p.long(), tc + adv
        n_ops = n_ops + take.long()
    return pc, tc, d_start - cur_error, ops, n_ops, nodes, stuck


def graph_align(gtexts, patterns, p_lens, t_lens, *, geo: genasm.Geometry,
                p_cap: int):
    """Windowed BitAlign of ``patterns[b, :p_len]`` against packed graph
    text ``gtexts[b, :t_len]``, anchored at node 0.  ``(distance, ops,
    n_ops, failed, nodes)``, ``nodes`` the window-relative node of each
    op (-1 for I)."""
    w, o, k = geo.w, geo.o, geo.k
    n_win = geo.n_windows(p_cap)
    dev = gtexts.device
    b = gtexts.shape[0]
    p_lens = p_lens.to(dev, torch.int64)
    t_lens = t_lens.to(dev, torch.int64)
    pats = genasm.pad_to(patterns, p_lens, p_cap + w, WILDCARD)
    buf = p_cap + n_win * (geo.commit + HOP_LIMIT) + w
    gb = torch.full((b, buf), SENT_NODE, dtype=torch.int32, device=dev)
    m = min(gtexts.shape[1], buf)
    gb[:, :m] = gtexts[:, :m]
    gb = torch.where(torch.arange(buf, device=dev) < t_lens.unsqueeze(1), gb, SENT_NODE)
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    carry = (zeros, zeros, zeros, torch.zeros(b, dtype=torch.bool, device=dev),
             p_lens <= 0)
    full_w = torch.full((b,), w, dtype=torch.int64, device=dev)
    ops_w, nodes_w, n_ops_w = [], [], []
    for _ in range(n_win):
        cur_p, cur_t = carry[0], carry[1]
        sub_p = genasm.slice_windows(pats, cur_p, w)
        bases, succ = unpack(genasm.slice_windows(gb, cur_t, w))
        dists, store = bitalign_rows(bases, succ, sub_p, full_w, m_bits=w, k=k,
                                     store_r=True)
        d_min = dists[:, 0].to(torch.int64)
        cap_p = torch.clamp(p_lens - cur_p, max=geo.commit)
        pc, tc, err, ops, n_ops, nodes, stuck = window_tb_graph(
            store, succ, bases, pattern_bitmasks(sub_p, w), d_min.clamp(max=k),
            cap_p, w=w, o=o, k=k)
        carry, n_emit = genasm.window_commit(carry, d_min=d_min, pc=pc, tc=tc,
                                             err=err, n_ops=n_ops, stuck=stuck,
                                             p_len=p_lens, k=k)
        ops_w.append(ops)
        nodes_w.append(torch.where(nodes >= 0, nodes + cur_t.unsqueeze(1), -1)
                       .to(torch.int32))
        n_ops_w.append(n_emit)
    _, _, dist, failed, done = carry
    failed = failed | (~done)
    n_ops_w = torch.stack(n_ops_w, dim=1)
    cap = n_win * 2 * geo.commit
    return (torch.where(failed, -1, dist).to(torch.int32),
            genasm.scatter_windows(torch.stack(ops_w, 1), n_ops_w, cap, OP_PAD),
            n_ops_w.sum(1).to(torch.int32), failed,
            genasm.scatter_windows(torch.stack(nodes_w, 1), n_ops_w, cap, -1))


def _wrap32(x):
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def map_reads(g: DeviceGraph, idx: index.Index, reads, lens, *, p: dict,
              filter_bits: int | None = None) -> dict:
    """Map ``reads [B, cap]`` (``lens [B]``) against the graph.

    ``p`` holds the deployment's settings (those of `linear.map_reads`,
    and ``tile_stride``, ``tile_margin``); ``filter_bits`` overrides the
    filter's width (the control).  Returns position (the backbone
    coordinate of the first aligned backbone node) and distance (-1 where
    unmapped), ``ops``, ``n_ops`` and ``path`` (global node ids).
    """
    fb = min(p["filter_bits"] if filter_bits is None else filter_bits, p["p_cap"])
    fk, p_cap, stride = p["filter_k"], p["p_cap"], p["tile_stride"]
    geo = genasm.Geometry(p["w"], p["o"], p["k"])
    t_cap = p_cap + 2 * geo.w
    tile_len = stride + p["tile_margin"] + t_cap
    n_nodes = g.bases.shape[0]
    n_tiles = max(1, -(-n_nodes // stride))
    bb_len = g.node_of_backbone.shape[0]
    dev = reads.device
    b = reads.shape[0]
    lens = lens.to(torch.int64)
    starts, votes = index.seed_candidates(
        reads, idx, w=p["minimizer_w"], k=p["minimizer_k"],
        max_candidates=p["max_candidates"])
    c = starts.shape[1]
    sb = (starts - HOP_LIMIT).clamp(0, bb_len - 1)
    tile_g = (g.node_of_backbone[sb] // stride).clamp(0, n_tiles - 1)
    flens = lens.clamp(max=fb)
    fpat = torch.where(torch.arange(fb, device=dev) < flens.unsqueeze(1),
                       reads[:, :fb], WILDCARD).to(torch.int8)
    wins, _ = tiles(g, tile_g.reshape(b * c), tile_len=tile_len, stride=stride)
    fbases, fsucc = unpack(wins)
    dists = bitalign_rows(fbases, fsucc, fpat.repeat_interleave(c, 0),
                          flens.repeat_interleave(c), m_bits=fb, k=fk,
                          store_r=False)[0]
    dists = torch.where(torch.arange(tile_len, device=dev) < tile_len - t_cap,
                        dists, fk + 1)
    live = votes > 0
    d_c = torch.where(live, dists.min(-1).values.reshape(b, c), fk + 1)
    off_c = torch.where(live, dists.argmin(-1).reshape(b, c), 0)
    origin_c = torch.where(live, tile_g * stride + off_c, POS_SENTINEL)
    tile_m = torch.where(live, tile_g, POS_SENTINEL)
    dm = d_c.min(-1, keepdim=True).values
    om = torch.where(d_c == dm, origin_c, POS_SENTINEL)
    tm = torch.where(om == om.min(-1, keepdim=True).values, tile_m, POS_SENTINEL)
    ci = tm.argmin(-1)
    rows = torch.arange(b, device=dev)
    d_best, origin, off = d_c[rows, ci], origin_c[rows, ci], off_c[rows, ci]
    win_tiles, valid = tiles(g, tile_g[rows, ci], tile_len=tile_len, stride=stride)
    gwin = genasm.slice_windows(win_tiles, off, t_cap)
    t_len = (valid - off).clamp(0, t_cap)
    widx = _wrap32(origin.unsqueeze(1) + torch.arange(t_cap, device=dev))
    bwin = g.backbone[widx.clamp(0, n_nodes - 1)]

    r = reads[:, :p_cap]
    if r.shape[1] < p_cap:
        r = torch.nn.functional.pad(r, (0, p_cap - r.shape[1]), value=WILDCARD)
    pat = torch.where(torch.arange(p_cap, device=dev) < lens.unsqueeze(1), r,
                      WILDCARD).to(torch.int8)
    dist, ops, n_ops, a_failed, nodes = graph_align(gwin, pat, lens, t_len,
                                                    geo=geo, p_cap=p_cap)
    on = nodes >= 0
    path = torch.where(on, nodes + origin.unsqueeze(1), -1)
    bpath = torch.where(on, torch.gather(bwin, 1, nodes.clamp(0, t_cap - 1).long()), -1)
    pos = bpath[rows, (bpath >= 0).to(torch.int8).argmax(-1)]
    failed = a_failed | (d_best > fk)
    return {"position": torch.where(failed, -1, pos).to(torch.int32),
            "distance": torch.where(failed, -1, dist).to(torch.int32),
            "ops": torch.where(failed.unsqueeze(1), OP_PAD, ops),
            "n_ops": torch.where(failed, 0, n_ops).to(torch.int32),
            "path": torch.where(failed.unsqueeze(1), -1, path)}
