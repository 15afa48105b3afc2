"""Genome graphs for SeGraM (paper §2.5, §6.5).

Port of `repro.core.segram.graph`.  A graph is a topologically-ordered
DAG with one base per node.  Successor edges within a bounded hop
window are encoded as per-node **hopBits** (paper Figure 6-9): bit ``h``
of ``succ_bits[i]`` set ⇔ node ``i + h + 1`` is a successor of ``i``.
The linearization keeps variant branches adjacent to their backbone
position so real variation graphs have small hop distances; an edge
beyond ``HOP_LIMIT`` raises so the caller can re-chunk.

Construction is host numpy with the reference's algorithm, so the
arrays come out identical; `hop_boundary_mask` is the one boundary rule
for subgraph windows and runs on any torch device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bitvector import to_i32

HOP_LIMIT = 16


class Variant(NamedTuple):
    """pos: 0-based backbone position; kind: 'snp' | 'ins' | 'del'.

    snp: ``alt`` (len ≥ 1) replaces the ref base at pos (len > 1 spells a
    branch of chained nodes, e.g. an MNP allele).
    ins: ``alt`` inserted *after* backbone position pos.
    del: ``span`` backbone bases deleted starting at pos.
    """

    pos: int
    kind: str
    alt: tuple = ()
    span: int = 1


@dataclass
class GenomeGraph:
    bases: np.ndarray  # [N] int8, topological order
    succ_bits: np.ndarray  # [N] uint32 hopBits (successors)
    backbone: np.ndarray  # [N] int32 backbone coordinate of each node (-1 for alt)
    node_of_backbone: np.ndarray  # [L] int32 node id of each backbone position

    @property
    def n_nodes(self) -> int:
        return int(self.bases.shape[0])


def build_graph(ref: np.ndarray, variants: list[Variant] = ()) -> GenomeGraph:
    """Build a variation graph from a linear reference + variant list.

    Raises ``ValueError`` for malformed variants: an empty ``snp`` alt, a
    deletion whose landing position ``pos + span + 1`` falls past the
    reference end, or any edge whose hop distance exceeds ``HOP_LIMIT``.
    """
    L = len(ref)
    bases: list[int] = []
    backbone: list[int] = []
    src: list[int] = []  # edge sources
    dst: list[int] = []  # edge targets
    node_of_backbone = np.full(L, -1, np.int64)

    by_pos: dict[int, list[Variant]] = {}
    for v in variants:
        by_pos.setdefault(v.pos, []).append(v)

    prev_tails: list[int] = []  # node ids whose successor is the next backbone node
    pending_del: dict[int, list[int]] = {}  # backbone pos -> node ids jumping here
    for p in range(L):
        nid = len(bases)
        bases.append(int(ref[p]))
        backbone.append(p)
        node_of_backbone[p] = nid
        preds = prev_tails + pending_del.pop(p, [])
        for t in preds:
            src.append(t)
            dst.append(nid)
        prev_tails = [nid]
        for v in by_pos.get(p, []):
            if v.kind == "snp":
                if not v.alt:
                    raise ValueError(f"snp at {p} needs a non-empty alt")
                # the first alt node shares nid's predecessor list, further
                # alt bases chain behind it
                prev = -1
                for j, ab in enumerate(v.alt):
                    alt_id = len(bases)
                    bases.append(int(ab))
                    backbone.append(-1)
                    for a in (preds if j == 0 else [prev]):
                        src.append(a)
                        dst.append(alt_id)
                    prev = alt_id
                prev_tails.append(prev)
            elif v.kind == "ins":
                prev = nid
                for ab in v.alt:
                    alt_id = len(bases)
                    bases.append(int(ab))
                    backbone.append(-1)
                    src.append(prev)
                    dst.append(alt_id)
                    prev = alt_id
                prev_tails.append(prev)
            elif v.kind == "del":
                tgt = p + v.span + 1
                if tgt >= L:
                    raise ValueError(
                        f"del at {p} (span {v.span}) lands at backbone "
                        f"{tgt}, past the reference end {L}; trim the "
                        f"variant or extend the reference")
                pending_del.setdefault(tgt, []).append(nid)
            else:
                raise ValueError(v.kind)

    n = len(bases)
    succ = np.zeros(n, np.uint32)
    if src:
        a = np.asarray(src, np.int64)
        b = np.asarray(dst, np.int64)
        hop = b - a - 1
        if hop.min() < 0:
            raise ValueError("graph not topologically ordered")
        if hop.max() >= HOP_LIMIT:
            w = int(hop.argmax())
            raise ValueError(
                f"edge {int(a[w])}->{int(b[w])} hop {int(hop[w]) + 1} "
                f"exceeds HOP_LIMIT={HOP_LIMIT}; re-chunk the graph")
        np.bitwise_or.at(succ, a, np.uint32(1) << hop.astype(np.uint32))
    return GenomeGraph(
        bases=np.array(bases, np.int8),
        succ_bits=succ,
        backbone=np.array(backbone, np.int32),
        node_of_backbone=node_of_backbone.astype(np.int32),
    )


def linear_graph(ref: np.ndarray) -> GenomeGraph:
    """Degenerate graph (pure backbone) — BitAlign on it must equal linear Bitap."""
    return build_graph(ref, [])


def hop_boundary_mask(length: int, valid_len, device=None) -> torch.Tensor:
    """The one boundary-masking rule for subgraph windows.

    Returns ``[..., length] int32`` bit patterns, one row per entry of
    ``valid_len`` (a scalar or a tensor of window ends): entry ``i`` keeps
    hop bit ``h`` iff the target node ``i + h + 1`` stays below
    ``valid_len``.  Every window extractor — `extract_subgraph` and the
    tile builder of `repro_torch.graph.index` — applies this mask, so
    out-of-window hops cannot disagree between paths.
    """
    valid = torch.as_tensor(valid_len, dtype=torch.int64, device=device)
    pos = torch.arange(length, dtype=torch.int64, device=valid.device)
    room = (valid.unsqueeze(-1) - 1 - pos).clamp(0, 32)
    return to_i32(torch.where(room >= 32, 0xFFFFFFFF, (1 << room) - 1))


def extract_subgraph(g: GenomeGraph, start_node: int, length: int):
    """Fixed-size window of the linearized graph for one candidate region.

    Returns (bases [length] int8 sentinel-padded, succ_bits [length] uint32
    masked at the boundary), numpy arrays as in the reference.
    """
    n = g.n_nodes
    s = max(0, min(start_node, n))
    e = min(n, s + length)
    bases = np.full(length, 4, np.int8)
    succ = np.zeros(length, np.uint32)
    bases[: e - s] = g.bases[s:e]
    succ[: e - s] = g.succ_bits[s:e]
    succ &= hop_boundary_mask(length, e - s).numpy().view(np.uint32)
    return bases, succ


def predecessors(g: GenomeGraph) -> list[list[int]]:
    """Adjacency (predecessor lists) for a host DP oracle."""
    preds: list[list[int]] = [[] for _ in range(g.n_nodes)]
    for i in range(g.n_nodes):
        bits = int(g.succ_bits[i])
        h = 0
        while bits:
            if bits & 1:
                preds[i + h + 1].append(i)
            bits >>= 1
            h += 1
    return preds
