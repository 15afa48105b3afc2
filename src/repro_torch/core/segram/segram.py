"""SeGraM: end-to-end sequence-to-graph mapping (paper Figure 6-1).

Port of `repro.core.segram.segram`, batched over reads.  Pipeline per
read: MinSeed (minimizer lookup → candidate subgraph regions, Figure
6-5) → BitAlign DC over each candidate subgraph → pick the best →
BitAlign TB for the CIGAR + path.  The reads × candidates of a batch
run as one ``[B·C]``-lane BitAlign DC (`bitalign.bitalign_dc`, the full
(R, M, I, D) store) and the chosen candidates as one ``[B]``-lane
traceback.  As in the reference, no kernel runs here: the served graph
workload (`repro_torch.graph`) is the path of the BitAlign kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device

from .bitalign import bitalign_dc, bitalign_tb
from .graph import HOP_LIMIT, GenomeGraph, hop_boundary_mask
from .minimizer import MinimizerIndex, build_index, seed_candidates  # noqa: F401


class SeGraMIndex(NamedTuple):
    bases: torch.Tensor  # [N] int8 linearized graph
    succ_bits: torch.Tensor  # [N] int32 hopBits (uint32 bit patterns)
    node_of_backbone: torch.Tensor  # [L] int64
    idx_hashes: torch.Tensor  # [M] int64 sorted minimizer hashes (backbone)
    idx_positions: torch.Tensor  # [M] int64 backbone positions

    @property
    def device(self) -> torch.device:
        return self.bases.device


def index_from_arrays(bases, succ_bits, node_of_backbone, idx_hashes,
                      idx_positions, *,
                      device: torch.device | str = "cuda") -> SeGraMIndex:
    """A `SeGraMIndex` on ``device`` from host arrays — the fields of the
    reference's ``SeGraMIndex`` as ``np.asarray`` gives them (uint32
    hopBits and hashes, int32 node ids and positions)."""
    device = resolve_device(device)
    u32 = np.asarray(succ_bits).astype(np.uint32)
    return SeGraMIndex(
        bases=torch.as_tensor(np.array(bases, np.int8), device=device),
        succ_bits=torch.as_tensor(u32.view(np.int32), device=device),
        node_of_backbone=torch.as_tensor(
            np.asarray(node_of_backbone).astype(np.int64), device=device),
        idx_hashes=torch.as_tensor(
            np.asarray(idx_hashes, np.uint32).astype(np.int64), device=device),
        idx_positions=torch.as_tensor(
            np.asarray(idx_positions).astype(np.int64), device=device),
    )


def preprocess(ref: np.ndarray, g: GenomeGraph, *, w: int = 10, k: int = 15,
               device: torch.device | str = "cuda") -> SeGraMIndex:
    """Offline pre-processing (paper §6.5): graph arrays + minimizer index
    on ``device`` (a CUDA device must exist when one is asked for)."""
    device = resolve_device(device)
    idx = build_index(ref, w=w, k=k, device=device)
    return index_from_arrays(g.bases, g.succ_bits, g.node_of_backbone,
                             idx.hashes, idx.positions, device=device)


def _window(index: SeGraMIndex, start_nodes: torch.Tensor, length: int):
    """``[L]`` start nodes → subgraph windows with boundary-masked hopBits.

    Reproduces the reference's ``lax.dynamic_slice``, which clamps each
    start so the window fits: ``s = clip(start, 0, max(N - length, 0))``.
    Returns ``(bases [L, length], succ [L, length], s [L])``.
    """
    n = index.bases.shape[0]
    s = start_nodes.clamp(0, max(n - length, 0))
    pos = s.unsqueeze(-1) + torch.arange(length, device=s.device)
    mask = hop_boundary_mask(length, length, device=s.device)
    return index.bases[pos], index.succ_bits[pos] & mask, s


def map_batch(index: SeGraMIndex, reads: torch.Tensor, read_lens: torch.Tensor,
              *, m_bits: int = 128, k: int = 16, win_len: int = 192,
              max_candidates: int = 4, minimizer_w: int = 10,
              minimizer_k: int = 15) -> dict:
    """Map ``[B, L]`` int8 reads (``L >= m_bits``, sentinel-padded past
    ``read_lens``) to the graph.  Returns a dict of ``[B]``-leading
    results: distance (-1 when failed), node, ops, n_ops, path, failed.
    """
    dev = index.device
    reads = reads.to(dev)
    read_lens = read_lens.to(device=dev, dtype=torch.int64)
    b = reads.shape[0]
    starts, votes = seed_candidates(
        reads, index.idx_hashes, index.idx_positions, w=minimizer_w,
        k=minimizer_k, max_candidates=max_candidates)  # [B, C]
    n_cand = starts.shape[-1]
    # backbone coordinate -> node id, with margin for leading variation
    L = index.node_of_backbone.shape[0]
    start_nodes = index.node_of_backbone[(starts - HOP_LIMIT).clamp(0, L - 1)]

    cols = torch.arange(m_bits, device=dev)
    pat = torch.where(cols < read_lens.unsqueeze(-1), reads[:, :m_bits],
                      4).to(torch.int8)
    bases, succ, s0 = _window(index, start_nodes.flatten(), win_len)
    dists, store = bitalign_dc(
        bases, succ, pat.repeat_interleave(n_cand, dim=0),
        read_lens.repeat_interleave(n_cand), m_bits=m_bits, k=k)
    best = dists.argmin(-1)  # first minimum, as jnp.argmin
    d_all = dists.gather(-1, best.unsqueeze(-1)).squeeze(-1).view(b, n_cand)
    d_all = torch.where(votes > 0, d_all, k + 1)
    ci = d_all.argmin(-1)
    lanes = torch.arange(b, device=dev)
    pick = lanes * n_cand + ci
    d = d_all[lanes, ci]
    ops, n_ops, nodes, stuck = bitalign_tb(
        store[pick], succ[pick], best[pick], d.clamp(max=k), read_lens,
        m_bits=m_bits, k=k)
    failed = (d > k) | stuck
    origin = s0[pick]
    return {
        "distance": torch.where(failed, -1, d).to(torch.int32),
        "node": (origin + best[pick]).to(torch.int32),
        "ops": ops,
        "n_ops": n_ops,
        "path": torch.where(nodes >= 0, nodes + origin.unsqueeze(-1).to(torch.int32),
                            -1),
        "failed": failed,
    }


def map_read(index: SeGraMIndex, read: torch.Tensor, read_len, **kw) -> dict:
    """Map one read: `map_batch` over a batch of one, results unbatched."""
    out = map_batch(index, read.unsqueeze(0),
                    torch.as_tensor(read_len).reshape(1), **kw)
    return {key: v[0] for key, v in out.items()}
