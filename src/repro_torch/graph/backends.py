"""The sequence-to-graph alignment backends (registered on import).

Port of `repro.graph.backends`.  Two entries in the `repro_torch.align`
registry, sharing the uniform dispatch signature:

  * ``graph_torch`` — `windowed.graph_align` with the plain
    `window_dc_graph` (the twin of the reference's ``graph_lax``)
  * ``graph_cuda``  — the same window loop with the CUDA BitAlign kernel
    (`repro_torch.kernels.bitalign`): one ``[B, w]`` launch per window
    step, full windows (``p_lens = w``), R store for the traceback (the
    twin of ``graph_pallas``)

``texts`` may be packed graph text (int32, see `windowed`) or plain
int8 linear text — the latter is packed as a hop-0 chain, so the linear
inputs drive the graph backends unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.align.api import register_backend
from repro_torch.core.genasm import GenASMConfig
from repro_torch.kernels.bitalign import bitalign_dc_batch

from .windowed import graph_align, pack_linear_text


def as_graph_text(texts: torch.Tensor) -> torch.Tensor:
    """Accept packed graph text (int32) or plain int8 text (chain-packed)."""
    if texts.dtype == torch.int32:
        return texts
    return pack_linear_text(texts)


def _graph_torch_fn(texts, patterns, p_lens, t_lens, *, cfg: GenASMConfig,
                    p_cap: int, emit_cigar: bool):
    return graph_align(as_graph_text(texts), patterns, p_lens, t_lens,
                       cfg=cfg, p_cap=p_cap, emit_cigar=emit_cigar)


def _graph_cuda_fn(texts, patterns, p_lens, t_lens, *, cfg: GenASMConfig,
                   p_cap: int, emit_cigar: bool):
    w, k = cfg.w, cfg.k

    def dc_fn(bases, succ, sub_p):
        full_w = torch.full((bases.shape[0],), w, dtype=torch.int32,
                            device=bases.device)  # no tail mask
        dists, store = bitalign_dc_batch(bases, succ, sub_p, full_w,
                                         m_bits=w, k=k, store_r=True)
        return dists[:, 0], store  # anchored at window node 0

    return graph_align(as_graph_text(texts), patterns, p_lens, t_lens,
                       cfg=cfg, p_cap=p_cap, emit_cigar=emit_cigar,
                       dc_fn=dc_fn)


register_backend(
    "graph_torch", _graph_torch_fn,
    description="plain PyTorch windowed BitAlign (sequence-to-graph; accepts "
                "packed graph text or plain int8 text as a chain)")
register_backend(
    "graph_cuda", _graph_cuda_fn,
    description="CUDA BitAlign DC kernel in the batched window loop (R-only "
                "TB store, graph traceback over [B] lanes)")
