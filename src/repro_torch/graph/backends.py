"""The sequence-to-graph alignment backends (registered on import).

Port of `repro.graph.backends`.  Two entries in the `repro_torch.align`
registry, sharing the uniform dispatch signature:

  * ``graph_torch`` — `windowed.graph_align` with the plain
    `window_dc_graph` (the twin of the reference's ``graph_lax``)
  * ``graph_cuda``  — `batched_graph_align`: the same window loop with the
    CUDA BitAlign kernel (`repro_torch.kernels.bitalign`): one ``[B, w]``
    launch per window step, full windows (``p_lens = w``), R store for the
    traceback (the twin of ``graph_pallas``)

``texts`` may be packed graph text (int32, see `windowed`) or plain
int8 linear text — the latter is packed as a hop-0 chain, so the linear
inputs drive the graph backends unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.align.api import register_backend
# names the reference module binds too
from repro_torch.core.bitvector import pattern_bitmasks  # noqa: F401
from repro_torch.core.genasm import (AlignResult, GenASMConfig,  # noqa: F401
                                     pad_pattern, window_commit)
from repro_torch.core.genasm_tb import OP_PAD  # noqa: F401
from repro_torch.kernels.bitalign import bitalign_dc_batch

from .windowed import (graph_align, pack_linear_text,  # noqa: F401
                       pad_graph_text, unpack_graph_text, window_tb_graph)


def as_graph_text(texts: torch.Tensor) -> torch.Tensor:
    """Accept packed graph text (int32) or plain int8 text (chain-packed)."""
    if texts.dtype == torch.int32:
        return texts
    return pack_linear_text(texts)


def _graph_torch_fn(texts, patterns, p_lens, t_lens, *, cfg: GenASMConfig,
                    p_cap: int, emit_cigar: bool):
    return graph_align(as_graph_text(texts), patterns, p_lens, t_lens,
                       cfg=cfg, p_cap=p_cap, emit_cigar=emit_cigar)


def batched_graph_align(texts: torch.Tensor, patterns: torch.Tensor,
                        p_lens: torch.Tensor, t_lens: torch.Tensor, *,
                        cfg: GenASMConfig = GenASMConfig(),
                        p_cap: int | None = None,
                        emit_cigar: bool = True) -> AlignResult:
    """Windowed BitAlign over a batch, DC on the BitAlign kernel.

    Port of `repro.graph.backends.batched_graph_align` without its Pallas
    tile arguments (``block_bt``, ``interpret``).  ``texts`` is packed
    graph text (int32) or plain int8 text (chain-packed).  Each window
    step is one `bitalign_dc_batch` call with the R store: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor.
    """
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
    "graph_cuda", batched_graph_align,
    description="CUDA BitAlign DC kernel in the batched window loop (R-only "
                "TB store, graph traceback over [B] lanes)")
