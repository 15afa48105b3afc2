"""The four built-in alignment backends (registered on import).

Each adapts the uniform dispatch signature ``(texts, patterns, p_lens,
t_lens, *, cfg, p_cap, emit_cigar)`` to one implementation:

  * ``ref``        — `refdp.align_batch_host` on the host
  * ``torch``      — `core/genasm.align` with the plain DC (twin of ``lax``)
  * ``cuda_dc``    — `batched.batched_kernel_align` on the v1 kernel
  * ``cuda_dc_v2`` — same, v2 kernel (R-only TB store)
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import genasm
from repro_torch.core.genasm import AlignResult, GenASMConfig

from . import refdp
from .api import register_backend
from .batched import batched_kernel_align


def _ref_fn(texts, patterns, p_lens, t_lens, *, cfg: GenASMConfig,
            p_cap: int, emit_cigar: bool):
    # same ops width as the windowed backends; distances-only mode keeps
    # the [b, 1] padded shape but still reports the true n_ops
    cap = cfg.ops_cap(p_cap) if emit_cigar else 1
    dist, ops, n_ops, t_used, failed = refdp.align_batch_host(
        texts.cpu().numpy(), patterns.cpu().numpy(), p_lens.cpu().numpy(),
        t_lens.cpu().numpy(), cap=cap)
    dev = texts.device
    return AlignResult(*(torch.from_numpy(x).to(dev)
                         for x in (dist, ops, n_ops, t_used, failed)))


def _torch_fn(texts, patterns, p_lens, t_lens, *, cfg: GenASMConfig,
              p_cap: int, emit_cigar: bool):
    return genasm.align(texts, patterns, p_lens, t_lens, cfg=cfg, p_cap=p_cap,
                        emit_cigar=emit_cigar)


def _cuda_fn(texts, patterns, p_lens, t_lens, *, cfg: GenASMConfig,
             p_cap: int, emit_cigar: bool, store_r: bool):
    return batched_kernel_align(texts, patterns, p_lens, t_lens, cfg=cfg,
                                p_cap=p_cap, emit_cigar=emit_cigar,
                                store_r=store_r)


register_backend(
    "ref", _ref_fn,
    description="host numpy DP oracle with traceback (exact; test ground "
                "truth, never a production path)")
register_backend(
    "torch", _torch_fn,
    description="plain PyTorch windowed GenASM (CPU default)")
register_backend(
    "cuda_dc", partial(_cuda_fn, store_r=False),
    description="CUDA GenASM-DC kernel, M/I/D TB store (paper-faithful)")
register_backend(
    "cuda_dc_v2", partial(_cuda_fn, store_r=True),
    description="CUDA GenASM-DC v2 kernel, R-only TB store (3x less TB "
                "traffic)")
