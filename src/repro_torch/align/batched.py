"""Batched windowed alignment on the CUDA GenASM-DC kernels.

Port of `repro.align.batched`: the window loop is inverted so the whole
batch advances through its window steps together, and each step issues
**one** kernel launch over ``[B, w]`` windows (a warp per window for v1,
a thread per window for v2) followed by the batched traceback over the
kernel's store.  Lanes that finish early keep issuing no-op windows
(advance 0) until the loop ends.

The loop itself is `core.genasm.align`, which the ``torch`` backend runs
with the plain DC; here it runs with the kernel wrappers, so the two
backends share every commit rule and emit bit-identical results.  On a
CPU tensor the wrappers take their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core import genasm
from repro_torch.core.genasm import AlignResult, GenASMConfig
from repro_torch.kernels.genasm_dc import window_dc_batch
from repro_torch.kernels.genasm_dc_v2 import window_dc_batch_v2

# names the reference module binds too
from repro_torch.core.bitvector import pattern_bitmasks  # noqa: F401
from repro_torch.core.genasm import (pad_pattern, pad_text,  # noqa: F401
                                     window_commit)
from repro_torch.core.genasm_tb import (OP_PAD, window_tb,  # noqa: F401
                                        window_tb_r)


def batched_kernel_align(
    texts: torch.Tensor,
    patterns: torch.Tensor,
    p_lens: torch.Tensor,
    t_lens: torch.Tensor,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    p_cap: int | None = None,
    emit_cigar: bool = True,
    store_r: bool = False,
) -> AlignResult:
    """Windowed GenASM over a batch, DC on the kernel.

    ``store_r`` selects the v2 (R-only TB store) kernel.  Returns a
    batched :class:`AlignResult`.
    """
    dc = window_dc_batch_v2 if store_r else window_dc_batch

    def dc_fn(sub_t, sub_p):
        return dc(sub_t, sub_p, w=cfg.w, k=cfg.k)

    return genasm.align(texts, patterns, p_lens, t_lens,
                        cfg=cfg._replace(store_r=store_r), p_cap=p_cap,
                        emit_cigar=emit_cigar, dc_fn=dc_fn)
