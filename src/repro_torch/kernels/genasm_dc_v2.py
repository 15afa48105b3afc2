"""GenASM-DC kernel v2 — R-only traceback store — and its plain version.

Port of `repro.kernels.genasm_dc_v2.window_dc_batch_v2` (Pallas, body
``_dc_kernel_v2``).  Every traceback check vector derives from the
status rows alone:

    D(i,d) = R(i+1, d-1)           S(i,d) = shl1(D)
    I(i,d) = shl1(R(i, d-1))       M(i,d) = shl1(R(i+1, d)) | PM[text[i]]

so storing only ``R`` (``[w+1, k+1, nw]`` with the all-ones boundary row
``i = w``) writes 13,000 B per window at w=64, k=24 instead of 38,400 B.
The kernel is ``genasm_dc_v2`` in `csrc/genasm_dc.cu`: v1's per-row
wavefront, one window a warp and four windows a block, storing R in
shared memory and writing the block's windows out as one coalesced
region.  ``window_dc_batch_v2.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import genasm_dc as _core
from repro_torch.core.bitvector import WORD_BITS
# a name the reference module binds too
from repro_torch.core.bitvector import NUM_CHARS  # noqa: F401

from . import _build
from .genasm_dc import launch


def window_dc_batch_v2_plain(sub_texts: torch.Tensor, sub_patterns: torch.Tensor,
                             *, w: int = 64, k: int = 24):
    """Plain PyTorch version: batched `dc_step` loops (`core.window_dc_r`)."""
    return _core.window_dc_r(sub_texts, sub_patterns, w=w, k=k)


def window_dc_batch_v2(sub_texts: torch.Tensor, sub_patterns: torch.Tensor, *,
                       w: int = 64, k: int = 24):
    """Returns ``(d_min [B] int32, R [B, w+1, k+1, nw] int32)`` — status
    rows only; CPU tensors take the plain version, CUDA tensors the kernel."""
    if sub_texts.device.type == "cpu":
        return window_dc_batch_v2_plain(sub_texts, sub_patterns, w=w, k=k)
    b = sub_texts.shape[0]
    res = launch("genasm_dc_v2", sub_texts, sub_patterns,
                 (b, w + 1, k + 1, w // WORD_BITS), w, k)
    if b:
        window_dc_batch_v2.launches += 1
    return res


window_dc_batch_v2.launches = 0


def launch_geometry(b: int, w: int, k: int) -> dict:
    """The launch `window_dc_batch_v2` makes on the card for ``[b, w]``
    windows at ``k``: warps in the grid, blocks, shared memory bytes per
    block."""
    lib = _build.library("genasm_dc")
    return _build.geometry(lib.genasm_dc_v2_geometry, b, w, k)
