"""GenASM-DC window batches: the CUDA kernel v1 and its plain version.

Port of `repro.kernels.genasm_dc.window_dc_batch` (Pallas, body
``_dc_kernel``): GenASM-DC over ``[B, w]`` windows with the full
(M, I, D) traceback store.  The kernel is `csrc/genasm_dc.cu`
(``genasm_dc_v1``), a per-row wavefront with one window per warp; its
source note says what bounds it on the H100.

`window_dc_batch` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor — there is no fallback from one to
the other.  ``window_dc_batch.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import genasm_dc as _core
from repro_torch.core.bitvector import WORD_BITS
# a name the reference module binds too
from repro_torch.core.bitvector import NUM_CHARS  # noqa: F401

from . import _build

MAX_W = 4 * WORD_BITS  # the kernel is instantiated for nw = 1..4


def window_dc_batch_plain(sub_texts: torch.Tensor, sub_patterns: torch.Tensor, *,
                          w: int = 64, k: int = 24):
    """Plain PyTorch version: batched `dc_step` loops (`core.window_dc`)."""
    return _core.window_dc(sub_texts, sub_patterns, w=w, k=k)


def _check_inputs(sub_texts: torch.Tensor, sub_patterns: torch.Tensor, w: int,
                  k: int) -> None:
    if sub_texts.dtype != torch.int8 or sub_patterns.dtype != torch.int8:
        raise TypeError("sub_texts/sub_patterns must be int8 base ids")
    if sub_texts.shape != sub_patterns.shape or sub_texts.dim() != 2 or \
            sub_texts.shape[1] != w:
        raise ValueError(f"need [B, {w}] texts and patterns, got "
                         f"{tuple(sub_texts.shape)} / {tuple(sub_patterns.shape)}")
    if sub_texts.device != sub_patterns.device:
        raise ValueError("sub_texts and sub_patterns on different devices")
    if w % WORD_BITS or not 0 < w <= MAX_W:
        raise ValueError(f"w must be a multiple of 32 in [32, {MAX_W}], got {w}")
    max_k = _build.library("genasm_dc").genasm_dc_max_k()
    if not 0 <= k <= max_k:
        raise ValueError(f"k must be in [0, {max_k}], got {k}")


def launch(entry: str, sub_texts: torch.Tensor, sub_patterns: torch.Tensor,
           out_shape: tuple, w: int, k: int):
    """Launch C entry point ``entry`` on PyTorch's current stream of the
    inputs' device; returns ``(d_min [B] int32, out int32)``."""
    _check_inputs(sub_texts, sub_patterns, w, k)
    dev = sub_texts.device
    texts = sub_texts.contiguous()
    pats = sub_patterns.contiguous()
    b = texts.shape[0]
    d_min = torch.empty((b,), dtype=torch.int32, device=dev)
    out = torch.empty(out_shape, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(_build.library("genasm_dc"), entry)
    _build.check(fn(texts.data_ptr(), pats.data_ptr(), d_min.data_ptr(),
                    out.data_ptr(), b, w, k, dev.index, stream), entry)
    return d_min, out


def window_dc_batch(sub_texts: torch.Tensor, sub_patterns: torch.Tensor, *,
                    w: int = 64, k: int = 24):
    """Batched GenASM-DC windows.

    ``sub_texts``/``sub_patterns``: ``[B, w] int8``.  Returns ``(d_min [B]
    int32, tb [B, w, k+1, 3, nw] int32)``, the uint32 words as int32 bit
    patterns — identical to `repro.kernels.genasm_dc.window_dc_batch`.
    """
    if sub_texts.device.type == "cpu":
        return window_dc_batch_plain(sub_texts, sub_patterns, w=w, k=k)
    b = sub_texts.shape[0]
    res = launch("genasm_dc_v1", sub_texts, sub_patterns,
                 (b, w, k + 1, 3, w // WORD_BITS), w, k)
    if b:
        window_dc_batch.launches += 1
    return res


window_dc_batch.launches = 0


def launch_geometry(b: int, w: int, k: int) -> dict:
    """The launch `window_dc_batch` makes on the card for ``[b, w]`` windows
    at ``k``: warps in the grid, blocks, shared memory bytes per block."""
    lib = _build.library("genasm_dc")
    return _build.geometry(lib.genasm_dc_v1_geometry, b, w, k)
