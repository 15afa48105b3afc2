"""BitAlign DC over packed subgraphs: the CUDA kernel and its plain version.

Port of `repro.kernels.bitalign.bitalign_dc_batch` (Pallas, body
``_bitalign_kernel``): the SeGraM sequence-to-graph DC over ``[B, N]``
linearized subgraphs, one lane per row, with a 16-deep hop ring and the
``p_len`` tail mask.  The kernel is `csrc/bitalign.cu` (``bitalign_dc``),
a per-row wavefront on a warp; its source note says what bounds it on
the H100.

Two call sites run it on the graph main path: the mapper's tile filter
(`graph/mapper.py::_filter_dists`, distances only, ``store_r=False``) and
the ``graph_cuda`` window loop (`graph/backends.py`, with the R store its
traceback reads).

The plain version is `core/segram/bitalign.bitalign_rows`.
`bitalign_dc_batch` takes it for a tensor on the CPU and
launches the kernel for a CUDA tensor — there is no fallback from one to
the other.  ``bitalign_dc_batch.launches`` counts kernel launches, and
``bitalign_dc_batch.launches_by_store`` splits them by ``store_r``
(``"r"``: the align loop; ``"no_r"``: the filter).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitvector import WORD_BITS
from repro_torch.core.segram.bitalign import bitalign_rows
# names the reference module binds too
from repro_torch.core.bitvector import NUM_CHARS  # noqa: F401
from repro_torch.core.segram.graph import HOP_LIMIT  # noqa: F401

from . import _build

MAX_M_BITS = 4 * WORD_BITS  # the kernel is instantiated for nw = 1..4


def _check_inputs(bases, succ_bits, patterns, p_lens, m_bits: int, k: int):
    if bases.dtype != torch.int8 or patterns.dtype != torch.int8:
        raise TypeError("bases/patterns must be int8 base ids")
    if succ_bits.dtype != torch.int32:
        raise TypeError("succ_bits must be int32 hopBit patterns")
    if bases.dim() != 2 or succ_bits.shape != bases.shape:
        raise ValueError(f"need [B, N] bases and succ_bits, got "
                         f"{tuple(bases.shape)} / {tuple(succ_bits.shape)}")
    b = bases.shape[0]
    if patterns.shape != (b, m_bits) or p_lens.shape != (b,):
        raise ValueError(f"need [{b}, {m_bits}] patterns and [{b}] p_lens, got "
                         f"{tuple(patterns.shape)} / {tuple(p_lens.shape)}")
    if len({t.device for t in (bases, succ_bits, patterns, p_lens)}) != 1:
        raise ValueError("inputs on different devices")
    if m_bits % WORD_BITS or not 0 < m_bits <= MAX_M_BITS:
        raise ValueError(f"m_bits must be a multiple of 32 in [32, "
                         f"{MAX_M_BITS}], got {m_bits}")
    max_k = _build.library("bitalign").bitalign_max_k()
    if not 0 <= k <= max_k:
        raise ValueError(f"k must be in [0, {max_k}], got {k}")


def bitalign_dc_batch(bases: torch.Tensor, succ_bits: torch.Tensor,
                      patterns: torch.Tensor, p_lens: torch.Tensor, *,
                      m_bits: int, k: int, store_r: bool = True):
    """Batched BitAlign DC.

    ``bases [B, N]`` int8, ``succ_bits [B, N]`` int32 hopBits, ``patterns
    [B, m_bits]`` int8 wildcard-padded, ``p_lens [B]``.  Returns ``(dists
    [B, N] int32, R [B, N, k+1, nw] int32 or None)`` — the uint32 words as
    int32 bit patterns, identical to
    `repro.kernels.bitalign.bitalign_dc_batch`; ``R`` is None without
    ``store_r``.
    """
    if bases.device.type == "cpu":
        return bitalign_rows(bases, succ_bits, patterns, p_lens,
                             m_bits=m_bits, k=k, store_r=store_r)
    _check_inputs(bases, succ_bits, patterns, p_lens, m_bits, k)
    dev = bases.device
    b, n = bases.shape
    bases, succ_bits, patterns = (x.contiguous()
                                  for x in (bases, succ_bits, patterns))
    p_lens = p_lens.to(torch.int32).contiguous()
    dists = torch.empty((b, n), dtype=torch.int32, device=dev)
    r = (torch.empty((b, n, k + 1, m_bits // WORD_BITS), dtype=torch.int32,
                     device=dev) if store_r else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.library("bitalign").bitalign_dc(
        bases.data_ptr(), succ_bits.data_ptr(), patterns.data_ptr(),
        p_lens.data_ptr(), dists.data_ptr(),
        None if r is None else r.data_ptr(), b, n, m_bits, k, dev.index,
        stream), "bitalign_dc")
    if b and n:
        bitalign_dc_batch.launches += 1
        bitalign_dc_batch.launches_by_store["r" if store_r else "no_r"] += 1
    return dists, r


bitalign_dc_batch.launches = 0
bitalign_dc_batch.launches_by_store = {"r": 0, "no_r": 0}


def launch_geometry(b: int, m_bits: int, k: int, store_r: bool,
                    device: torch.device) -> dict:
    """The launch `bitalign_dc_batch` makes on ``device`` for ``b`` rows:
    warps in the grid, blocks, shared memory bytes per block."""
    lib = _build.library("bitalign")
    return _build.geometry(lib.bitalign_geometry, b, m_bits, k, int(store_r),
                           device.index or 0)
