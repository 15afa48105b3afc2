"""The linear mapper's pre-alignment filter: the CUDA kernel and its plain version.

For every read ``b`` and candidate ``c`` the filter takes the exact Bitap
distance of the read's first ``filter_bits`` bases at every position of a
``region_len``-base window of the reference, and keeps the least distance
and the first position that reaches it.  The reference computes this as
plain XLA (`repro.core.genasm_dc.bitap_search` over ``[B·C]`` lanes, then
``min`` and ``argmin`` in `repro.core.mapper`), so this kernel replaces no
Pallas kernel.  The kernel is `csrc/bitap_filter.cu` (``bitap_filter``): one
thread a lane, the status rows in registers, the minimum and its position
kept as the scan goes; its source note says what bounds it.

`bitap_filter_batch` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; there is no fallback from one to the other.
``bitap_filter_batch.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import genasm_dc as _core
from repro_torch.core.bitvector import WILDCARD, WORD_BITS

from . import _build

MAX_BITS = 4 * WORD_BITS  # the kernel is instantiated for nw = 1..4
MAX_REGION = 1 << 30  # the kernel's region offsets are 32-bit


def bitap_filter_batch_plain(ref_buf: torch.Tensor, starts: torch.Tensor,
                             reads: torch.Tensor, read_lens: torch.Tensor, *,
                             filter_bits: int, k: int, region_len: int):
    """Plain PyTorch version: `core.genasm_dc.bitap_search` over the
    ``[B·C]`` regions (`core.mapper`'s text window), then the least
    distance and the first position that reaches it (``argmin``'s first
    occurrence)."""
    from repro_torch.core.mapper import _ref_window  # it imports this module

    b, n_cand = starts.shape
    bit_idx = torch.arange(filter_bits, device=reads.device)
    fpat = torch.where(bit_idx < read_lens.clamp(max=filter_bits).unsqueeze(1),
                       reads[:, :filter_bits], WILDCARD).to(torch.int8)
    region = _ref_window(ref_buf, starts, region_len)
    dists = _core.bitap_search(
        region.reshape(b * n_cand, region_len),
        fpat.repeat_interleave(n_cand, dim=0), m_bits=filter_bits,
        k=k).reshape(b, n_cand, region_len)
    return dists.min(-1).values, dists.argmin(-1).to(torch.int32)


def _check_inputs(ref_buf, starts, reads, read_lens, filter_bits: int, k: int,
                  region_len: int) -> None:
    """Shapes, dtypes, devices and sizes; none of it loads the library."""
    if ref_buf.dtype != torch.int8 or reads.dtype != torch.int8:
        raise TypeError("ref_buf/reads must be int8 base ids")
    if starts.dtype != torch.int64 or read_lens.dtype != torch.int64:
        raise TypeError("starts/read_lens must be int64")
    if ref_buf.dim() != 1 or starts.dim() != 2 or reads.dim() != 2 or \
            read_lens.shape != (starts.shape[0],) or \
            reads.shape[0] != starts.shape[0]:
        raise ValueError(
            f"need ref_buf [L], starts [B, C], reads [B, cap], read_lens [B]; got "
            f"{tuple(ref_buf.shape)}, {tuple(starts.shape)}, {tuple(reads.shape)}, "
            f"{tuple(read_lens.shape)}")
    if len({t.device for t in (ref_buf, starts, reads, read_lens)}) != 1:
        raise ValueError("ref_buf, starts, reads and read_lens on different devices")
    if filter_bits % WORD_BITS or not 0 < filter_bits <= MAX_BITS:
        raise ValueError(f"filter_bits must be a multiple of 32 in [32, {MAX_BITS}], "
                         f"got {filter_bits}")
    if reads.shape[1] < filter_bits:
        raise ValueError(f"reads hold {reads.shape[1]} bases, fewer than "
                         f"filter_bits {filter_bits}")
    if not 0 < region_len <= MAX_REGION:
        raise ValueError(f"region_len must be in [1, {MAX_REGION}], got {region_len}")
    if k < 0:
        raise ValueError(f"k must be non-negative, got {k}")


def bitap_filter_batch(ref_buf: torch.Tensor, starts: torch.Tensor,
                       reads: torch.Tensor, read_lens: torch.Tensor, *,
                       filter_bits: int, k: int, region_len: int):
    """The filter over ``[B, C]`` lanes.

    ``ref_buf [L] int8`` is a reference buffer, ``starts [B, C] int64``
    each lane's region start in it (clamped into ``[0, L]``; positions at
    or past ``L`` read SENTINEL), ``reads [B, cap] int8`` with ``cap >=
    filter_bits`` and ``read_lens [B] int64`` (the pattern is WILDCARD at
    and past each length).  Returns ``(dist [B, C] int32, off [B, C]
    int32)``: each lane's least distance over its region (``k+1`` where
    none is within ``k``) and the first region position that reaches it.
    CPU tensors take the plain version, CUDA tensors the kernel.
    """
    _check_inputs(ref_buf, starts, reads, read_lens, filter_bits, k, region_len)
    kw = dict(filter_bits=filter_bits, k=k, region_len=region_len)
    if ref_buf.device.type == "cpu":
        return bitap_filter_batch_plain(ref_buf, starts, reads, read_lens, **kw)
    lib = _build.library("bitap_filter")
    max_k = lib.bitap_filter_max_k()
    if k > max_k:
        raise ValueError(f"k must be in [0, {max_k}], got {k}")
    dev = ref_buf.device
    b, n_cand = starts.shape
    ref, st = ref_buf.contiguous(), starts.contiguous()
    reads, lens = reads.contiguous(), read_lens.contiguous()
    dist = torch.empty((b, n_cand), dtype=torch.int32, device=dev)
    off = torch.empty((b, n_cand), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.bitap_filter(
        ref.data_ptr(), ref.shape[0], st.data_ptr(), reads.data_ptr(),
        reads.shape[1], lens.data_ptr(), dist.data_ptr(), off.data_ptr(),
        b * n_cand, n_cand, filter_bits, region_len, k, dev.index, stream),
        "bitap_filter")
    if b * n_cand:
        bitap_filter_batch.launches += 1
    return dist, off


bitap_filter_batch.launches = 0


def launch_geometry(lanes: int, filter_bits: int, k: int) -> dict:
    """The launch `bitap_filter_batch` makes on the card for ``lanes``
    lanes: warps in the grid, blocks, shared memory bytes per block."""
    lib = _build.library("bitap_filter")
    return _build.geometry(lib.bitap_filter_geometry, lanes, filter_bits, k)
