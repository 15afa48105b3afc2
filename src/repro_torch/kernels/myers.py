"""Myers bit-parallel edit distance: the CUDA kernel and its plain version.

Port of `repro.kernels.myers.myers_distance_batch` (Pallas, body
``_myers_kernel``): one pair per lane, global or semiglobal score.  The
kernel is `csrc/myers.cu` (``myers_distance``): each lane holds a run of
contiguous words in registers, one warp (or part of one) a pair up to
10,240 pattern bits and a pipeline of warps a pair beyond; its source
note says what bounds it on the H100.
Unlike `repro.kernels.ops.myers_distance` it needs no padding of the
batch to a tile: the kernel guards its tail.

The edit-distance use case runs it (`core/edit_distance.py`), as the
Edlib baseline beside GenASM's windowed distance.

The plain version is `core/myers.myers_distance_batch`.
`myers_distance_batch` takes it for a tensor on the CPU and launches the
kernel for a CUDA tensor — there is no fallback from one to the other.
``myers_distance_batch.launches`` counts kernel launches; a call with
``B = 0`` or ``n = 0`` launches nothing and returns ``m_lens``, as the
Pallas kernel's loop of zero steps does.
"""
from __future__ import annotations

import torch

from repro_torch.core import myers as _plain
from repro_torch.core.bitvector import WORD_BITS
# a name the reference module binds too
from repro_torch.core.bitvector import NUM_CHARS  # noqa: F401

from . import _build


def _check_inputs(texts, patterns, m_lens, m_bits: int, mode: str):
    if texts.dtype != torch.int8 or patterns.dtype != torch.int8:
        raise TypeError("texts/patterns must be int8 base ids")
    if m_lens.dtype not in (torch.int32, torch.int64):
        raise TypeError("m_lens must be an integer tensor")
    if texts.dim() != 2:
        raise ValueError(f"need [B, n] texts, got {tuple(texts.shape)}")
    b = texts.shape[0]
    if patterns.shape != (b, m_bits) or m_lens.shape != (b,):
        raise ValueError(f"need [{b}, {m_bits}] patterns and [{b}] m_lens, got "
                         f"{tuple(patterns.shape)} / {tuple(m_lens.shape)}")
    if len({t.device for t in (texts, patterns, m_lens)}) != 1:
        raise ValueError("inputs on different devices")
    if mode not in _plain.MODES:
        raise ValueError(f"mode must be one of {_plain.MODES}, got {mode!r}")
    max_bits = _build.library("myers").myers_max_m_bits(texts.device.index)
    if m_bits % WORD_BITS or not 0 < m_bits <= max_bits:
        raise ValueError(f"m_bits must be a multiple of 32 in [32, {max_bits}], "
                         f"got {m_bits}")


def myers_distance_batch(texts: torch.Tensor, patterns: torch.Tensor,
                         m_lens: torch.Tensor, *, m_bits: int,
                         mode: str = "global") -> torch.Tensor:
    """Batched Myers distance.

    ``texts [B, n]`` int8, ``patterns [B, m_bits]`` int8 wildcard-padded,
    ``m_lens [B]``.  Returns ``[B]`` int32 distances, identical to
    `repro.kernels.myers.myers_distance_batch` (global NW, or semiglobal
    min over text prefixes, per ``mode``).
    """
    if texts.device.type == "cpu":
        return _plain.myers_distance_batch(texts, patterns, m_lens,
                                           m_bits=m_bits, mode=mode)
    _check_inputs(texts, patterns, m_lens, m_bits, mode)
    dev = texts.device
    b, n = texts.shape
    m_lens = m_lens.to(torch.int32).contiguous()
    if b == 0 or n == 0:
        return m_lens.clone()
    texts, patterns = texts.contiguous(), patterns.contiguous()
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_build.library("myers").myers_distance(
        texts.data_ptr(), patterns.data_ptr(), m_lens.data_ptr(),
        out.data_ptr(), b, n, m_bits, int(mode == "global"), dev.index,
        stream), "myers_distance")
    myers_distance_batch.launches += 1
    return out


myers_distance_batch.launches = 0


GEOMETRY_KEYS = _build.GEOMETRY_KEYS + ("words_per_lane", "lanes_per_pair",
                                        "warps_per_pair")


def launch_geometry(b: int, m_bits: int, device: torch.device) -> dict:
    """The launch `myers_distance_batch` makes on ``device`` for ``b``
    pairs of ``m_bits``-bit patterns: warps in the grid, blocks, shared
    memory bytes per block, and the words a lane, lanes a pair and warps a
    pair it picks."""
    lib = _build.library("myers")
    return _build.geometry(lib.myers_distance_geometry, b, m_bits,
                           device.index or 0, keys=GEOMETRY_KEYS)
