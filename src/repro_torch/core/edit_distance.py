"""Use case 3: edit distance between two arbitrary-length sequences
(paper §4.8, §4.10.4).

Port of `repro.core.edit_distance`, batched over ``[B]`` pairs.  Per the
paper, the windowed DC+TB pipeline is reused (the TB walk drives the
divide-and-conquer advance) but no CIGAR is emitted.  Beside it, the
full-length multi-word Bitap distance for short sequences and Myers'
algorithm, the Edlib baseline.

On a CUDA device `genasm_distance_batch` resolves to the ``cuda_dc``
backend (the GenASM-DC kernel in the batched window loop) and
`myers_distance_batch` launches the Myers kernel; on the CPU both run
their plain PyTorch versions.  `genasm_distance` and `myers_distance`
are the reference's one-pair entry points, each a batch of one.
"""
from __future__ import annotations

import torch

from repro_torch.align.api import align_batch
from repro_torch.kernels.myers import myers_distance_batch as _myers_kernel

from .genasm import GenASMConfig
from .genasm_dc import bitap_search
# names the reference module binds too
from .genasm import align  # noqa: F401
from .myers import myers_distance  # noqa: F401


def genasm_distance(a: torch.Tensor, b: torch.Tensor, a_len, b_len, *,
                    cfg: GenASMConfig = GenASMConfig(),
                    p_cap: int | None = None) -> torch.Tensor:
    """Edit distance of one ``a`` (pattern, ``[p]``) vs ``b`` (text,
    ``[t]``) via windowed GenASM: `genasm_distance_batch`'s path on a
    batch of one (``cuda_dc`` on a CUDA device).  Returns a 0-d int32
    tensor, -1 when a window exceeded its threshold."""
    b = torch.as_tensor(b)
    a = torch.as_tensor(a, device=b.device)
    a_lens = torch.as_tensor(a_len, device=b.device).reshape(1)
    b_lens = torch.as_tensor(b_len, device=b.device).reshape(1)
    res = align_batch(b[None], a[None], a_lens, b_lens, cfg=cfg, p_cap=p_cap,
                      emit_cigar=False)
    return res.distance[0]


def genasm_distance_batch(a: torch.Tensor, b: torch.Tensor, a_lens: torch.Tensor,
                          b_lens: torch.Tensor, *,
                          cfg: GenASMConfig = GenASMConfig()) -> torch.Tensor:
    """Edit distance of each ``a`` (pattern) vs ``b`` (text) via windowed
    GenASM.

    ``a [B, p_cap]`` / ``b [B, t_cap]`` int8 buffers with valid lengths
    ``a_lens`` / ``b_lens``.  Semi-global semantics (pattern consumed,
    free text end).  Returns ``[B]`` int32 distances, -1 where a window
    exceeded its threshold.  The backend is `align_batch`'s default
    (`resolve_backend`: ``cuda_dc`` on a CUDA device, ``torch`` on the
    CPU, unless ``REPRO_ALIGN_BACKEND`` names another).
    """
    res = align_batch(b, a, a_lens, b_lens, cfg=cfg, emit_cigar=False)
    return res.distance


def bitap_distance(a: torch.Tensor, b: torch.Tensor, *, m_bits: int,
                   k: int) -> torch.Tensor:
    """Full-length Bitap distance of ``a [B, m_bits]`` (wildcard-padded
    pattern) in ``b [B, n]`` (short sequences; exact up to threshold
    ``k``, ``k+1`` beyond).  Returns ``[B]`` int32."""
    return bitap_search(b, a, m_bits=m_bits, k=k).min(-1).values


def myers_distance_batch(texts: torch.Tensor, patterns: torch.Tensor,
                         m_lens: torch.Tensor, *, m_bits: int,
                         mode: str = "global") -> torch.Tensor:
    """Myers distance of each pair (`repro_torch.kernels.myers`: the CUDA
    kernel on a CUDA tensor, the plain version on the CPU)."""
    return _myers_kernel(texts, patterns, m_lens, m_bits=m_bits, mode=mode)
