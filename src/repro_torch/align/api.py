"""Backend registry + unified ``align_batch`` dispatch.

Port of `repro.align.api`.  Every consumer of windowed GenASM alignment
(`core/mapper.py`, the serve engine, `launch/serve_genomics.py`) calls
:func:`align_batch` and names a backend, or lets :func:`resolve_backend`
pick one.  Backends registered by `repro_torch.align.backends`:

  ``ref``         host numpy DP oracle (exact)
  ``torch``       plain PyTorch windowed aligner (`core/genasm.align`),
                  the twin of the reference's ``lax``
  ``cuda_dc``     CUDA GenASM-DC kernel, M/I/D TB store
  ``cuda_dc_v2``  CUDA GenASM-DC kernel, R-only TB store
  ``graph_torch`` plain PyTorch windowed BitAlign (sequence-to-graph)
  ``graph_cuda``  CUDA BitAlign kernel in the same window loop

``backend=None``/``"auto"`` resolves to the ``REPRO_ALIGN_BACKEND``
environment variable when set, else ``cuda_dc`` on a CUDA device and
``torch`` on the CPU.  On the CPU the ``cuda_dc*`` backends run the
batched window loop with the kernels' plain versions.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.genasm import AlignResult, GenASMConfig


@dataclass(frozen=True)
class Backend:
    """One registered alignment implementation."""

    name: str
    fn: Callable  # (texts, patterns, p_lens, t_lens, *, cfg, p_cap,
    #               emit_cigar) -> AlignResult
    description: str = ""


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, fn: Callable, *, description: str = "") -> Backend:
    """Register (or replace) a backend under ``name``."""
    b = Backend(name=name, fn=fn, description=description)
    _REGISTRY[name] = b
    return b


def available_backends() -> tuple[str, ...]:
    """Names of every registered alignment backend, registration order."""
    return tuple(_REGISTRY)


def get_backend(name: str) -> Backend:
    """Registered :class:`Backend` for ``name`` (ValueError if unknown)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown align backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def resolve_backend(backend: str | None = None,
                    device: torch.device | str = "cpu") -> Backend:
    """Map a requested name (or None/"auto") to a registered backend.

    Order: explicit name > ``REPRO_ALIGN_BACKEND`` > device default
    (``cuda_dc`` on a CUDA device, ``torch`` on the CPU).
    """
    if backend in (None, "auto"):
        backend = os.environ.get("REPRO_ALIGN_BACKEND") or (
            "cuda_dc" if torch.device(device).type == "cuda" else "torch")
    return get_backend(backend)


def align_batch(
    texts: torch.Tensor,
    patterns: torch.Tensor,
    p_lens: torch.Tensor,
    t_lens: torch.Tensor,
    *,
    cfg: GenASMConfig = GenASMConfig(),
    backend: str | None = None,
    p_cap: int | None = None,
    emit_cigar: bool = True,
) -> AlignResult:
    """Align a batch of (text, pattern) pairs on the selected backend.

    ``texts`` [B, t_cap] / ``patterns`` [B, p_cap] int8 buffers with
    ``t_lens`` / ``p_lens`` valid lengths (anchored semi-global, pattern
    fully consumed), all on one device.  Returns a batched
    :class:`AlignResult` on that device — identical distances/CIGARs
    across the ``torch`` and ``cuda_dc*`` backends, and across the two
    graph backends (which take packed int32 graph text as ``texts``).
    """
    be = resolve_backend(backend, texts.device)
    cap = int(patterns.shape[-1]) if p_cap is None else p_cap
    return be.fn(texts, patterns, p_lens, t_lens, cfg=cfg, p_cap=cap,
                 emit_cigar=emit_cigar)
