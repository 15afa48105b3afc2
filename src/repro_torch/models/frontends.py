"""Modality frontend STUBS (port of `repro.models.frontends`).

``[audio]``/``[vlm]`` architectures specify the transformer backbone only;
the frontend is a stub whose output embeddings arrive precomputed via
``input_specs()``.  These helpers size those embeddings and synthesize
random ones for smoke tests (from a ``torch.Generator``: the numbers are
not the reference's, only their shape and scale).
"""
from __future__ import annotations

import torch


def frontend_embed_shape(cfg, batch: int, length: int | None = None):
    fd = cfg.frontend_dim or cfg.d_model
    return (batch, length if length is not None else cfg.frontend_len, fd)


def synth_frontend_embeds(cfg, batch: int, length: int | None = None,
                          seed: int = 0, *, device="cuda"):
    """Random stub embeddings on ``device`` (``cuda`` raises without a
    card; pass ``device="cpu"``)."""
    from repro_torch._device import resolve_device

    device = resolve_device(device)
    shape = frontend_embed_shape(cfg, batch, length)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * 0.02
