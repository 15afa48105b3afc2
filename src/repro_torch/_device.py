"""The port's one device check: an entry point runs on the card unless the
caller asks for the CPU, and never falls back from one to the other."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``, raising a `RuntimeError` when it names CUDA
    and no card is visible (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is visible; pass "
                           f"device='cpu' (--device cpu) to run the plain "
                           f"PyTorch path on the CPU")
    return dev
