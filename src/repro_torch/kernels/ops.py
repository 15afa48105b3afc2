"""The port's kernels in one place: wrappers, plain versions, launch counts.

Each entry of `KERNELS` names a wrapper (CUDA kernel on a CUDA tensor,
plain PyTorch on a CPU tensor), its plain version, and the Pallas TPU
kernel it replaces.  `reset_launch_counts` / `launch_counts` read the
wrappers' ``launches`` counters, which only a kernel launch increments.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from .genasm_dc import window_dc_batch, window_dc_batch_plain
from .genasm_dc_v2 import window_dc_batch_v2, window_dc_batch_v2_plain


class Kernel(NamedTuple):
    name: str
    wrapper: Callable
    plain: Callable
    source: str  # CUDA source, repository path
    replaces: str  # the Pallas kernel function, file:line


KERNELS = (
    Kernel("window_dc_batch", window_dc_batch, window_dc_batch_plain,
           "src/repro_torch/kernels/csrc/genasm_dc.cu",
           "src/repro/kernels/genasm_dc.py:94"),
    Kernel("window_dc_batch_v2", window_dc_batch_v2, window_dc_batch_v2_plain,
           "src/repro_torch/kernels/csrc/genasm_dc.cu",
           "src/repro/kernels/genasm_dc_v2.py:66"),
)


def reset_launch_counts() -> None:
    for kern in KERNELS:
        kern.wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {kern.name: kern.wrapper.launches for kern in KERNELS}
