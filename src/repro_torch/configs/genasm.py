"""The paper's own workload config: GenASM read-alignment service.

Window geometry per the dissertation (W=64, O=24), long-read parameters
matching the evaluation datasets (§4.9): 10 kbp reads at 10–15% error.
"""
from dataclasses import dataclass

from repro_torch.core.genasm import GenASMConfig


@dataclass(frozen=True)
class GenASMServiceConfig:
    genasm: GenASMConfig = GenASMConfig(w=64, o=24, k=24)
    # repro_torch.align registry name; "auto" = cuda_dc on a CUDA device,
    # torch on the CPU (align/api.py::resolve_backend)
    align_backend: str = "auto"
    read_cap: int = 10_240          # long reads (paper: 10 kbp)
    short_read_cap: int = 256       # Illumina use case
    filter_bits: int = 128
    filter_k: int = 12
    minimizer_w: int = 10
    minimizer_k: int = 15
    batch_reads: int = 2048         # per-device alignment batch


CONFIG = GenASMServiceConfig()
