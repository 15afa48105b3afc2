"""Quickstart of the PyTorch + CUDA port: align one read against a
reference with GenASM.

The twin of `examples/quickstart.py`.  Alignment goes through the
`repro_torch.align` backend dispatch: ``cuda_dc`` (the GenASM-DC CUDA
kernel) on the card, ``torch`` (the plain PyTorch aligner) on the CPU;
``cuda_dc_v2`` and ``ref`` (exact DP oracle) give the same result.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import align as align_dispatch
from repro_torch.core.genasm import GenASMConfig
from repro_torch.genomics.encode import encode
from repro_torch.genomics.io import cigar_string

REF = "ACGTACGGATTACAGGCATCGTACGATCGTAGCTAGCTTAGGCATCATACGGATTACATTCCGGAA"
READ = "ACGGATTACAGGCTTCGTACGATCGAGCTAGCTTAGGCAT"  # 1 subst + 1 deletion

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; pass cpu without a GPU)")
device = torch.device(ap.parse_args().device)
BACKEND = "cuda_dc" if device.type == "cuda" else "torch"

ref = encode(REF)
read = encode(READ)
offset = 4  # candidate location (in production found by minimizer seeding)

p_cap = 64
text = np.full((p_cap + 64,), 4, np.int8)
text[: len(ref) - offset] = ref[offset:]
pat = np.full((p_cap,), 4, np.int8)
pat[: len(read)] = read

res = align_dispatch.align_batch(
    torch.from_numpy(text)[None].to(device),
    torch.from_numpy(pat)[None].to(device),
    torch.tensor([len(read)], dtype=torch.int32, device=device),
    torch.tensor([len(ref) - offset], dtype=torch.int32, device=device),
    cfg=GenASMConfig(), p_cap=p_cap, backend=BACKEND)
print("backend:", BACKEND, "of", align_dispatch.available_backends())
print("edit distance:", int(res.distance[0]))
print("CIGAR:", cigar_string(res.ops[0].cpu().numpy(), int(res.n_ops[0])))
assert int(res.distance[0]) == 2
