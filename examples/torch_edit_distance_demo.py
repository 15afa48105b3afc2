"""Use case 3 with the port: edit distance of two long sequences, GenASM
vs Myers (Edlib).

The twin of `examples/edit_distance_demo.py`.  On the card GenASM's
windowed distance runs the GenASM-DC kernel (``cuda_dc``) and Myers the
Myers kernel; on the CPU both run their plain PyTorch versions.

    PYTHONPATH=src python examples/torch_edit_distance_demo.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.edit_distance import genasm_distance
from repro_torch.core.myers import myers_distance
from repro_torch.genomics import simulate

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; pass cpu without a GPU)")
device = torch.device(ap.parse_args().device)

rng = np.random.default_rng(0)
a = simulate.random_reference(2000, seed=1)          # text
b = simulate.mutate(a, simulate.PROFILES["pacbio"], rng)  # pattern (query)

p_cap = 2112
pbuf = np.full((p_cap,), 4, np.int8); pbuf[: len(b)] = b
tbuf = np.full((p_cap + 192,), 4, np.int8); tbuf[: len(a)] = a

d = int(genasm_distance(torch.from_numpy(pbuf).to(device),
                        torch.from_numpy(tbuf).to(device),
                        len(b), len(a), p_cap=p_cap))
m_bits = ((len(b) + 63) // 64) * 64
mbuf = np.full((m_bits,), 4, np.int8); mbuf[: len(b)] = b
dm = int(myers_distance(torch.from_numpy(tbuf).to(device),
                        torch.from_numpy(mbuf).to(device),
                        len(b), m_bits=m_bits, mode="semiglobal"))
print(f"sequence lengths: {len(a)} (text) vs {len(b)} (query)")
print(f"GenASM windowed distance: {d}")
print(f"Myers (Edlib) distance:   {dm}")
assert dm <= d <= dm + max(5, dm // 20), (d, dm)  # windowed ≈ exact
