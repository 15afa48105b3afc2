"""Sequence-to-graph mapping with the port: build a variation graph, map
reads through the tiled `repro_torch.graph` index and the
`repro_torch.align` dispatch (the serve engine runs exactly this path
for ``workload="graph"``).

The twin of `examples/graph_alignment.py`.  The index sits on
``--device`` (the card by default); reads align on ``graph_cuda`` (the
BitAlign CUDA kernel) there, on ``graph_torch`` on the CPU.

    PYTHONPATH=src python examples/torch_graph_alignment.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.genomics import encode, simulate
from repro_torch.genomics.io import cigar_string, gaf_path
from repro_torch.graph import build_graph_index, map_batch_index

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; pass cpu without a GPU)")
device = torch.device(ap.parse_args().device)
backend = "graph_cuda" if device.type == "cuda" else "graph_torch"

ref = simulate.random_reference(5000, seed=3)
variants = simulate.simulate_variants(ref, n_snp=16, n_ins=6, n_del=6, seed=4)
idx = build_graph_index(ref, variants, w=8, k=12, window=256, device=device)
print(f"graph: {idx.n_nodes} nodes ({idx.n_nodes - len(ref)} variant nodes), "
      f"{idx.n_tiles} tiles of {idx.tile_len} @ stride {idx.tile_stride}")

rs = simulate.simulate_reads(ref, n_reads=8, read_len=100,
                             profile=simulate.ILLUMINA, seed=5)
reads, lens = encode.batch_reads(rs.reads, 128)
out = map_batch_index(
    idx, torch.from_numpy(reads), torch.from_numpy(lens), p_cap=128,
    filter_bits=96, filter_k=12, backend=backend)
print(f"align backend: {backend} on {device}")
for i in range(8):
    d = int(out.distance[i])
    pos = int(out.position[i])
    path, plen = gaf_path(out.path[i].cpu().numpy())
    cig = cigar_string(out.ops[i].cpu().numpy(), int(out.n_ops[i]))
    print(f"read{i}: pos={pos} dist={d} path={path[:40]} cigar={cig[:40]}")
assert int(np.sum(~out.failed.cpu().numpy())) >= 6
