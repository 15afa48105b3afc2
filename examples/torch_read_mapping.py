"""Online read mapping with the port's `repro_torch.serve` micro-batching
engine.

The twin of `examples/read_mapping.py`: submits a stream of simulated
reads through the async serving API (`submit() -> future`), prints
per-read latency as results resolve, and ends with the engine's metrics
snapshot.  The index sits on ``--device`` (the card by default) and the
engine aligns there (``cuda_dc`` on the card, ``torch`` on the CPU).

    PYTHONPATH=src python examples/torch_read_mapping.py [--device cpu]
"""
import argparse

from repro_torch.core import minimizer_index
from repro_torch.genomics import simulate
from repro_torch.serve import EngineConfig, ServeEngine, Session

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; pass cpu without a GPU)")
device = ap.parse_args().device

ref = simulate.random_reference(8_000, seed=1)
index = minimizer_index.build_epoched_index(ref, w=8, k=12, device=device)
rs = simulate.simulate_reads(ref, n_reads=24, read_len=150,
                             profile=simulate.ILLUMINA, seed=2)

config = EngineConfig(buckets=(160, 320), max_batch=8, max_delay_s=0.005,
                      minimizer_w=8, minimizer_k=12)
with ServeEngine(index, config) as engine:
    session = Session(engine)
    for gid, read in enumerate(rs.reads):
        session.submit(read, meta=gid)
    results = session.drain()
    # a resubmitted read is answered from the result cache (epoch-keyed)
    session.submit(rs.reads[0], meta="dup-of-0")
    results += session.drain()
    print(f"align backend: {engine.align_backend} on {engine.device}")
    print("gid        pos   dist  bucket  cached  latency")
    for gid, res in results:
        print(f"{str(gid):<9} {res.position:>5} {res.distance:>6} "
              f"{res.bucket_cap:>7} {str(res.cached):>7} "
              f"{res.latency_s * 1e3:>8.2f} ms")

    correct = sum(abs(res.position - rs.true_pos[gid]) <= 16
                  for gid, res in results if isinstance(gid, int))
    print(f"\nposition-correct: {correct}/{len(rs.reads)}")
    print("--- engine metrics ---")
    print(engine.metrics.render())
