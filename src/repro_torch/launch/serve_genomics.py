"""Read-mapping service driver (the paper's workload, end to end).

Port of `repro.launch.serve_genomics`.  ``--mode linear``
maps against a linear reference and emits PAF; ``--mode graph`` builds a
variation-graph index (``--variants``, default ``ref_len // 200``
simulated variants) and emits GAF (node path + CIGAR) through the
``graph_torch``/``graph_cuda`` backends.  Both serving modes sit on the
same `repro_torch.serve` micro-batching engine, so they produce
identical output for the same read set:

* **offline** (default) — drain a fixed read set through the lease-based
  work queue; each claimed quantum's reads are submitted to the engine.
* **``--online``** — synthetic open-loop Poisson arrivals through the
  engine's admission queue, reporting reads/s and tail latency.

``--num-shards N`` partitions the reference index into N shards
(`repro_torch.shard` scatter/merge; DESIGN.md §11) with byte-identical
output; ``--align-sharded`` cuts the align stage into per-shard blocks
and ``--pipelined`` keeps one flush in flight.

``--trace-out`` traces every flush (Perfetto JSON, the per-stage
Amdahl table and one roofline line per align site on exit) and
``--http-port`` serves ``/metrics /healthz /trace /attrib /roofline``
while the engine runs (`repro_torch.obs`).

``--device`` (default ``cuda``) picks where the index, the mapper and
the kernels run: one device for every shard, or a comma-separated list
of one device per shard (a bare ``cuda`` spreads the shards over the
visible cards when there are enough).  With ``cuda`` and no visible GPU
the driver raises; it never carries on on the CPU.  Pass ``--device
cpu`` to run the plain PyTorch versions on the CPU.

    python -m repro_torch.launch.serve_genomics --reads 64 --out out.paf
    python -m repro_torch.launch.serve_genomics --mode graph --out out.gaf
    python -m repro_torch.launch.serve_genomics --num-shards 2 --pipelined
    python -m repro_torch.launch.serve_genomics --trace-out t.json --http-port 0
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np

from repro_torch.core import minimizer_index
from repro_torch.core.genasm import GenASMConfig
from repro_torch.dist.fault import WorkQueue
from repro_torch.genomics import io, simulate
from repro_torch.graph import index as graph_index
from repro_torch.obs import (DeviceSpec, ObsServer, RooflineManager, Tracer,
                             build_ledger, render_report)
from repro_torch.serve import (EngineConfig, Metrics, ServeEngine, Session,
                               poisson_load)
from repro_torch.shard import resolve_devices


def paf_row(gid: int, res, ref_len: int) -> dict:
    """PAF row dict for one mapped read.

    Carries the global read id in ``"gid"`` (not a PAF column — strip via
    `strip_gids` before `io.write_paf`).
    """
    L = res.read_len
    return {
        "gid": gid,
        "qname": f"read{gid}", "qlen": L, "qstart": 0,
        "qend": L, "strand": "+", "tname": "ref",
        "tlen": ref_len, "tstart": res.position,
        "tend": res.position + L, "nmatch": L - res.distance,
        "alnlen": L, "mapq": 60,
        "cigar": io.cigar_string(res.ops, res.n_ops),
    }


def gaf_row(gid: int, res) -> dict:
    """GAF row dict for one graph-mapped read (node path + CIGAR).

    ``"tstart"`` (backbone coordinate of the first aligned node) rides
    along for position accounting — neither writer emits it.
    """
    L = res.read_len
    pstr, plen = io.gaf_path(res.path if res.path is not None else ())
    return {
        "gid": gid,
        "qname": f"read{gid}", "qlen": L, "qstart": 0,
        "qend": L, "strand": "+", "path": pstr,
        "plen": plen, "pstart": 0, "pend": plen,
        "nmatch": L - res.distance, "alnlen": int(res.n_ops), "mapq": 60,
        "tstart": res.position,
        "cigar": io.cigar_string(res.ops, res.n_ops),
    }


def strip_gids(rows: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "gid"} for r in rows]


def run_offline(engine: ServeEngine, reads, read_ids, *, batch: int,
                lease_s: float, row_fn) -> list[dict]:
    """Work-queue path: claim a quantum of read ids, submit it, complete."""
    quanta = [read_ids[i: i + batch] for i in range(0, len(read_ids), batch)]
    q = WorkQueue(len(quanta), lease_s=lease_s)
    rows: dict[int, dict] = {}  # keyed by gid: stolen twins overwrite, not dup
    while True:
        b = q.claim()
        if b is None:
            if q.finished:
                break
            time.sleep(0.01)  # all leases live; back off and retry
            continue
        sess = Session(engine)
        for gid in quanta[b]:
            sess.submit(reads[gid], meta=int(gid))
        for gid, res in sess.drain():
            if res.position >= 0:
                rows[gid] = row_fn(gid, res)
        q.complete(b)
    return [rows[g] for g in sorted(rows)]


def run_online(engine: ServeEngine, reads, read_ids, *, rate_rps: float,
               seed: int, row_fn):
    """Poisson open-loop path through the engine's admission queue."""
    rep = poisson_load(engine, [reads[g] for g in read_ids],
                       rate_rps=rate_rps, seed=seed,
                       metas=[int(g) for g in read_ids])
    rows = [row_fn(gid, res) for gid, res in rep.results
            if res.position >= 0]
    return sorted(rows, key=lambda r: r["gid"]), rep


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-len", type=int, default=20_000)
    ap.add_argument("--reads", type=int, default=64)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--profile", default="illumina",
                    choices=list(simulate.PROFILES))
    ap.add_argument("--out", default=None, help="PAF/GAF output path")
    ap.add_argument("--lease-s", type=float, default=600.0,
                    help="work-queue lease; expired leases are stolen")
    ap.add_argument("--mode", default="linear", choices=("linear", "graph"),
                    help="linear reference → PAF, or variation graph → GAF")
    ap.add_argument("--variants", type=int, default=None,
                    help="--mode graph: simulated variant count "
                         "(default max(ref_len // 200, 4))")
    ap.add_argument("--align-backend", default="auto",
                    help="repro_torch.align backend: auto|ref|torch|cuda_dc|"
                         "cuda_dc_v2|graph_torch|graph_cuda (auto = cuda_dc "
                         "on a CUDA device, torch on the CPU, graph twins "
                         "under --mode graph; env REPRO_ALIGN_BACKEND "
                         "overrides auto)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="deprecated alias for --align-backend cuda_dc")
    ap.add_argument("--num-shards", type=int, default=1,
                    help="shard the reference index N ways (repro_torch.shard "
                         "scatter/merge, one device per shard when --device "
                         "lists them, else all on one device); PAF/GAF is "
                         "byte-identical to --num-shards 1")
    ap.add_argument("--align-sharded", action="store_true",
                    help="with --num-shards > 1: cut the winning-window align "
                         "stage into per-shard blocks (byte-identical output)")
    ap.add_argument("--pipelined", action="store_true",
                    help="with --num-shards > 1: keep one flush in flight — "
                         "dispatch flush i+1 before finishing flush i "
                         "(byte-identical output)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the index, mapper and kernels "
                         "(cuda, cuda:N or cpu), or one per shard, "
                         "comma-separated")
    ap.add_argument("--online", action="store_true",
                    help="open-loop Poisson arrivals instead of the "
                         "offline work-queue drain")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="--online arrival rate (reads/s)")
    ap.add_argument("--buckets", default="160,320,640,1280",
                    help="length-bucket ladder of pattern caps")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="micro-batch flush deadline")
    ap.add_argument("--trace-out", default=None,
                    help="trace every flush and write Perfetto/Chrome "
                         "trace_event JSON here (plus the per-stage "
                         "Amdahl table on exit)")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve /metrics /healthz /trace /attrib /roofline "
                         "on this port while running (0 = ephemeral)")
    args = ap.parse_args(argv)
    if args.use_kernel and args.align_backend != "auto":
        ap.error("--use-kernel is a deprecated alias for --align-backend "
                 "cuda_dc; don't combine it with an explicit "
                 "--align-backend")
    return args


class Service(NamedTuple):
    """What `setup` builds from the arguments: data, index and engine config."""

    ref_len: int
    reads: list  # simulated reads, int8 base ids
    true_pos: np.ndarray
    index: object  # EpochedIndex (linear) or EpochedGraphIndex (graph)
    config: EngineConfig
    index_s: float  # seconds to build the index (graph included)
    variants: int | None  # simulated variants of the graph (None: linear)

    def row_fn(self, gid: int, res) -> dict:
        """The output row of one mapped read: GAF or PAF."""
        if self.config.workload == "graph":
            return gaf_row(gid, res)
        return paf_row(gid, res, self.ref_len)


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The engine configuration that the arguments ask for."""
    prof = simulate.PROFILES[args.profile]
    buckets = tuple(int(b) for b in args.buckets.split(","))
    need = ((args.read_len + 63) // 64) * 64 + 64  # offline driver's old cap
    if max(buckets) < need:  # never trim reads the single-cap path held
        buckets += (need,)
    return EngineConfig(
        buckets=buckets, max_batch=args.batch,
        max_delay_s=args.max_delay_ms / 1e3,
        genasm=GenASMConfig(),
        align_backend="cuda_dc" if args.use_kernel else args.align_backend,
        workload=args.mode,
        filter_k=max(8, int(args.read_len * prof.error_rate * 1.5)),
        num_shards=args.num_shards,
        align_sharded=args.align_sharded,
        pipelined=args.pipelined,
        minimizer_w=8, minimizer_k=12)


# engine fields that a `serve` run may set apart from its `setup`: nothing
# in the index or the simulated reads depends on them (the engine shards
# the one-device index itself)
PER_RUN_FIELDS = ("max_batch", "max_delay_s", "align_backend", "num_shards",
                  "align_sharded", "pipelined")


def variant_count(args: argparse.Namespace) -> int | None:
    """Simulated variants of the ``--mode graph`` reference (None: linear)."""
    if args.mode != "graph":
        return None
    return (args.variants if args.variants is not None
            else max(args.ref_len // 200, 4))


def setup(args: argparse.Namespace) -> Service:
    """Simulate the reference and reads from their seeds, index the
    reference on (the first device of) ``--device`` and derive the engine
    configuration."""
    device = resolve_devices(args.device, args.num_shards)[0]
    prof = simulate.PROFILES[args.profile]
    ref = simulate.random_reference(args.ref_len, seed=1)
    rs = simulate.simulate_reads(ref, n_reads=args.reads,
                                 read_len=args.read_len, profile=prof, seed=2)
    cfg = engine_config(args)
    t0 = time.perf_counter()
    n_var = variant_count(args)
    if n_var is not None:
        variants = simulate.simulate_variants(
            ref, n_snp=n_var // 2, n_ins=n_var // 4, n_del=n_var // 4, seed=3)
        print(f"indexing variation graph ({args.ref_len} bp backbone, "
              f"{len(variants)} variants) on {device}...")
        epi = graph_index.build_epoched_graph_index(
            ref, variants, w=8, k=12, device=device,
            window=max(cfg.buckets) + 2 * cfg.genasm.w)  # largest t_cap
    else:
        print(f"indexing reference ({args.ref_len} bp) on {device}...")
        epi = minimizer_index.build_epoched_index(ref, w=8, k=12,
                                                  device=device)
    index_s = time.perf_counter() - t0
    return Service(args.ref_len, rs.reads, rs.true_pos, epi, cfg, index_s,
                   n_var)


def main(argv=None) -> dict:
    """Run the service; returns a summary (rows, throughput, metrics)."""
    args = parse_args(argv)
    return serve(setup(args), args)


def serve(svc: Service, args: argparse.Namespace, *,
          tracer: Tracer | None = None,
          roofline: RooflineManager | None = None,
          metrics: Metrics | None = None) -> dict:
    """Serve the first ``args.reads`` reads of ``svc`` offline or online
    (``args.online``) and write ``args.out``; returns a summary.  One
    `setup` can serve several runs: a smaller ``--reads`` serves the
    setup's first reads (not the reads a setup of that size simulates:
    every read's errors are drawn after all the positions).

    The engine runs with the configuration that ``args`` ask for.  They
    may differ from ``svc``'s in `PER_RUN_FIELDS` only, and raise
    otherwise (the reference and its variants are ``svc``'s too).

    ``tracer``, ``roofline`` and ``metrics`` go to the engine; with
    ``--trace-out`` or ``--http-port`` and none given, the run makes its
    own tracer and roofline manager.  The summary's ``attrib`` is the
    Amdahl report and ``roofline`` the roofline table (without a new
    profiled run), when traced."""
    cfg = engine_config(args)
    kept = {f: getattr(svc.config, f) for f in PER_RUN_FIELDS}
    if (dataclasses.replace(cfg, **kept) != svc.config
            or (args.ref_len, variant_count(args))
            != (svc.ref_len, svc.variants)):
        raise ValueError(f"these arguments need their own setup(): a serve "
                         f"run may change only {PER_RUN_FIELDS}")
    row_fn = svc.row_fn
    read_ids = np.arange(args.reads)
    rep = None
    devices = resolve_devices(args.device, args.num_shards)
    if args.trace_out or args.http_port is not None:
        tracer = tracer if tracer is not None else Tracer()
        if roofline is None:
            roofline = RooflineManager(spec=DeviceSpec.for_device(devices[0]),
                                       device=devices[0], tracer=tracer)
    with contextlib.ExitStack() as stack:
        engine = stack.enter_context(ServeEngine(
            svc.index, cfg, metrics=metrics, tracer=tracer, roofline=roofline,
            shard_devices=devices))
        if roofline is not None:
            roofline.metrics = engine.metrics
        if args.http_port is not None:
            obs = stack.enter_context(ObsServer(
                metrics=engine.metrics, tracer=tracer, roofline=roofline,
                port=args.http_port))
            print(f"obs endpoints at {obs.url} "
                  f"(/metrics /healthz /trace /attrib /roofline)")
        print(f"align backend: {engine.align_backend}")
        t0 = time.time()
        if args.online:
            rows, rep = run_online(engine, svc.reads, read_ids,
                                   rate_rps=args.rate, seed=7, row_fn=row_fn)
            print(f"online: {rep.reads_per_s:.1f} reads/s, "
                  f"p50 {rep.p50_ms:.1f} ms, p99 {rep.p99_ms:.1f} ms")
        else:
            rows = run_offline(engine, svc.reads, read_ids, batch=args.batch,
                               lease_s=args.lease_s, row_fn=row_fn)
        dt = time.time() - t0
        m = engine.metrics.snapshot()
        hit_rate = engine.cache.hit_rate
        backend = engine.align_backend

    attrib = roof = None
    if tracer is not None:
        report = build_ledger(tracer.log).report()
        attrib = report.to_dict()
        print(render_report(report))
    if roofline is not None:
        # measure=False: no profiled kernel run at shutdown
        roof = roofline.report(measure=False)
        for row in roof["kernels"]:
            print(f"roofline {row['kernel']}: "
                  f"{row['achieved_ops_per_s'] / 1e9:.2f} Gop/s, "
                  f"intensity {row['intensity']:.2f} op/B, "
                  f"{row['pct_of_roof']:.2%} of roof")
    if args.trace_out:
        tracer.log.export_chrome(args.trace_out)
        print(f"wrote {args.trace_out}")

    mapped = len(rows)
    correct = sum(
        1 for r in rows if abs(r["tstart"] - svc.true_pos[r["gid"]]) <= 16)
    occ = m.get("batch_occupancy_mean", 0.0)
    useful = m.get("bases_useful", 0.0)
    waste = m.get("bases_padded_read", 0.0)
    print(f"mapped {mapped}/{len(read_ids)} reads in {dt:.2f}s "
          f"({len(read_ids) / dt if dt else 0.0:.1f} reads/s); "
          f"position-correct: {correct}/{mapped}")
    print(f"batch occupancy {occ:.2f}, padded-base waste "
          f"{waste / max(useful + waste, 1):.1%}, "
          f"cache hit rate {hit_rate:.1%}")
    if args.out:
        writer = (io.write_gaf if svc.config.workload == "graph"
                  else io.write_paf)
        writer(args.out, strip_gids(rows))
        print(f"wrote {args.out}")
    return {
        "rows": rows, "reads": len(read_ids), "mapped": mapped,
        "correct": correct, "seconds": dt,
        "reads_per_s": len(read_ids) / dt if dt else 0.0,
        "p50_ms": rep.p50_ms if rep else None,
        "p99_ms": rep.p99_ms if rep else None,
        "align_backend": backend, "metrics": m, "index_s": svc.index_s,
        "attrib": attrib, "roofline": roof,
    }


if __name__ == "__main__":
    main()
