"""The JAX reference's shard results for the port's shard parity tests.

    python tests/torch_shard_reference.py {linear|graph} OUT.npz

Run by tests/test_torch_shard.py and tests/test_torch_shard_graph.py in
a subprocess, once per file.  `repro.shard.merge` imports
``jax.experimental.enable_x64``, which newer JAX releases have moved to
``jax.enable_x64``; this script sets that one name before importing
`repro.shard`.  Doing so in a subprocess keeps `repro.shard` out of the
test process, where the JAX package's own shard tests must keep
importing it as it is.  Run it on one host device (no
``--xla_force_host_platform_device_count`` in ``XLA_FLAGS``): with
several, `repro.shard` takes its ``shard_map`` path, which the installed
JAX rejects.

The script simulates the parity inputs (a 12,000 bp reference, 16
Illumina reads of 100 bp, reads with N inside and reads across the 2-
and 3-shard cuts), runs the reference on them and writes the inputs and
every result into one ``.npz``: numeric arrays under ``"<case>/<field>"``
keys, so the port is held against exactly the bytes the reference saw.
"""
from __future__ import annotations

import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from repro import shard  # noqa: E402  (after the alias)
from repro.core import minimizer_index  # noqa: E402
from repro.core.genasm import GenASMConfig  # noqa: E402
from repro.core.mapper import POS_SENTINEL  # noqa: E402
from repro.genomics import encode, simulate  # noqa: E402
from repro.serve import EngineConfig, ServeEngine  # noqa: E402
from repro.shard import merge as sm  # noqa: E402

W, K = 8, 12
CFG = GenASMConfig()
P_CAP, FILTER_K = 128, 12
KW = dict(cfg=CFG, p_cap=P_CAP, filter_bits=128, filter_k=FILTER_K,
          shard_candidates=4)
# the halo and geometry cases of `required_halo`
HALO_CASES = [(128, 128, 12, 128 + 2 * CFG.w), (160, 128, 11, 160 + 2 * CFG.w),
              (1280, 128, 11, 1280 + 2 * CFG.w), (64, 64, 0, 64)]
LAYOUT_CASES = [(1000, 4, 100), (12_000, 3, 1024), (4_641_652, 2, 1536),
                (7, 7, 0)]


def parity_inputs():
    """(ref, reads [B, 128] int8, lens [B]): 16 simulated reads, two with
    N inside, and three across the cuts of the 2- and 3-shard layouts."""
    ref = simulate.random_reference(12_000, seed=5)
    rs = simulate.simulate_reads(ref, n_reads=16, read_len=100,
                                 profile=simulate.ILLUMINA, seed=6)
    reads = [np.array(r, np.int8) for r in rs.reads]
    reads[0][[10, 50, 90]] = 4  # scattered N
    reads[5][40:45] = 4  # an N run
    for start in (5950, 3960, 7990):  # across 6000, 4000, 8000
        reads.append(np.array(ref[start: start + 100], np.int8))
    reads[-2][[20, 70]] = (reads[-2][[20, 70]] + 1) % 4
    arr, lens = encode.batch_reads(reads, P_CAP)
    return ref, arr, lens


def put(out: dict, case: str, tree) -> None:
    for name in tree._fields:
        out[f"{case}/{name}"] = np.asarray(getattr(tree, name))


def linear_stage(s, b, rng):
    """Stage outputs with engineered ties at every level (the reference's
    differential suite's generator, seeded)."""
    d = rng.integers(0, FILTER_K + 2, size=(s, b)).astype(np.int32)
    pos = rng.integers(0, 5000, size=(s, b)).astype(np.int32)
    ties = rng.random(b) < 0.4
    d[:, ties] = d[0, ties]
    full = rng.random(b) < 0.25
    d[:, full] = d[0, full]
    pos[:, full] = pos[0, full]
    none = rng.random((s, b)) < 0.3
    d[none] = FILTER_K + 1
    pos[none] = POS_SENTINEL
    d[:, 0] = FILTER_K + 1
    pos[:, 0] = POS_SENTINEL
    text = rng.integers(0, 4, size=(s, b, 16)).astype(np.int8)
    t_len = rng.integers(1, 17, size=(s, b)).astype(np.int32)
    return shard.mapper.ShardStageResult(distance=d, position=pos, text=text,
                                         t_len=t_len)


def graph_stage(s, b, rng):
    """Graph stage outputs with ties at every lexicographic level, dead
    candidates (sentinel origin and tile together) and distances on both
    sides of 2048."""
    from repro.graph import mapper as graph_mapper

    d = rng.choice(np.array([0, 3, 2047, 2048, 2049, 4094], np.int32),
                   size=(s, b))
    origin = rng.integers(0, 4000, size=(s, b)).astype(np.int32)
    tile = rng.integers(0, 2000, size=(s, b)).astype(np.int32)
    t1 = rng.random(b) < 0.4
    d[:, t1] = d[0, t1]
    t2 = rng.random(b) < 0.3
    d[:, t2] = d[0, t2]
    origin[:, t2] = origin[0, t2]
    t3 = rng.random(b) < 0.2
    d[:, t3] = d[0, t3]
    origin[:, t3] = origin[0, t3]
    tile[:, t3] = tile[0, t3]
    dead = rng.random((s, b)) < 0.3
    d[dead] = 4094
    origin[dead] = POS_SENTINEL
    tile[dead] = POS_SENTINEL
    d[:, 0] = 4094
    origin[:, 0] = POS_SENTINEL
    tile[:, 0] = POS_SENTINEL
    return graph_mapper.CandidateStageResult(
        distance=d, origin=origin, tile=tile,
        gwin=rng.integers(0, 2 ** 31, size=(s, b, 8)).astype(np.uint32),
        bwin=rng.integers(-1, 9000, size=(s, b, 8)).astype(np.int32),
        t_len=rng.integers(1, 9, size=(s, b)).astype(np.int32),
        prefilter_ok=rng.random((s, b)) < 0.5)


def merge_cases(out: dict, workload: str) -> None:
    """Synthetic merges (ties, dead columns, graph distances >= 2048) and
    the packed keys of the field-boundary grids."""
    names = ("fd", "pos", "text", "t_len", "win")
    for s in (1, 2, 3, 4):
        if workload == "linear":
            st = linear_stage(s, 24, np.random.default_rng(40 + s))
            put(out, f"tie{s}/in", st)
            for name, v in zip(names,
                               shard.ShardedMapExecutor.merge_host(st)):
                out[f"tie{s}/host_{name}"] = np.asarray(v)
            with sm.x64_scope():
                dev = jax.jit(sm.merge_linear)(*[jnp.asarray(x) for x in st])
            for name, v in zip(names, dev):
                out[f"tie{s}/dev_{name}"] = np.asarray(v)
        else:
            st = graph_stage(s, 24, np.random.default_rng(60 + s))
            put(out, f"tie{s}/in", st)
            put(out, f"tie{s}/host",
                shard.ShardedGraphMapExecutor.merge_host(st))
            with sm.x64_scope():
                dev = jax.jit(sm.merge_graph)(*[jnp.asarray(x) for x in st])
            put(out, f"tie{s}/dev", type(st)(*dev[:-1]))
            out[f"tie{s}/dev_win"] = np.asarray(dev[-1])
    if workload == "linear":
        ds = [0, 1, 13, 2 ** 31 - 2, 2 ** 31 - 1]
        ps = [0, 1, POS_SENTINEL - 1, POS_SENTINEL]
        grid = np.array([(d, p) for d in ds for p in ps], np.int64)
        out["keys/in"] = grid
        out["keys/packed"] = sm.pack_linear_key(
            grid[:, 0].astype(np.int32), grid[:, 1].astype(np.int32))
    else:
        ds = [0, 1, 2047, 2048, 2049, 4094, sm.GRAPH_D_MAX]
        os_ = [0, 1, POS_SENTINEL - 1, POS_SENTINEL]
        ts = [0, 1, sm.GRAPH_TILE_MAX - 1, POS_SENTINEL]
        grid = np.array([(d, o, t) for d in ds for o in os_ for t in ts],
                        np.int64)
        out["keys/in"] = grid
        out["keys/packed"] = sm.pack_graph_key(
            *(grid[:, i].astype(np.int32) for i in range(3)))


def engine_results(out: dict, case: str, index, reads, **cfg) -> None:
    base = dict(buckets=(P_CAP,), max_batch=4, filter_k=FILTER_K,
                minimizer_w=W, minimizer_k=K)
    with ServeEngine(index, EngineConfig(**base, **cfg)) as eng:
        res = eng.map_all(reads)
    out[f"{case}/position"] = np.array([r.position for r in res])
    out[f"{case}/distance"] = np.array([r.distance for r in res])
    out[f"{case}/n_ops"] = np.array([r.n_ops for r in res])
    out[f"{case}/ops"] = np.stack([r.ops for r in res])
    if res[0].path is not None:
        out[f"{case}/path"] = np.stack([r.path for r in res])


def lose(shard_id: int, log: list):
    def hook(i, attempt):
        if i == shard_id and attempt == 1:
            log.append(i)
            raise RuntimeError("simulated device loss")
    return hook


def linear(out: dict, ref, arr, lens) -> None:
    epi = minimizer_index.build_epoched_index(ref, w=W, k=K)
    out["index/hashes"] = np.asarray(epi.index.hashes)
    out["index/positions"] = np.asarray(epi.index.positions)
    out["halo/cases"] = np.array(HALO_CASES)
    out["halo/need"] = np.array([shard.required_halo(
        p_cap=p, filter_bits=f, filter_k=k, t_cap=t)
        for p, f, k, t in HALO_CASES])
    for i, (n, s, h) in enumerate(LAYOUT_CASES):
        lay = shard.plan_layout(n, s, h)
        out[f"layout{i}/bounds"] = np.array(lay.bounds)
        out[f"layout{i}/slices"] = np.array(
            [lay.slice_range(j) for j in range(s)])
    put(out, "part3", shard.from_epoched(epi, 3).index.arrays)

    kw = dict(KW, backend="lax")
    for s in (1, 2, 3):
        esi = shard.from_epoched(epi, s)
        put(out, f"map{s}", shard.map_batch_sharded(esi.index, arr, lens,
                                                    **kw))
        if s == 1:
            continue
        ex = shard.get_executor(esi.index, **kw)
        st = ex.stage(esi.index.arrays, arr, lens)
        put(out, f"stage{s}", st)
        host = ex.merge_host(st)
        for name, v in zip(("fd", "pos", "text", "t_len", "win"), host):
            out[f"merge{s}/{name}"] = np.asarray(v)
        put(out, f"map{s}_as", shard.map_batch_sharded(
            esi.index, arr, lens, align_sharded=True, **kw))
        put(out, f"map{s}_pl", shard.map_batch_sharded(
            esi.index, arr, lens, align_sharded=s == 3, pipelined=True,
            **kw))

    esi = shard.from_epoched(epi, 2)
    _, t0 = esi.current()
    t1 = esi.refresh_shard(1)
    t2 = esi.refresh(ref)
    out["epochs/tokens"] = np.array([t0[1], t1[1], t2[1]])

    esi = shard.from_epoched(epi, 3)
    put(out, "fail_clean", shard.map_batch_with_failover(esi, arr, lens,
                                                         **kw))
    log: list = []
    esi = shard.from_epoched(epi, 3)
    put(out, "fail_lost", shard.map_batch_with_failover(
        esi, arr, lens, fault_hook=lose(1, log), **kw))
    out["fail_lost/epochs"] = np.array(esi.epochs)
    out["fail_lost/failures"] = np.array(log)
    log = []
    esi = shard.from_epoched(epi, 3)
    put(out, "fail_align", shard.map_batch_with_failover(
        esi, arr, lens, pipelined=True, align_fault_hook=lose(1, log), **kw))
    out["fail_align/epochs"] = np.array(esi.epochs)
    out["fail_align/failures"] = np.array(log)

    reads = [arr[i, :lens[i]] for i in range(len(lens))]
    engine_results(out, "engine1", epi, reads, align_backend="lax")
    engine_results(out, "engine2", epi, reads, align_backend="lax",
                   num_shards=2)
    engine_results(out, "engine3_pl", epi, reads, align_backend="lax",
                   num_shards=3, align_sharded=True, pipelined=True)


def graph(out: dict, ref, arr, lens) -> None:
    from repro.graph import index as graph_index
    from repro.graph.mapper import tile_rung

    variants = simulate.simulate_variants(ref, n_snp=20, n_ins=10, n_del=10,
                                          seed=7)
    gidx = graph_index.build_graph_index(ref, variants, w=W, k=K,
                                         window=P_CAP + 2 * CFG.w)
    out["graph/n_tiles"] = np.array(gidx.arrays.tile_gtext.shape[0])
    put(out, "gpart3", shard.from_epoched_graph(gidx, 3).index.arrays)

    kw = dict(KW, backend="graph_lax")
    for s in (1, 2, 3):
        esi = shard.from_epoched_graph(gidx, s)
        put(out, f"gmap{s}", shard.map_batch_sharded_graph(
            esi.index, arr, lens, **kw))
        if s == 1:
            continue
        ex = shard.get_graph_executor(esi.index, **kw)
        a = esi.index.arrays
        pf = ex._pf(*a, jnp.asarray(arr), jnp.asarray(lens, jnp.int32))
        n_keep = np.asarray(pf.n_keep)
        n_cap = tile_rung(int(n_keep.sum(axis=1).max()), len(lens) * 4)
        out[f"gstage{s}/n_keep"] = n_keep
        out[f"gstage{s}/n_cap"] = np.array(n_cap)
        st = ex._stage_for(n_cap)(*a, jnp.asarray(arr),
                                  jnp.asarray(lens, jnp.int32), pf)
        put(out, f"gstage{s}", st)
        put(out, f"gmerge{s}", ex.merge_host(st))
        put(out, f"gmap{s}_as", shard.map_batch_sharded_graph(
            esi.index, arr, lens, align_sharded=True, **kw))
        put(out, f"gmap{s}_pl", shard.map_batch_sharded_graph(
            esi.index, arr, lens, align_sharded=s == 3, pipelined=True,
            **kw))

    esi = shard.from_epoched_graph(gidx, 2)
    _, t0 = esi.current()
    t1 = esi.refresh_shard(0)
    out["gepochs/tokens"] = np.array([t0[1], t1[1]])

    esi = shard.from_epoched_graph(gidx, 3)
    put(out, "gfail_clean", shard.map_batch_with_failover_graph(
        esi, arr, lens, **kw))
    log: list = []
    esi = shard.from_epoched_graph(gidx, 3)
    put(out, "gfail_lost", shard.map_batch_with_failover_graph(
        esi, arr, lens, pipelined=True, fault_hook=lose(0, log),
        align_fault_hook=lose(1, log), **kw))
    out["gfail_lost/epochs"] = np.array(esi.epochs)
    out["gfail_lost/failures"] = np.array(log)

    epi = graph_index.EpochedGraphIndex(gidx)
    reads = [arr[i, :lens[i]] for i in range(len(lens))]
    engine_results(out, "gengine1", epi, reads, align_backend="graph_lax",
                   workload="graph")
    engine_results(out, "gengine2_pl", epi, reads, align_backend="graph_lax",
                   workload="graph", num_shards=2, align_sharded=True,
                   pipelined=True)


def main(argv) -> None:
    workload, path = argv
    ref, arr, lens = parity_inputs()
    out = {"in/ref": ref, "in/reads": arr, "in/lens": lens}
    merge_cases(out, workload)
    {"linear": linear, "graph": graph}[workload](out, ref, arr, lens)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
