"""Port parity: `repro_torch.shard`'s linear half against `repro.shard`.

The reference side runs once, in a subprocess
(tests/torch_shard_reference.py), and writes its inputs and results to
an ``.npz``; `repro.shard` is never imported in this process.  Inputs:
a 12,000 bp reference, 16 Illumina reads of 100 bp, two of them with N
inside, and three reads across the cuts of the 2- and 3-shard layouts.
Every comparison is exact.  Both merges are held against each other and
against the reference on the mapper's stage outputs and on synthetic
stages with engineered ties; the mappers at 1, 2 and 3 shards, with the
align stage split and pipelined, the failover driver with a lost shard,
and the engine sharded and pipelined against the reference's results.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import shard
from repro_torch.core import mapper as core_mapper
from repro_torch.core import minimizer_index
from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.mapper import POS_SENTINEL
from repro_torch.serve import EngineConfig, ResultCache, ServeEngine
from repro_torch.shard import merge as sm
from repro_torch.shard.mapper import ShardStageResult

ROOT = pathlib.Path(__file__).resolve().parents[1]
W, K = 8, 12
CFG = GenASMConfig()
KW = dict(cfg=CFG, p_cap=128, filter_bits=128, filter_k=12,
          shard_candidates=4)


def run_reference(workload: str, out: pathlib.Path) -> dict:
    """The reference's results for ``workload``, from a subprocess on one
    host device.  Test modules that share the worker set ``XLA_FLAGS`` to
    force several host devices; with them `repro.shard` takes its
    ``shard_map`` path, which the installed JAX rejects (a scan carry's
    varying axes), so the subprocess does not inherit them and runs the
    stacked ``vmap`` path, which the reference holds bit-identical."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_shard_reference.py"),
         workload, str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={**env, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ref_npz(tmp_path_factory):
    return run_reference("linear", tmp_path_factory.mktemp("ref") / "lin.npz")


@pytest.fixture(scope="module")
def epi(ref_npz):
    return minimizer_index.build_epoched_index(ref_npz["in/ref"], w=W, k=K,
                                              device="cpu")


def inputs(ref_npz):
    return ref_npz["in/reads"], ref_npz["in/lens"]


def assert_tree_equal(got, ref_npz, case: str):
    """Every field of a result NamedTuple equal to the reference's."""
    for name in got._fields:
        want = ref_npz[f"{case}/{name}"]
        g = getattr(got, name)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, want, err_msg=f"{case}/{name}")


def test_index_is_the_reference_index(ref_npz, epi):
    np.testing.assert_array_equal(epi.index.hashes.numpy(),
                                  ref_npz["index/hashes"])
    np.testing.assert_array_equal(epi.index.positions.numpy(),
                                  ref_npz["index/positions"])


@pytest.mark.parametrize("case", range(4))
def test_plan_layout_matches_reference(ref_npz, case):
    n, s, h = [(1000, 4, 100), (12_000, 3, 1024), (4_641_652, 2, 1536),
               (7, 7, 0)][case]
    lay = shard.plan_layout(n, s, h)
    np.testing.assert_array_equal(lay.bounds, ref_npz[f"layout{case}/bounds"])
    np.testing.assert_array_equal([lay.slice_range(i) for i in range(s)],
                                  ref_npz[f"layout{case}/slices"])
    assert all(lay.shard_of(lo) == i for i, (lo, _) in
               enumerate(lay.core(j) for j in range(s)))


def test_plan_layout_rejects_bad_input():
    with pytest.raises(ValueError):
        shard.plan_layout(1000, 0)
    with pytest.raises(ValueError):
        shard.plan_layout(3, 8)  # empty core ranges
    with pytest.raises(ValueError):
        shard.plan_layout(1000, 2, halo=-1)


def test_partition_matches_reference(ref_npz, epi):
    """Bytes, offsets and the ownership-split table, field for field."""
    esi = shard.from_epoched(epi, 3)
    assert_tree_equal(esi.index.arrays, ref_npz, "part3")
    a = esi.index.arrays
    assert a.hashes.dtype == torch.int64  # the pad hash sorts last
    n_real = int((a.positions < 2 ** 30).sum())
    assert n_real == len(ref_npz["index/positions"])  # each entry once


def test_placement_one_block_per_shard(ref_npz, epi):
    """One device per shard (here three CPU entries) places one one-row
    block per shard; the stack, each row and the results are those of
    the one-block placement."""
    one = shard.from_epoched(epi, 3).index
    per = shard.from_epoched(epi, 3, devices=["cpu"] * 3).index
    assert len(one.parts) == 1 and len(per.parts) == 3
    for f in one.arrays._fields:
        assert torch.equal(getattr(one.arrays, f), getattr(per.arrays, f))
        for i in range(3):
            assert torch.equal(getattr(one.row(i), f), getattr(per.row(i), f))
    reads, lens = inputs(ref_npz)
    got = shard.map_batch_sharded(per, reads, lens, align_sharded=True,
                                  backend="torch", **KW)
    assert_tree_equal(got, ref_npz, "map3_as")


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert shard.resolve_devices("cpu", 3) == (cpu,)
    assert shard.resolve_devices("cpu, cpu", 2) == (cpu, cpu)
    with pytest.raises(ValueError, match="3 shards"):
        shard.resolve_devices("cpu,cpu", 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard.resolve_devices("cuda", 2)


def test_required_halo_validation(ref_npz, epi):
    got = [shard.required_halo(p_cap=p, filter_bits=f, filter_k=k, t_cap=t)
           for p, f, k, t in ref_npz["halo/cases"]]
    np.testing.assert_array_equal(got, ref_npz["halo/need"])
    geom = dict(p_cap=128, filter_bits=128, filter_k=12,
                t_cap=128 + 2 * CFG.w)
    need = shard.required_halo(**geom)
    with pytest.raises(ValueError, match="halo"):
        shard.validate_geometry(shard.from_epoched(epi, 2, halo=64).index,
                                **geom)
    shard.validate_geometry(shard.from_epoched(epi, 2, halo=need).index,
                            **geom)


def test_epoch_vector_tokens(ref_npz, epi):
    esi = shard.from_epoched(epi, 2)
    _, t0 = esi.current()
    t1 = esi.refresh_shard(1)
    t2 = esi.refresh(ref_npz["in/ref"])
    np.testing.assert_array_equal([t0[1], t1[1], t2[1]],
                                  ref_npz["epochs/tokens"])
    assert len({t0, t1, t2}) == 3  # every refresh is a distinct cache key
    with pytest.raises(IndexError):
        esi.refresh_shard(2)


def test_epoch_vector_prevents_scalar_collision(epi):
    """After refresh_shard(0) on one handle and refresh_shard(1) on
    another, scalar summaries of the epochs collide; the (layout, epoch
    vector) token does not, so the cache never crosses states."""
    a, b = shard.from_epoched(epi, 2), shard.from_epoched(epi, 2)
    a.refresh_shard(0)
    b.refresh_shard(1)
    tok_a, tok_b = a.epoch_token(), b.epoch_token()
    assert sum(tok_a[1]) == sum(tok_b[1]) == 1
    assert tok_a != tok_b
    cache = ResultCache(capacity=8)
    read = np.zeros(8, np.int8)
    cache.put(read, tok_a, "mapped-against-A")
    assert cache.get(read, tok_b) is None
    assert cache.get(read, tok_a) == "mapped-against-A"


def test_refresh_shard_rematerializes_identically(ref_npz, epi):
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched(epi, 2)
    before = esi.index
    esi.refresh_shard(0)
    assert esi.index is not before
    for f in before.arrays._fields:
        assert torch.equal(getattr(before.arrays, f),
                           getattr(esi.index.arrays, f))
    got = shard.map_batch_sharded(esi.index, reads, lens, backend="torch",
                                  **KW)
    assert_tree_equal(got, ref_npz, "map2")


def test_linear_key_matches_reference(ref_npz):
    """The packed keys equal the reference's uint64 keys (the linear key
    never sets the top bit) and order the grid as the tuples do."""
    grid = torch.from_numpy(ref_npz["keys/in"])
    key = sm.pack_linear_key(grid[:, 0].to(torch.int32),
                             grid[:, 1].to(torch.int32))
    np.testing.assert_array_equal(key.numpy(),
                                  ref_npz["keys/packed"].astype(np.int64))
    tuples = [tuple(r) for r in grid.tolist()]
    assert sorted(range(len(tuples)), key=tuples.__getitem__) == \
        key.argsort(stable=True).tolist()
    d, p = sm.unpack_linear_key(key)
    assert torch.equal(d.long(), grid[:, 0]) and torch.equal(p.long(),
                                                             grid[:, 1])


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_merge_with_forced_ties(ref_npz, s):
    """Synthetic stages with distance ties, full-key ties (the lowest
    shard wins) and an all-dead column: device merge == host merge ==
    the reference's merges."""
    st = ShardStageResult(*(torch.from_numpy(ref_npz[f"tie{s}/in/{f}"])
                            for f in ShardStageResult._fields))
    dev = shard.ShardedMapExecutor.merge_device(st)
    host = shard.ShardedMapExecutor.merge_host(st)
    for i, name in enumerate(("fd", "pos", "text", "t_len", "win")):
        np.testing.assert_array_equal(dev[i].numpy(), host[i], err_msg=name)
        np.testing.assert_array_equal(host[i], ref_npz[f"tie{s}/host_{name}"])
        np.testing.assert_array_equal(dev[i].numpy(),
                                      ref_npz[f"tie{s}/dev_{name}"])
    if s > 1:
        d, p = st.distance, st.position
        tied = ((d == d[0]) & (p == p[0])).all(0)
        assert tied.any() and (dev[4][tied] == 0).all()  # low shard wins


@pytest.mark.parametrize("s", [2, 3])
def test_stage_and_merge_match_reference(ref_npz, epi, s):
    """The scatter stage's per-shard winners and both merges on them."""
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched(epi, s)
    ex = shard.get_executor(esi.index, backend="torch", **KW)
    st = ex.stage(esi.index.parts, reads, lens)
    assert_tree_equal(st, ref_npz, f"stage{s}")
    host = ex.merge_host(st)
    dev = ex.merge_device(st)
    for i, name in enumerate(("fd", "pos", "text", "t_len", "win")):
        np.testing.assert_array_equal(host[i], ref_npz[f"merge{s}/{name}"])
        np.testing.assert_array_equal(dev[i].numpy(), host[i], err_msg=name)
    # halo duplicates: the reads across a cut win in both neighbours, with
    # the same window bytes
    p = st.position
    dup = (p[1:] == p[:-1]) & (p[1:] != POS_SENTINEL)
    assert dup.any()
    assert torch.equal(st.text[1:][dup], st.text[:-1][dup])


@pytest.mark.parametrize("s,backend", [(1, "torch"), (2, "torch"),
                                       (3, "torch"), (2, "cuda_dc"),
                                       (3, "cuda_dc_v2")])
def test_map_batch_sharded_matches_reference(ref_npz, epi, s, backend):
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched(epi, s)
    got = shard.map_batch_sharded(esi.index, reads, lens, backend=backend,
                                  **KW)
    assert_tree_equal(got, ref_npz, f"map{s}")
    assert (got.position >= 0).sum() >= 17


def test_sharded_equals_single_device_port(ref_npz, epi):
    """The port at 3 shards gives the port's own single-device answer."""
    reads, lens = inputs(ref_npz)
    want = core_mapper.map_batch(epi.index, reads, lens, p_cap=128,
                                 filter_bits=128, filter_k=12,
                                 max_candidates=4, minimizer_w=W,
                                 minimizer_k=K, backend="torch")
    got = shard.map_batch_sharded(shard.from_epoched(epi, 3).index, reads,
                                  lens, backend="torch", **KW)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("mode", ["as", "pl"])
def test_align_sharded_and_pipelined_match_reference(ref_npz, epi, s, mode):
    """``align_sharded`` cuts the winners into [S, B/S] blocks (21 reads:
    a padded last block); ``pipelined`` dispatches through the untimed
    start/finish surface (with the split at 3 shards)."""
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched(epi, s)
    kw = (dict(align_sharded=True) if mode == "as"
          else dict(align_sharded=s == 3, pipelined=True))
    got = shard.map_batch_sharded(esi.index, reads, lens, backend="cuda_dc",
                                  **kw, **KW)
    assert_tree_equal(got, ref_npz, f"map{s}_{mode}")


def test_start_finish_surface(ref_npz, epi):
    """``start`` leaves the result on the device with the align span
    open; ``finish`` closes it and brings the result to the host.  The
    timed call closes scatter, merge_device and align."""
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched(epi, 2)
    ex = shard.get_executor(esi.index, backend="torch", **KW)
    pending = ex.start(esi.index.parts, reads, lens, timed=False)
    assert pending.times == () and pending.tail[0] == "align"
    res, times = ex.finish(pending)
    assert [name for name, *_ in times] == ["align"]
    assert_tree_equal(res, ref_npz, "map2")
    ex(esi.index.parts, reads, lens)
    assert [name for name, *_ in ex.last_times] == ["scatter", "merge_device",
                                                   "align"]
    assert all(t1 >= t0 for _, t0, t1, _ in ex.last_times)


def test_start_does_not_read_the_device(ref_npz, epi, monkeypatch):
    """Between scatter, merge and align dispatch ``start`` reads nothing
    back from its tensors: every read-back path raises while it runs."""
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched(epi, 3)
    ex = shard.get_executor(esi.index, backend="cuda_dc_v2",
                            align_sharded=True, **KW)

    def refuse(*a, **kw):
        raise AssertionError("start read a tensor back to the host")

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "numpy", "__bool__",
                     "__int__", "__index__", "nonzero"):
            m.setattr(torch.Tensor, name, refuse)
        m.setattr(torch, "nonzero", refuse)
        pending = ex.start(esi.index.parts, reads, lens, timed=False)
    res, _ = ex.finish(pending)
    assert_tree_equal(res, ref_npz, "map3_as")


def test_failover_requeues_lost_shard(ref_npz, epi):
    reads, lens = inputs(ref_npz)
    clean = shard.map_batch_with_failover(shard.from_epoched(epi, 3), reads,
                                          lens, backend="torch", **KW)
    assert_tree_equal(clean, ref_npz, "fail_clean")
    failures = []

    def lose_shard_once(i, attempt):
        if i == 1 and attempt == 1:
            failures.append(i)
            raise RuntimeError("simulated device loss")

    esi = shard.from_epoched(epi, 3)
    res = shard.map_batch_with_failover(esi, reads, lens, backend="torch",
                                        fault_hook=lose_shard_once, **KW)
    np.testing.assert_array_equal(failures, ref_npz["fail_lost/failures"])
    np.testing.assert_array_equal(esi.epochs, ref_npz["fail_lost/epochs"])
    assert_tree_equal(res, ref_npz, "fail_lost")
    assert_tree_equal(res, ref_npz, "map3")  # failures change nothing


def test_failover_align_chunk_requeues_in_pipelined_mode(ref_npz, epi):
    """A shard lost between merge and align re-queues its align chunk."""
    reads, lens = inputs(ref_npz)
    failures = []

    def lose_between_merge_and_align(i, attempt):
        if i == 1 and attempt == 1:
            failures.append(i)
            raise RuntimeError("simulated device loss mid-pipeline")

    esi = shard.from_epoched(epi, 3)
    res = shard.map_batch_with_failover(
        esi, reads, lens, backend="cuda_dc_v2", pipelined=True,
        align_fault_hook=lose_between_merge_and_align, **KW)
    np.testing.assert_array_equal(failures, ref_npz["fail_align/failures"])
    np.testing.assert_array_equal(esi.epochs, ref_npz["fail_align/epochs"])
    assert_tree_equal(res, ref_npz, "fail_align")


def test_failover_gives_up_after_max_attempts(ref_npz, epi):
    reads, lens = inputs(ref_npz)

    def always_lose(i, attempt):
        if i == 0:
            raise RuntimeError("persistent loss")

    with pytest.raises(RuntimeError, match="failed 2 times"):
        shard.map_batch_with_failover(shard.from_epoched(epi, 2), reads[:4],
                                      lens[:4], max_attempts=2,
                                      fault_hook=always_lose,
                                      backend="torch", **KW)


def engine_reads(ref_npz):
    reads, lens = inputs(ref_npz)
    return [reads[i, :lens[i]] for i in range(len(lens))]


def assert_engine_equal(results, ref_npz, case):
    for name in ("position", "distance", "n_ops"):
        np.testing.assert_array_equal([getattr(r, name) for r in results],
                                      ref_npz[f"{case}/{name}"], err_msg=name)
    np.testing.assert_array_equal(np.stack([r.ops for r in results]),
                                  ref_npz[f"{case}/ops"])


BASE = dict(buckets=(128,), max_batch=4, filter_k=12, minimizer_w=W,
            minimizer_k=K, align_backend="torch")


def test_engine_sharded_matches_reference(ref_npz, epi):
    reads = engine_reads(ref_npz)
    with ServeEngine(epi, EngineConfig(num_shards=2, **BASE)) as eng:
        got = eng.map_all(reads)
        assert eng.n_executors == 1
        again = eng.map_all(reads)  # the cache, under the epoch token
        assert all(r.cached for r in again)
        _, token = eng.index.current()
        assert token[1] == (0, 0)
    assert_engine_equal(got, ref_npz, "engine2")
    assert_engine_equal(got, ref_npz, "engine1")


def test_engine_pipelined_align_sharded_matches_reference(ref_npz, epi):
    """Per-shard align blocks and one flush in flight (>= 5 flushes, so
    dispatches overlap finishes) on three shards placed one per entry
    of a device list."""
    reads = engine_reads(ref_npz)
    cfg = EngineConfig(num_shards=3, align_sharded=True, pipelined=True,
                       **dict(BASE, align_backend="cuda_dc"))
    with ServeEngine(epi, cfg, shard_devices=["cpu"] * 3) as eng:
        got = eng.map_all(reads)
        assert eng.metrics.counter("batches_flushed").value >= 5
        assert len(eng.index.index.parts) == 3
    assert_engine_equal(got, ref_npz, "engine3_pl")


def test_engine_config_checks(epi):
    with pytest.raises(ValueError, match="num_shards > 1"):
        EngineConfig(pipelined=True)
    with pytest.raises(ValueError, match="num_shards > 1"):
        EngineConfig(align_sharded=True)
    with pytest.raises(ValueError, match="num_shards"):
        EngineConfig(num_shards=0)
    with pytest.raises(ValueError, match="shard_candidates"):
        EngineConfig(num_shards=2, shard_candidates=0)
    esi = shard.from_epoched(epi, 3)
    with pytest.raises(ValueError, match="sharded 3 ways"):
        ServeEngine(esi, EngineConfig(num_shards=2, **BASE))
    with pytest.raises(TypeError, match="epoched sharded index"):
        ServeEngine(esi.index, EngineConfig(num_shards=3, **BASE))


def test_positions_never_reach_the_sentinel(ref_npz, epi):
    """Every shard's stage answers every read, with a sentinel position
    only where the shard found no candidate."""
    reads, lens = inputs(ref_npz)
    st = shard.get_executor(shard.from_epoched(epi, 3).index,
                            backend="torch", **KW).stage(
        shard.from_epoched(epi, 3).index.parts, reads, lens)
    none = st.position == POS_SENTINEL
    assert (st.distance[none] == 13).all()
    assert not none.all(0).any()  # each read found somewhere
