"""Port parity: `repro_torch.shard`'s graph half against `repro.shard`.

As tests/test_torch_shard.py, for the variation-graph workload: the
reference runs once in a subprocess (tests/torch_shard_reference.py)
and the port is held against its ``.npz``, bit for bit — the graph
partition, the screen's survivor counts and the rung, the per-shard
candidate stage, both merges (on the stage outputs and on synthetic
stages with ties and distances on both sides of 2048), the mapper at 1,
2 and 3 shards with the align stage split and pipelined, the failover
driver with a shard lost in the screen and another between merge and
align, and the engine sharded and pipelined.  The reads include two
with N inside and three across the shard cuts.
"""
import numpy as np
import pytest
import torch

from repro_torch import shard
from repro_torch.core.genasm import GenASMConfig
from repro_torch.genomics import simulate
from repro_torch.graph import index as graph_index
from repro_torch.graph import mapper as graph_mapper
from repro_torch.graph.mapper import CandidateStageResult
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.shard import merge as sm

from test_torch_shard import (BASE, assert_engine_equal, assert_tree_equal,
                              engine_reads, inputs, run_reference)

CFG = GenASMConfig()
KW = dict(cfg=CFG, p_cap=128, filter_bits=128, filter_k=12,
          shard_candidates=4)


@pytest.fixture(scope="module")
def ref_npz(tmp_path_factory):
    return run_reference("graph", tmp_path_factory.mktemp("ref") / "g.npz")


@pytest.fixture(scope="module")
def gidx(ref_npz):
    ref = ref_npz["in/ref"]
    variants = simulate.simulate_variants(ref, n_snp=20, n_ins=10, n_del=10,
                                          seed=7)
    return graph_index.build_graph_index(ref, variants, w=8, k=12,
                                         window=128 + 2 * CFG.w, device="cpu")


def stage_of(ref_npz, case: str) -> CandidateStageResult:
    return CandidateStageResult(*(torch.from_numpy(ref_npz[f"{case}/{f}"])
                                  for f in CandidateStageResult._fields))


def test_partition_matches_reference(ref_npz, gidx):
    """Tiles (hop masks included), Bloom words, slack, backbone and
    table slices: pure slices of the global index, field for field
    (uint32 words compared as int32 bit patterns)."""
    assert gidx.n_tiles == int(ref_npz["graph/n_tiles"])
    a = shard.from_epoched_graph(gidx, 3).index.arrays
    for name in a._fields:
        want = ref_npz[f"gpart3/{name}"]
        if want.dtype == np.uint32:
            want = want.view(np.int32) if name != "hashes" else \
                want.astype(np.int64)
        np.testing.assert_array_equal(getattr(a, name).numpy(), want,
                                      err_msg=name)


def test_placement_one_block_per_shard(ref_npz, gidx):
    one = shard.from_epoched_graph(gidx, 3).index
    per = shard.from_epoched_graph(gidx, 3, devices=["cpu"] * 3).index
    assert len(per.parts) == 3 and per.layout_key == one.layout_key
    for f in one.arrays._fields:
        assert torch.equal(getattr(one.arrays, f), getattr(per.arrays, f)), f
    reads, lens = inputs(ref_npz)
    got = shard.map_batch_sharded_graph(per, reads, lens, align_sharded=True,
                                        backend="graph_torch", **KW)
    assert_tree_equal(got, ref_npz, "gmap3_as")


def test_epoch_tokens_and_refresh_shard(ref_npz, gidx):
    esi = shard.from_epoched_graph(gidx, 2)
    before, t0 = esi.current()
    t1 = esi.refresh_shard(0)
    np.testing.assert_array_equal([t0[1], t1[1]], ref_npz["gepochs/tokens"])
    assert esi.index is not before
    for f in before.arrays._fields:
        assert torch.equal(getattr(before.arrays, f),
                           getattr(esi.index.arrays, f)), f
    with pytest.raises(IndexError):
        esi.refresh_shard(2)


def test_graph_key_matches_reference(ref_npz):
    """The signed key is the reference's unsigned key minus 2**63, so it
    orders the grid — distances 2047, 2048, 4094 and the field maxima
    included — as the tuples do, and unpacks back."""
    grid = torch.from_numpy(ref_npz["keys/in"])
    key = sm.pack_graph_key(*(grid[:, i] for i in range(3)))
    want = (ref_npz["keys/packed"] ^ np.uint64(1 << 63)).view(np.int64)
    np.testing.assert_array_equal(key.numpy(), want)
    order = [(d, o, min(t, sm.GRAPH_TILE_MAX)) for d, o, t in grid.tolist()]
    assert sorted(range(len(order)), key=order.__getitem__) == \
        key.argsort(stable=True).tolist()
    d, o, t = sm.unpack_graph_key(key)
    for got, col in zip((d, o, t), grid.T):
        assert torch.equal(got.long(), col)


def test_graph_domain_check():
    sm.check_graph_domain(n_tiles=sm.GRAPH_TILE_MAX - 1, filter_k=4093)
    with pytest.raises(ValueError, match="tile field"):
        sm.check_graph_domain(n_tiles=sm.GRAPH_TILE_MAX, filter_k=12)
    with pytest.raises(ValueError, match="distance field"):
        sm.check_graph_domain(n_tiles=64, filter_k=sm.GRAPH_D_MAX)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_merge_with_forced_ties(ref_npz, s):
    """Ties at every level, dead columns and distances 2047–4094: device
    merge == host merge == the reference's merges."""
    st = stage_of(ref_npz, f"tie{s}/in")
    dev = shard.ShardedGraphMapExecutor.merge_device(st)
    host = shard.ShardedGraphMapExecutor.merge_host(st)
    for f in CandidateStageResult._fields:
        h = getattr(host, f)
        np.testing.assert_array_equal(getattr(dev, f).numpy(), h, err_msg=f)
        np.testing.assert_array_equal(h, ref_npz[f"tie{s}/host/{f}"])
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      ref_npz[f"tie{s}/dev/{f}"])
    assert (st.distance >= 2048).any() and (st.distance < 2048).any()


@pytest.mark.parametrize("s", [2, 3])
def test_screen_stage_and_merge_match_reference(ref_npz, gidx, s):
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched_graph(gidx, s)
    ex = shard.get_graph_executor(esi.index, backend="graph_cuda", **KW)
    pfs = ex.screen(esi.index.parts, torch.from_numpy(reads), lens)
    n_keep = torch.stack([pf.n_keep for pf in pfs]).numpy()
    np.testing.assert_array_equal(n_keep, ref_npz[f"gstage{s}/n_keep"])
    n_cap = graph_mapper.tile_rung(int(n_keep.sum(1).max()), len(lens) * 4)
    assert n_cap == int(ref_npz[f"gstage{s}/n_cap"])
    st = ex.candidates(esi.index.parts, torch.from_numpy(reads), lens, pfs,
                       n_cap)
    for f in CandidateStageResult._fields:
        want = ref_npz[f"gstage{s}/{f}"]
        want = want.view(np.int32) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(getattr(st, f).numpy(), want,
                                      err_msg=f)
    host = ex.merge_host(st)
    dev = ex.merge_device(st)
    for f in CandidateStageResult._fields:
        want = ref_npz[f"gmerge{s}/{f}"]
        want = want.view(np.int32) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(getattr(host, f), want, err_msg=f)
        np.testing.assert_array_equal(getattr(dev, f).numpy(), want,
                                      err_msg=f)


@pytest.mark.parametrize("s,backend", [(1, "graph_torch"), (2, "graph_torch"),
                                       (3, "graph_cuda")])
def test_map_batch_sharded_graph_matches_reference(ref_npz, gidx, s, backend):
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched_graph(gidx, s)
    got = shard.map_batch_sharded_graph(esi.index, reads, lens,
                                        backend=backend, **KW)
    assert_tree_equal(got, ref_npz, f"gmap{s}")
    assert (got.position >= 0).sum() >= 17


def test_sharded_equals_single_device_port(ref_npz, gidx):
    reads, lens = inputs(ref_npz)
    want = graph_mapper.map_batch_index(gidx, reads, lens, cfg=CFG, p_cap=128,
                                        filter_bits=128, filter_k=12,
                                        max_candidates=4,
                                        backend="graph_torch")
    got = shard.map_batch_sharded_graph(
        shard.from_epoched_graph(gidx, 2).index, reads, lens,
        backend="graph_torch", **KW)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("mode", ["as", "pl"])
def test_align_sharded_and_pipelined_match_reference(ref_npz, gidx, s, mode):
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched_graph(gidx, s)
    kw = (dict(align_sharded=True) if mode == "as"
          else dict(align_sharded=s == 3, pipelined=True))
    got = shard.map_batch_sharded_graph(esi.index, reads, lens,
                                        backend="graph_cuda", **kw, **KW)
    assert_tree_equal(got, ref_npz, f"gmap{s}_{mode}")


def test_start_finish_and_all_pruned_batch(ref_npz, gidx):
    """The timed call closes prefilter, dc_filter, merge_device and align;
    a batch whose reads seed nowhere returns the canonical unmapped
    result, already on the host."""
    reads, lens = inputs(ref_npz)
    esi = shard.from_epoched_graph(gidx, 2)
    ex = shard.get_graph_executor(esi.index, backend="graph_torch", **KW)
    ex(esi.index.parts, torch.from_numpy(reads), lens)
    assert [n for n, *_ in ex.last_times] == ["prefilter", "dc_filter",
                                             "merge_device", "align"]
    assert ex.last_stats["dc_rows"] == 2 * int(ref_npz["gstage2/n_cap"])
    n_reads = np.full_like(reads[:3], 4)  # all-N reads: no seed anywhere
    pending = ex.start(esi.index.parts, torch.from_numpy(n_reads), lens[:3])
    assert pending.tail is None
    res, times = ex.finish(pending)
    assert [n for n, *_ in times] == ["prefilter"]
    assert res.failed.all() and (res.position == -1).all()


def test_failover_graph_faults_yield_identical_result(ref_npz, gidx):
    """A screen-phase loss and an align-chunk loss in one batch."""
    reads, lens = inputs(ref_npz)
    clean = shard.map_batch_with_failover_graph(
        shard.from_epoched_graph(gidx, 3), reads, lens,
        backend="graph_torch", **KW)
    assert_tree_equal(clean, ref_npz, "gfail_clean")
    failures = []

    def lose(shard_id):
        def hook(i, attempt):
            if i == shard_id and attempt == 1:
                failures.append(i)
                raise RuntimeError("simulated device loss")
        return hook

    esi = shard.from_epoched_graph(gidx, 3)
    res = shard.map_batch_with_failover_graph(
        esi, reads, lens, pipelined=True, fault_hook=lose(0),
        align_fault_hook=lose(1), backend="graph_cuda", **KW)
    np.testing.assert_array_equal(failures, ref_npz["gfail_lost/failures"])
    np.testing.assert_array_equal(esi.epochs, ref_npz["gfail_lost/epochs"])
    assert_tree_equal(res, ref_npz, "gfail_lost")
    assert_tree_equal(res, ref_npz, "gmap3")


def test_failover_graph_gives_up_after_max_attempts(ref_npz, gidx):
    reads, lens = inputs(ref_npz)

    def always_lose(i, attempt):
        if i == 1:
            raise RuntimeError("persistent loss")

    with pytest.raises(RuntimeError, match="failed 2 times"):
        shard.map_batch_with_failover_graph(
            shard.from_epoched_graph(gidx, 2), reads[:4], lens[:4],
            max_attempts=2, fault_hook=always_lose, backend="graph_torch",
            **KW)


def test_engine_sharded_pipelined_matches_reference(ref_npz, gidx):
    reads = engine_reads(ref_npz)
    base = dict(BASE, workload="graph", align_backend="graph_cuda")
    with ServeEngine(gidx, EngineConfig(num_shards=2, align_sharded=True,
                                        pipelined=True, **base)) as eng:
        got = eng.map_all(reads)
        assert eng.metrics.counter("batches_flushed").value >= 5
        assert eng.align_backend == "graph_cuda"
    assert_engine_equal(got, ref_npz, "gengine2_pl")
    assert_engine_equal(got, ref_npz, "gengine1")
    np.testing.assert_array_equal(np.stack([r.path for r in got]),
                                  ref_npz["gengine2_pl/path"])


def test_engine_sharded_graph_rejects_linear_index(ref_npz):
    from repro_torch.core import minimizer_index

    idx = minimizer_index.build_reference_index(ref_npz["in/ref"], w=8, k=12,
                                                device="cpu")
    with pytest.raises(TypeError, match="GraphIndex"):
        ServeEngine(idx, EngineConfig(num_shards=2, workload="graph",
                                      **dict(BASE, align_backend="graph_torch")))

