"""Port parity: the graph mapper and the engine's graph workload.

A seeded variation graph is indexed by `repro` and by `repro_torch`; a
mixed batch of clean, mutated and unmappable reads goes through the
reference's `GraphMapExecutor` (``graph_lax``) and the port's
(``graph_torch``, and ``graph_cuda`` whose wrappers take the plain
versions on the CPU), with the tile screen on and off.  Positions,
distances, CIGAR ops, node paths, failures and the pruning counters
must match exactly — also on an index carried over from the reference
and on one the reference wrote to npz.
"""
import numpy as np
import pytest
import torch

from repro.core.genasm import GenASMConfig as JConfig
from repro.genomics import encode, simulate
from repro.graph import index as jindex
from repro.graph import mapper as jmapper
from repro_torch.core import minimizer_index
from repro_torch.core.genasm import GenASMConfig
from repro_torch.graph import index as tindex
from repro_torch.graph import mapper as tmapper
from repro_torch.serve import EngineConfig, ServeEngine

P_CAP = 128
T_CAP = P_CAP + 2 * 64
MAP_KW = dict(p_cap=P_CAP, filter_bits=128, filter_k=12, max_candidates=4,
              minimizer_w=8, minimizer_k=12)
RESULT_FIELDS = ("position", "distance", "ops", "n_ops", "path", "failed")


@pytest.fixture(scope="module")
def setup():
    ref = simulate.random_reference(5000, seed=41)
    variants = simulate.simulate_variants(ref, n_snp=20, n_ins=10, n_del=10,
                                          seed=42)
    kw = dict(w=8, k=12, window=T_CAP)
    jidx = jindex.build_graph_index(ref, variants, **kw)
    tidx = tindex.build_graph_index(ref, variants, **kw, device="cpu")
    rng = np.random.default_rng(43)
    reads = []
    for i in range(10):
        s = int(rng.integers(0, len(ref) - 100))
        r = np.array(ref[s: s + 100], np.int8)
        if i >= 5:
            subs = rng.integers(0, 100, size=4)
            r[subs] = (r[subs] + 1 + rng.integers(0, 3, size=4)) % 4
        reads.append(r)
    reads += [rng.integers(0, 4, 100).astype(np.int8) for _ in range(2)]
    # N (id 4) inside the read: scattered, and a run
    for n_at in ([12, 47, 81], list(range(30, 36))):
        s = int(rng.integers(0, len(ref) - 100))
        r = np.array(ref[s: s + 100], np.int8)
        r[n_at] = 4
        reads.append(r)
    arr, lens = encode.batch_reads(reads, P_CAP)
    return ref, jidx, tidx, arr, lens


@pytest.fixture(scope="module")
def reference(setup):
    """The reference executor's results and stats, prefilter on and off."""
    _, jidx, _, arr, lens = setup
    out = {}
    for prefilter in (True, False):
        ex = jmapper.GraphMapExecutor(tile_stride=jidx.tile_stride,
                                      cfg=JConfig(), backend="graph_lax",
                                      prefilter=prefilter, **MAP_KW)
        out[prefilter] = ex(jidx.arrays, arr, lens), dict(ex.last_stats)
    return out


def assert_result_equal(got, want):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("prefilter", [True, False])
@pytest.mark.parametrize("backend", ["graph_torch", "graph_cuda"])
def test_executor_matches_reference(setup, reference, backend, prefilter):
    _, _, tidx, arr, lens = setup
    want, want_stats = reference[prefilter]
    ex = tmapper.GraphMapExecutor(tile_stride=tidx.tile_stride,
                                  cfg=GenASMConfig(), backend=backend,
                                  prefilter=prefilter, **MAP_KW)
    got = ex(tidx.arrays, arr, lens)
    assert_result_equal(got, want)
    assert ex.last_stats == want_stats
    assert [name for name, *_ in ex.last_times] == \
        ["prefilter", "dc_filter", "align"]
    assert (got.position.numpy() >= 0).sum() >= 8


def test_carried_and_npz_indexes_serve_the_same(setup, reference, tmp_path):
    _, jidx, _, arr, lens = setup
    want, _ = reference[True]
    carried = tindex.graph_index_from_arrays(
        jidx.ref, jindex.GraphArrays(*(np.asarray(x) for x in jidx.arrays)),
        tile_len=jidx.tile_len, tile_stride=jidx.tile_stride,
        minimizer_w=jidx.minimizer_w, minimizer_k=jidx.minimizer_k,
        window=jidx.window, margin=jidx.margin, device="cpu")
    path = tmp_path / "g.npz"
    jindex.save_graph_index(path, jidx)
    for gidx in (carried, tindex.load_graph_index(path, device="cpu")):
        got = tmapper.map_batch_index(gidx, arr, lens, backend="graph_torch",
                                      cfg=GenASMConfig(), prefilter=True,
                                      **{k: v for k, v in MAP_KW.items()
                                         if not k.startswith("minimizer")})
        assert_result_equal(got, want)


def test_zero_survivor_batch_short_circuits(setup):
    _, _, tidx, _, _ = setup
    rng = np.random.default_rng(5)
    arr, lens = encode.batch_reads(
        [rng.integers(0, 4, 100).astype(np.int8) for _ in range(3)], P_CAP)
    ex = tmapper.GraphMapExecutor(tile_stride=tidx.tile_stride,
                                  backend="graph_torch", **MAP_KW)
    got = ex(tidx.arrays, arr, lens)
    assert ex.last_stats["tiles_kept"] == 0
    assert [name for name, *_ in ex.last_times] == ["prefilter"]
    want = tmapper.unmapped_result(3, cfg=GenASMConfig(), p_cap=P_CAP,
                                   device="cpu")
    for name in RESULT_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_backend_names_and_rungs():
    assert tmapper.graph_backend_name("torch") == "graph_torch"
    assert tmapper.graph_backend_name("cuda_dc_v2") == "graph_cuda"
    assert tmapper.graph_backend_name("auto", "cpu") == "graph_torch"
    assert tmapper.graph_backend_name("graph_cuda") == "graph_cuda"
    for n, cap, want in ((0, 32, 0), (1, 32, 8), (9, 32, 16), (33, 32, 32),
                         (100, 1024, 128)):
        assert tmapper.tile_rung(n, cap) == jmapper.tile_rung(n, cap) == want


def test_executor_rejects_undersized_tiles(setup):
    _, _, tidx, arr, lens = setup
    ex = tmapper.GraphMapExecutor(tile_stride=tidx.tile_stride,
                                  backend="graph_torch",
                                  **{**MAP_KW, "p_cap": 256})
    with pytest.raises(ValueError, match="tile_len"):
        ex(tidx.arrays, arr, lens)


def test_engine_graph_workload(setup, reference):
    """The engine serves the graph workload: per-read results equal the
    reference executor's, paths ride on cached twins, and the graph
    counters and stage times reach the metrics."""
    ref, _, tidx, arr, lens = setup
    want, _ = reference[True]
    cfg = EngineConfig(buckets=(P_CAP,), max_batch=4, max_delay_s=0.001,
                       workload="graph", align_backend="torch", filter_k=12,
                       minimizer_w=8, minimizer_k=12)
    reads = [arr[i, :lens[i]] for i in range(len(lens))]
    with ServeEngine(tindex.EpochedGraphIndex(tidx), cfg) as eng:
        assert eng.align_backend == "graph_torch"
        res = eng.map_all(reads)
        again = eng.map_all([reads[0]])[0]
        m = eng.metrics.snapshot()
    for i, r in enumerate(res):
        assert r.position == int(want.position[i])
        assert r.distance == int(want.distance[i])
        np.testing.assert_array_equal(r.path, np.asarray(want.path[i]))
    assert again.cached and again.path is not None
    # every flush is padded to max_batch rows of max_candidates slots
    assert m["graph_candidate_slots"] == m["batches_flushed"] * 4 * 4
    assert {"stage_prefilter_s", "stage_dc_filter_s", "stage_align_s"} <= set(m)

    epi = minimizer_index.build_epoched_index(ref, w=8, k=12, device="cpu")
    with pytest.raises(TypeError, match="GraphIndex"):
        ServeEngine(epi, cfg)
    with pytest.raises(ValueError, match="workload"):
        EngineConfig(buckets=(96,), workload="protein")
