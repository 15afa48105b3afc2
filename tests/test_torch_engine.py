"""The port's serving engine: buckets, executor cache, result cache, errors.

Mirrors the engine behaviours tests/test_serve_engine.py checks on the
reference, on the CPU with the ``torch`` backend, and holds the
engine's answers against the port's `map_batch` on the same reads.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mapper, minimizer_index
from repro_torch.genomics import encode, simulate
from repro_torch.serve import EngineConfig, ServeEngine, Session

CFG = EngineConfig(buckets=(64, 128), max_batch=4, max_delay_s=0.001,
                   align_backend="torch", filter_k=8, minimizer_w=8,
                   minimizer_k=12)


@pytest.fixture(scope="module")
def data():
    ref = simulate.random_reference(3000, seed=1)
    rs = simulate.simulate_reads(ref, n_reads=6, read_len=100,
                                 profile=simulate.ILLUMINA, seed=2)
    short = [r[:60] for r in rs.reads[:2]]  # the 64 rung
    return ref, rs.reads + short


def test_engine_matches_map_batch_and_routes_buckets(data):
    ref, reads = data
    epi = minimizer_index.build_epoched_index(ref, w=8, k=12, device="cpu")
    with ServeEngine(epi, CFG) as engine:
        got = engine.map_all(reads)
        assert engine.n_executors == 2  # one per bucket rung in use
        assert engine.align_backend == "torch"
    assert [r.bucket_cap for r in got] == [128] * 6 + [64] * 2
    for cap, idx in ((128, range(6)), (64, range(6, 8))):
        arr, lens = encode.batch_reads([reads[i] for i in idx], cap)
        want = mapper.map_batch(epi.index, arr, lens, p_cap=cap,
                                filter_bits=min(128, cap), filter_k=8,
                                minimizer_w=8, minimizer_k=12, backend="torch")
        for j, i in enumerate(idx):
            assert got[i].position == int(want.position[j])
            assert got[i].distance == int(want.distance[j])
            assert got[i].n_ops == int(want.n_ops[j])
            np.testing.assert_array_equal(got[i].ops, want.ops[j].numpy())


def test_result_cache_hits_and_epoch_refresh(data):
    ref, reads = data
    epi = minimizer_index.build_epoched_index(ref, w=8, k=12, device="cpu")
    with ServeEngine(epi, CFG) as engine:
        first = Session(engine)
        first.submit(reads[0], meta="a")
        (_, a), = first.drain()
        again = engine.submit(reads[0]).result()
        assert again.cached and not a.cached
        assert (again.position, again.distance) == (a.position, a.distance)
        epi.refresh(ref)  # new epoch: the cached result no longer applies
        fresh = engine.submit(reads[0]).result()
        assert not fresh.cached and fresh.position == a.position
        assert engine.cache.hits == 1


def test_engine_rejects_mismatched_minimizers(data):
    ref, _ = data
    epi = minimizer_index.build_epoched_index(ref, w=10, k=15, device="cpu")
    with pytest.raises(ValueError, match="minimizer"):
        ServeEngine(epi, CFG)


def test_bare_reference_index_is_wrapped(data):
    ref, reads = data
    idx = minimizer_index.build_reference_index(ref, w=8, k=12, device="cpu")
    with ServeEngine(idx, CFG) as engine:
        res = engine.submit(reads[1]).result()
        assert engine.device == torch.device("cpu")
    assert res.position >= 0


def test_worker_error_reaches_every_future(data, monkeypatch):
    ref, reads = data
    epi = minimizer_index.build_epoched_index(ref, w=8, k=12, device="cpu")

    def boom(*a, **kw):
        raise RuntimeError("executor failed")

    monkeypatch.setattr(mapper.LinearMapExecutor, "__call__", boom)
    engine = ServeEngine(epi, CFG)
    futs = [engine.submit(r) for r in reads[:3]]
    for f in futs:
        with pytest.raises(RuntimeError, match="executor failed"):
            f.result(timeout=30)
    with pytest.raises(RuntimeError, match="worker died"):
        engine.submit(reads[3])
    engine.close()
