"""Port parity: `repro_torch.genomics.pipeline` against `repro.genomics.pipeline`.

``ReadBatches`` yields the reference's batches, array for array (host
striding, resume, tail padding).  ``Prefetcher`` hands a worker
exception to the consumer, closes mid-stream with a full queue, and
refuses the default ``cuda`` without a card.  ``map_stream`` on the
port's ``torch`` backend, fed through ``ReadBatches`` and a CPU
``Prefetcher``, gives the reference's ``map_stream`` on ``lax`` result
for result, every `MapResult` field exactly.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import minimizer_index as jindex
from repro.genomics import pipeline as jpipe
from repro.genomics import simulate
from repro_torch.core import minimizer_index as tindex
from repro_torch.genomics import pipeline as tpipe

MAP_KW = dict(p_cap=128, filter_bits=96, filter_k=12, minimizer_w=8,
              minimizer_k=12)


def _reads(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, size=int(rng.integers(0, 40))).astype(np.int8)
            for _ in range(n)]


@pytest.mark.parametrize("n,batch,cap,pi,pc,start", [
    (10, 2, 16, 0, 1, 0), (10, 2, 16, 0, 2, 0), (10, 2, 16, 1, 2, 0),
    (11, 4, 24, 2, 3, 0), (8, 2, 8, 0, 1, 2), (7, 3, 32, 0, 1, 1),
    (0, 4, 16, 0, 1, 0)])
def test_read_batches_equal_reference(n, batch, cap, pi, pc, start):
    reads = _reads(n, seed=n + cap)
    kw = dict(batch=batch, cap=cap, process_index=pi, process_count=pc,
              start_batch=start)
    got = list(tpipe.ReadBatches(reads, **kw))
    want = list(jpipe.ReadBatches(reads, **kw))
    assert len(got) == len(want)
    for (gb, ga, gl), (wb, wa, wl) in zip(got, want):
        assert gb == wb
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gl, wl)
        assert ga.dtype == wa.dtype and gl.dtype == wl.dtype


def test_prefetcher_cpu_puts_tensors():
    reads = _reads(9, seed=1)
    batches = list(tpipe.ReadBatches(reads, batch=4, cap=16))
    with tpipe.Prefetcher(iter(batches), device="cpu") as pf:
        got = list(pf)
    assert [b for b, _, _ in got] == [0, 1, 2]
    for (b, arr, lens), (_, want_arr, want_lens) in zip(got, batches):
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
        np.testing.assert_array_equal(arr.numpy(), want_arr)
        np.testing.assert_array_equal(lens.numpy(), want_lens)


def test_prefetcher_passes_worker_exception():
    def broken():
        yield 0, np.zeros((2, 4), np.int8), np.zeros(2, np.int32)
        raise ValueError("encode failed")

    seen = []
    with tpipe.Prefetcher(broken(), device="cpu") as pf:
        with pytest.raises(ValueError, match="encode failed"):
            for b, _, _ in pf:
                seen.append(b)
    assert seen == [0]


def test_prefetcher_closes_mid_stream():
    def endless():
        i = 0
        while True:
            yield i, np.zeros((2, 4), np.int8), np.zeros(2, np.int32)
            i += 1

    pf = tpipe.Prefetcher(endless(), device="cpu", depth=2)
    it = iter(pf)
    assert next(it)[0] == 0
    time.sleep(0.05)  # the worker fills the queue and blocks on put
    t0 = time.perf_counter()
    pf.close()
    assert not pf._t.is_alive()
    assert time.perf_counter() - t0 < 5.0
    pf.close()  # idempotent
    # closed elsewhere: the consumer's iteration ends instead of hanging
    done = threading.Event()
    threading.Thread(target=lambda: (list(it), done.set()), daemon=True).start()
    assert done.wait(5.0)


def test_prefetcher_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device cuda is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.Prefetcher(iter(()))


@pytest.fixture(scope="module")
def small_index():
    ref = simulate.random_reference(3000, seed=11)
    reads = simulate.simulate_reads(ref, n_reads=14, read_len=90,
                                    profile=simulate.ILLUMINA, seed=12)
    reads = list(reads.reads)
    reads[3] = np.concatenate([reads[3][:40], np.full(5, 4, np.int8),
                               reads[3][45:]])  # an N run inside a read
    return ref, reads


def test_map_stream_equals_reference(small_index):
    ref, reads = small_index
    jidx = jindex.build_reference_index(ref, w=8, k=12)
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    want = {}
    with jpipe.Prefetcher(iter(jpipe.ReadBatches(reads, batch=4, cap=96))) as pf:
        for b, res in jpipe.map_stream(jidx, pf, backend="lax", **MAP_KW):
            want[b] = res
    got = {}
    with tpipe.Prefetcher(iter(tpipe.ReadBatches(reads, batch=4, cap=96)),
                          device="cpu") as pf:
        for b, res in tpipe.map_stream(tidx, pf, backend="torch", **MAP_KW):
            got[b] = res
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for b in want:
        for name in want[b]._fields:
            np.testing.assert_array_equal(
                getattr(got[b], name).numpy(), np.asarray(getattr(want[b], name)),
                err_msg=f"batch {b} {name}")
    mapped = sum(int((r.position.numpy() >= 0).sum()) for r in got.values())
    assert mapped >= 10


def test_map_stream_takes_numpy_batches(small_index):
    """Without a prefetcher the host arrays go straight to `map_batch`."""
    ref, reads = small_index
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    batches = tpipe.ReadBatches(reads, batch=8, cap=96)
    direct = [tpipe.map_stream(tidx, iter([t]), backend="torch", **MAP_KW)
              for t in batches]
    with tpipe.Prefetcher(iter(batches), device="cpu") as pf:
        streamed = dict(tpipe.map_stream(tidx, pf, backend="torch", **MAP_KW))
    for it in direct:
        ((b, res),) = list(it)
        for name in res._fields:
            assert torch.equal(getattr(res, name), getattr(streamed[b], name))
