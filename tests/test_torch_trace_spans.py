"""The linear mapper's spans: the tree one batch traces, its counters, when
the process tracer is on, and its clock against `torch.profiler`'s."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import genasm_dc, mapper
from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.minimizer_index import build_reference_index
from repro_torch.genomics import encode, simulate
from repro_torch.obs import trace

P_CAP = 160  # 6 window steps at GenASM's W = 64, O = 24
N_WIN = GenASMConfig().n_windows(P_CAP)
STAGE_OF = {"map_batch": None, "seed_filter": "map_batch", "align": "map_batch",
            "seed": "seed_filter", "filter": "seed_filter", "dc": "align",
            "tb": "align"}


@pytest.fixture(scope="module")
def deployment():
    """A small reference, its index on the CPU, and a batch of 150 bp reads
    of which the first four come from elsewhere (the filter drops them)."""
    ref = simulate.random_reference(20000, seed=1)
    reads = simulate.simulate_reads(ref, n_reads=20, read_len=150, seed=2).reads
    reads[:4] = [simulate.random_reference(150, seed=90 + i) for i in range(4)]
    arr, lens = encode.batch_reads(reads, P_CAP)
    return build_reference_index(ref, device="cpu"), arr, lens


@pytest.fixture
def process_log():
    log = trace.PROCESS_TRACER.log
    log.clear()
    yield log
    log.clear()


def by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def traced_batch(deployment, backend="torch"):
    index, arr, lens = deployment
    tr = trace.Tracer()
    ex = mapper.LinearMapExecutor(p_cap=P_CAP, backend=backend, tracer=tr)
    return ex, ex(index, arr, lens), tr.log.spans()


def test_one_batch_traces_the_tree(deployment):
    ex, _, spans = traced_batch(deployment)
    got = by_name(spans)
    assert {k: len(v) for k, v in got.items()} == {
        "map_batch": 1, "seed_filter": 1, "align": 1, "seed": 1, "filter": 1,
        "dc": N_WIN, "tb": N_WIN}
    ids = {s.span_id: s for s in spans}
    for s in spans:
        parent = ids[s.parent_id].name if s.parent_id is not None else None
        assert parent == STAGE_OF[s.name], s.name
    assert {s.attrs["batch"] for s in spans} == {1}
    for name in ("dc", "tb"):
        assert [s.attrs["window"] for s in got[name]] == list(range(N_WIN))
    # the stage spans carry the stamps of ``last_times``
    assert [(n, a, b) for n, a, b, _ in ex.last_times] == [
        (n, got[n][0].t_start, got[n][0].t_end) for n in ("seed_filter", "align")]


def test_each_parent_covers_its_children(deployment):
    _, _, spans = traced_batch(deployment)
    ids = {s.span_id: s for s in spans}
    for s in spans:
        if s.parent_id is not None:
            p = ids[s.parent_id]
            assert p.t_start <= s.t_start <= s.t_end <= p.t_end, (p.name, s.name)
    steps = sorted(by_name(spans)["dc"] + by_name(spans)["tb"], key=lambda s: s.t_start)
    assert [s.name for s in steps] == ["dc", "tb"] * N_WIN
    assert all(a.t_end <= b.t_start for a, b in zip(steps, steps[1:]))


def test_counters_are_the_filters_survivors_and_the_aligned_rows(deployment):
    index, arr, lens = deployment
    _, _, spans = traced_batch(deployment)
    got = by_name(spans)
    sf = mapper.seed_and_filter_batch(
        index, torch.as_tensor(arr), torch.as_tensor(lens), p_cap=P_CAP,
        t_cap=P_CAP + 2 * GenASMConfig().w, filter_bits=128, filter_k=12,
        max_candidates=4, minimizer_w=10, minimizer_k=15)
    passed = got["filter"][0].attrs["passed"]
    assert passed == int(sf.prefilter_ok.sum()) and 0 < passed < len(arr)
    assert got["align"][0].attrs["rows"] == len(arr)
    # on the CPU no span has a device time
    assert all(s.attrs["device_ms"] is None
               for n in ("seed", "filter", "dc") for s in got[n])


@pytest.mark.parametrize("backend", ["torch", "cuda_dc"])
def test_tracing_leaves_the_results_bit_identical(deployment, backend):
    index, arr, lens = deployment
    _, traced, _ = traced_batch(deployment, backend)
    plain = mapper.LinearMapExecutor(p_cap=P_CAP, backend=backend)(index, arr, lens)
    want = mapper.map_batch(index, torch.as_tensor(arr), torch.as_tensor(lens),
                            p_cap=P_CAP, backend=backend)
    for name, a, b, c in zip(mapper.MapResult._fields, traced, plain, want):
        assert torch.equal(a, b) and torch.equal(b, c), name


def test_batch_numbers_count_the_calls_and_a_failed_call_leaves_no_open_span(
        deployment, monkeypatch):
    index, arr, lens = deployment
    tr = trace.Tracer()
    ex = mapper.LinearMapExecutor(p_cap=P_CAP, backend="torch", tracer=tr)
    ex(index, arr, lens)

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(mapper, "_finish", broken)
    with pytest.raises(RuntimeError, match="planted"):
        ex(index, arr, lens)
    monkeypatch.undo()
    ex(index, arr, lens)
    spans = tr.log.spans()
    assert [s.attrs["batch"] for s in spans if s.name == "map_batch"] == [1, 2, 3]
    third = [s for s in spans if s.attrs["batch"] == 3]
    ids = {s.span_id: s for s in third}
    assert sorted(s.name for s in third) == sorted(
        ["map_batch", "seed_filter", "seed", "filter", "align"] + ["dc", "tb"] * N_WIN)
    assert all((ids[s.parent_id].name if s.parent_id else None) == STAGE_OF[s.name]
               for s in third)
    assert tr.current_parent() is None


def test_process_log_stays_empty_without_a_profiler(deployment, process_log):
    index, arr, lens = deployment
    mapper.LinearMapExecutor(p_cap=P_CAP, backend="torch")(index, arr, lens)
    assert process_log.spans() == []
    assert trace.current_tracer() is trace.NULL_TRACER


def test_process_log_fills_under_a_profiler_on_its_clock(deployment, process_log,
                                                         monkeypatch):
    """The profiler's events of the filter's ops lie inside the ``filter``
    spans once the spans are mapped onto the profiler's epoch clock."""
    index, arr, lens = deployment
    search = genasm_dc.bitap_search

    def marked(*a, **k):
        with record_function("bitap_search_probe"):
            return search(*a, **k)

    monkeypatch.setattr(genasm_dc, "bitap_search", marked)
    ex = mapper.LinearMapExecutor(p_cap=P_CAP, backend="torch")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            ex(index, arr, lens)
    spans = process_log.spans()
    assert [s.attrs["batch"] for s in spans if s.name == "map_batch"] == [1, 2]
    filters = sorted(by_name(spans)["filter"], key=lambda s: s.t_start)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "bitap_search_probe")
    assert len(events) == len(filters) == 2
    for s, (a, b) in zip(filters, events):
        assert process_log.to_epoch_ns(s.t_start) <= a <= b <= \
            process_log.to_epoch_ns(s.t_end)
    ts0 = process_log.to_chrome()["otherData"]["ts0_epoch_ns"]
    assert ts0 == process_log.to_epoch_ns(process_log.t0)
    # after the profiler, untraced again
    ex(index, arr, lens)
    assert len(process_log.spans()) == len(spans)


@pytest.mark.cuda
def test_device_spans_carry_their_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events time the card's work")
    dev = torch.device("cuda", 0)
    ref = simulate.random_reference(20000, seed=1)
    reads = simulate.simulate_reads(ref, n_reads=64, read_len=150, seed=2).reads
    arr, lens = encode.batch_reads(reads, P_CAP)
    index = build_reference_index(ref, device=dev)
    tr = trace.Tracer()
    ex = mapper.LinearMapExecutor(p_cap=P_CAP, backend="torch", tracer=tr)
    res = ex(index, arr, lens)
    got = by_name(tr.log.spans())
    for name in ("seed", "filter", "dc"):
        assert got[name] and all(isinstance(s.attrs["device_ms"], float)
                                 and s.attrs["device_ms"] > 0 for s in got[name])
    # a mapped read passed the filter
    mapped = int(np.sum(res.position.cpu().numpy() >= 0))
    assert mapped <= got["filter"][0].attrs["passed"] <= len(arr)
