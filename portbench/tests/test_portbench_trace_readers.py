"""The readers of the metrics that read the program's spans, on a made-up
run: a process log of known spans and clock offset, and profiler records."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from portbench import harness
from repro_torch.obs import trace
from repro_torch.obs.trace import Span

READERS = ("seed_device_ms", "filter_device_ms", "dc_device_ms", "tb_ms",
           "idle_in_tb_pct", "align_rows_useful_pct")
OFFSET = 1_760_000_000_000_000_000  # monotonic -> epoch ns of the made-up log
S = 1_000_000_000  # ns a second


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def batch_spans(batch: int, t: float, *, seed, filt, passed, rows, dc, tb):
    """One batch's tree from monotonic second ``t`` on: ``dc`` the device ms
    of its window steps, ``tb`` the seconds of each step's traceback."""
    spans = [Span("seed", t, t + 1, attrs={"batch": batch, "device_ms": seed}),
             Span("filter", t + 1, t + 4,
                  attrs={"batch": batch, "device_ms": filt, "passed": passed})]
    u = t + 4
    for i, (d, secs) in enumerate(zip(dc, tb)):
        spans += [Span("dc", u, u + 1, attrs={"batch": batch, "window": i, "device_ms": d}),
                  Span("tb", u + 1, u + 1 + secs, attrs={"batch": batch, "window": i})]
        u += 1 + secs
    return spans + [Span("seed_filter", t, t + 4, attrs={"batch": batch}),
                    Span("align", t + 4, u, attrs={"batch": batch, "rows": rows}),
                    Span("map_batch", t, u, attrs={"batch": batch})]


@pytest.fixture
def process_log(monkeypatch):
    log = trace.PROCESS_TRACER.log
    log.clear()
    monkeypatch.setattr(log, "epoch_offset_ns", OFFSET)
    yield log
    log.clear()


def ctx_of(records, batches: int, span_s: float):
    return SimpleNamespace(profile=SimpleNamespace(records=records, batches=batches,
                                                   span_s=span_s))


def two_batches(log):
    for s in (batch_spans(1, 100.0, seed=0.5, filt=2.5, passed=30, rows=40,
                          dc=[0.7, 0.9], tb=[2.0, 2.0])
              + batch_spans(2, 200.0, seed=1.5, filt=3.5, passed=6, rows=40,
                            dc=[1.1, 1.3], tb=[1.0, 0.5])):
        log.append(s)
    return ctx_of([("k", OFFSET + 100 * S, OFFSET + 120 * S)], 2, 40.0)


@pytest.mark.parametrize("name,want", [
    ("seed_device_ms", (0.5 + 1.5) / 2),
    ("filter_device_ms", (2.5 + 3.5) / 2),
    ("dc_device_ms", (0.7 + 0.9 + 1.1 + 1.3) / 2),
    ("tb_ms", 1e3 * (2.0 + 2.0 + 1.0 + 0.5) / 2),
    ("align_rows_useful_pct", 100.0 * (30 + 6) / (40 + 40)),
])
def test_span_readers_average_over_the_profiled_batches(process_log, name, want):
    assert reader(name)(two_batches(process_log)) == pytest.approx(want)


def test_idle_in_tb_counts_only_the_part_of_each_gap_inside_a_tb_span(process_log):
    # tb spans at monotonic 5-7 s and 8-10 s
    for s in batch_spans(1, 0.0, seed=0.1, filt=0.1, passed=1, rows=1,
                         dc=[0.1, 0.1], tb=[2.0, 2.0]):
        process_log.append(s)
    at = lambda secs: OFFSET + round(secs * S)  # noqa: E731
    # merged busy: 0-4.5, 6-9 (two overlapping records), 9.5-11: gaps
    # 4.5-6 (1 s of it inside 5-7) and 9-9.5 (all inside 8-10)
    records = [("c", at(9.5), at(11)), ("a", at(0), at(4.5)),
               ("b2", at(6.2), at(9)), ("b1", at(6), at(6.5))]
    got = reader("idle_in_tb_pct")(ctx_of(records, 1, 12.0))
    assert got == pytest.approx(100.0 * 1.5 / 12.0)
    busy = SimpleNamespace(busy_s=harness.union_s(r[1:] for r in records), span_s=12.0)
    assert got <= reader("device_idle_pct")(SimpleNamespace(profile=busy)) == 25.0


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_a_profile(process_log, name):
    two_batches(process_log)
    assert reader(name)(SimpleNamespace(profile=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_span_readers_refuse_a_log_whose_batches_are_not_the_profiled_ones(
        process_log, name):
    ctx = two_batches(process_log)
    ctx.profile.batches = 3
    with pytest.raises(RuntimeError, match="2 map_batch spans .* 3 profiled"):
        reader(name)(ctx)


@pytest.mark.parametrize("missing", ["tracer", "module"])
@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_from_a_program_without_the_process_log(
        process_log, monkeypatch, name, missing):
    """A program older than its spans: its traced run leaves these metrics
    out rather than failing."""
    ctx = two_batches(process_log)
    if missing == "tracer":
        monkeypatch.delattr(trace, "PROCESS_TRACER")
    else:
        monkeypatch.delitem(sys.modules, trace.__name__)
    assert reader(name)(ctx) is None
