"""The roofline counts against hand counts, one window of each kernel."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import generate, work
from portbench.reference import graph as ref_graph

CARD = "NVIDIA H100 80GB HBM3"


def test_genasm_dc_one_window_by_hand():
    # w = 64, k = 24: nw = 2; in 64 + 64 bases, out d_min 4 B and
    # 64 positions × 25 rows × 2 words × 4 B; ops 64 · 2 · (4 + 13 · 24)
    assert work.genasm_dc(windows=1, w=64, k=24) == (128 + 4 + 12800, 40448)


def test_count_is_the_same_however_the_work_is_launched():
    one = [("genasm_dc", {"windows": 6 * 1000, "w": 64, "k": 24})]
    six = [("genasm_dc", {"windows": 1000, "w": 64, "k": 24})] * 6
    assert work.least_seconds(one, CARD, "genasm_dc", work.genasm_dc) == pytest.approx(
        work.least_seconds(six, CARD, "genasm_dc", work.genasm_dc), rel=1e-12)
    # the DC window is bound by its bytes: 12,932 B at 3.35e12 B/s
    assert work.least_seconds(one, CARD, "genasm_dc", work.genasm_dc) == pytest.approx(
        6000 * 12932 / 3.35e12)


def test_records_of_another_kernel_are_passed_over():
    rec = [("bitalign", {"rows": 1, "nodes": 416})]
    assert work.least_seconds(rec, CARD, "genasm_dc", work.genasm_dc) == 0.0


def test_hops_per_node_counts_every_edge_of_the_graph():
    ref = generate.reference(20000, seed=3)
    var = generate.variants(ref, per_bp=200, ratio=(2, 1, 1), seed=3)
    g = ref_graph.build(ref, var)
    edges = sum(bin(int(x)).count("1") for x in g.succ)
    assert ref_graph.hops_per_node(len(ref), var.counts) == pytest.approx(
        edges / len(g.bases))
    assert np.all(g.succ[:-1] > 0)


def test_the_readers_on_a_profile_by_hand():
    from types import SimpleNamespace

    from portbench import harness

    # two batches: a DC launch of 1 ms each, a copy, an unrelated kernel
    recs = [("void dc_wave_v1<2>(...)", 0, 1_000_000),
            ("Memcpy DtoH (Device -> Pinned)", 1_000_000, 1_500_000),
            ("void at::native::add(...)", 3_000_000, 4_000_000),
            ("void dc_wave_v1<2>(...)", 5_000_000, 6_000_000)]
    work_recs = [("genasm_dc", {"windows": 100_000, "w": 64, "k": 24})] * 2
    prof = harness.Profile(records=recs, kernel_count=3, batches=2, span_s=0.008,
                           busy_s=harness.union_s(r[1:] for r in recs),
                           work=work_recs, host=[("align", 0, 7_000_000)], card=CARD)
    # a window of two batches of 10 reads: 0.5 s of wait, stages by hand
    win = harness.Window(t0=100.0)
    for done, wait in ((102.0, 0.25), (104.0, 0.25)):
        win.record({"done": done, "wait": wait, "reads": 10, "work": work_recs[:1],
                    "stages": [("seed_filter", 0.0, 0.5, None), ("align", 0.5, 1.5, None)]})
    ctx = SimpleNamespace(profile=prof, window=win, setup_s=12.5,
                          roofline=lambda k, n, c: harness._roofline(prof, k, n, c))
    read = {m: harness.load_module(harness.HERE / "metrics" / f"{m}.py").read
            for m in ("genasm_dc_roofline", "device_idle_pct", "launches_per_batch",
                      "reads_per_s", "setup_s", "pipeline_wait_pct", "seed_filter_ms",
                      "align_ms")}
    least = 2 * 100_000 * 12932 / 3.35e12
    assert read["genasm_dc_roofline"](ctx) == pytest.approx(100 * least / 0.002)
    assert read["reads_per_s"](ctx) == 5.0 and read["setup_s"](ctx) == 12.5
    assert read["pipeline_wait_pct"](ctx) == pytest.approx(12.5)
    assert read["seed_filter_ms"](ctx) == 500.0 and read["align_ms"](ctx) == 1000.0
    assert win.launched == {"100000": 2} and win.took == [2.0, 2.0]
    assert read["device_idle_pct"](ctx) == pytest.approx(100 * (1 - 0.0035 / 0.008))
    assert read["launches_per_batch"](ctx) == 1.5
    bd = harness.breakdown(prof)
    assert bd["device_ops"][0][1] == pytest.approx(0.002)
    assert bd["idle_gaps"][0] == ["idle in align", pytest.approx(0.0015)]
