"""The port's observability plane against `repro.obs`, on the CPU.

Each test feeds `repro.obs` and `repro_torch.obs` the same inputs and
compares them exactly: the per-stage ledger and Amdahl report (dict and
rendered text), the analytic kernel counters (the port's ``torch`` /
``cuda_dc`` / ``cuda_dc_v2`` against the reference's ``lax`` /
``pallas_dc`` / ``pallas_dc_v2`` at ``block_bt = batch``: the CUDA DC
kernels launch once a window step over the whole batch), the roofline
report, the HTTP endpoints, the engine's roofline hook and the
launcher's ``--trace-out`` / ``--http-port`` / ``--variants`` /
``--use-kernel`` flags.
"""
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import repro.obs as ref_obs
import repro_torch.obs as obs
from repro.launch import serve_genomics as ref_sg
from repro.serve.metrics import Metrics as RefMetrics
from repro_torch.launch import serve_genomics as sg
from repro_torch.obs.attrib import STAGE_ORDER
from repro_torch.obs.roofline import measured_align_cost, predict_time_s
from repro_torch.serve import EngineConfig, Metrics, ServeEngine

DATA = pathlib.Path(__file__).parent / "data"
GOLDEN_ARGS = ["--ref-len", "3000", "--reads", "10", "--read-len", "100",
               "--batch", "4", "--buckets", "128"]
# the port's backend and the reference's twin with the same counters
TWINS = [("torch", "lax"), ("cuda_dc", "pallas_dc"),
         ("cuda_dc_v2", "pallas_dc_v2")]
ADDED_ROW_KEYS = ("measured_launches", "kernel_s", "pct_of_roof_kernel")


# ------------------------------------------------------------ the ledger --
def _spans(span_cls, rows):
    return [span_cls(name=n, t_start=t0, t_end=t1, span_id=i, parent_id=p,
                     attrs=dict(a)) for n, t0, t1, i, p, a in rows]


LEDGER_CASES = {
    "one_flush": [
        ("flush", 0.0, 1.0, 1, None, {}),
        ("seed_filter", 0.0, 0.6, 2, 1, {}),
        ("align", 0.6, 0.9, 3, 1, {}),
    ],
    "unknown_stage_folds_into_other": [
        ("flush", 0.0, 1.0, 1, None, {}),
        ("mystery", 0.0, 0.2, 2, 1, {}),
        ("encode", 0.2, 0.25, 3, 1, {}),
    ],
    "enqueue_wait_excluded": [
        ("flush", 1.0, 2.0, 1, None, {}),
        ("enqueue_wait", 0.0, 1.0, 2, 1, {}),
        ("enqueue_wait", 0.5, 1.0, 3, 1, {}),
        ("seed_filter", 1.0, 1.4, 4, 1, {}),
        ("align", 1.4, 1.95, 5, 1, {"word_ops": 3.0e7, "hbm_bytes": 2.0e7}),
        ("emit", 1.95, 1.99, 6, 1, {}),
    ],
    "flushes_with_counters": [
        ("flush", 0.0, 1.0, 1, None, {}),
        ("seed_filter", 0.0, 0.3, 2, 1, {}),
        ("align", 0.3, 0.97, 3, 1, {"word_ops": 2.9e7, "hbm_bytes": 2.0e7}),
        ("flush", 1.0, 2.5, 4, None, {}),
        ("seed_filter", 1.0, 1.5, 5, 4, {}),
        ("align", 1.5, 2.4, 6, 4, {"word_ops": 2.9e7, "hbm_bytes": 2.0e7}),
        ("emit", 2.4, 2.45, 7, 4, {}),
        ("align", 3.0, 3.1, 8, None, {}),  # no flush parent
    ],
    "sharded_graph_stages": [
        ("flush", 0.0, 2.0, 1, None, {}),
        ("prefilter", 0.0, 0.1, 2, 1, {}),
        ("dc_filter", 0.1, 0.2, 3, 1, {"dc_rows": 512}),
        ("scatter", 0.2, 0.9, 4, 1, {}),
        ("merge_device", 0.9, 0.91, 5, 1, {}),
        ("merge", 0.91, 0.95, 6, 1, {}),
        ("align_shard", 0.95, 1.9, 7, 1, {"word_ops": 1.0, "hbm_bytes": 0.0}),
    ],
    "whole_flush_in_one_stage": [
        ("flush", 0.0, 1.0, 1, None, {}),
        ("align", 0.0, 1.0, 2, 1, {}),
    ],
}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
@pytest.mark.parametrize("shard_counts", [(2, 4), (2, 4, 8)])
def test_ledger_and_report_match_reference(case, shard_counts):
    rows = LEDGER_CASES[case]
    want = ref_obs.build_ledger(_spans(ref_obs.Span, rows)).report(shard_counts)
    got = obs.build_ledger(_spans(obs.Span, rows)).report(shard_counts)
    assert got.to_dict() == want.to_dict()
    assert obs.render_report(got) == ref_obs.render_report(want)


def test_ledger_from_trace_log_matches_reference():
    """Both fold the ring buffer of a live tracer the same way."""
    logs = []
    for mod in (ref_obs, obs):
        tr = mod.Tracer()
        t0 = 100.0
        with tr.span("flush"):
            tr.add("enqueue_wait", t0 - 0.5, t0, async_=True)
            tr.add("seed_filter", t0, t0 + 0.25)
            tr.add("align", t0 + 0.25, t0 + 0.75, word_ops=10.0)
        logs.append(tr.log)
    want, got = (mod.build_ledger(log) for mod, log in zip((ref_obs, obs),
                                                            logs))
    assert got.total("align") == want.total("align") == 0.5
    assert got.n_flushes == want.n_flushes == 1
    assert got.report().stages == want.report().stages


def test_stage_timer_records_as_the_reference():
    got, want = obs.StageTimer(), ref_obs.StageTimer()
    for timer in (got, want):
        with timer.stage("seed_filter", shard=1):
            pass
        with timer.stage("align"):
            pass
    assert [(n, a) for n, _, _, a in got.times] == \
        [(n, a) for n, _, _, a in want.times]
    assert all(t0 <= t1 for _, t0, t1, _ in got.times)


# -------------------------------------------------------------- counters --
@pytest.mark.parametrize("k", [0, 8, 24, 31])
@pytest.mark.parametrize("w", [32, 64, 96, 128])
@pytest.mark.parametrize("store", ["mid", "r"])
def test_dc_window_counters_match_reference(store, w, k):
    assert obs.dc_window_counters(w, k, store=store) == \
        ref_obs.dc_window_counters(w, k, store=store)


@pytest.mark.parametrize("cap", [64, 128, 160, 320, 640, 1280])
@pytest.mark.parametrize("port,ref", TWINS)
def test_align_counters_match_reference_at_whole_batch_tile(port, ref, cap):
    for batch in (8, 16, 37, 64, 256):
        got = obs.align_counters(port, cap, 24, batch)
        want = ref_obs.align_counters(ref, cap, 24, batch, block_bt=batch)
        for key in ("word_ops", "tb_bytes", "hbm_bytes", "launches",
                    "intensity", "exact"):
            assert getattr(got, key) == getattr(want, key), (key, batch)
        assert got.launches == obs.roofline.n_windows(cap)
        # the port's kernels take no batch tile: its notes drop block_bt
        assert want.notes.pop("block_bt") == batch
        assert got.notes == want.notes
        for name in ("cpu_host", "gpu_generic"):
            assert predict_time_s(got, obs.DeviceSpec.load(name)) == \
                ref_obs.roofline.predict_time_s(
                    want, ref_obs.DeviceSpec.load(name))


def test_ref_oracle_estimate_and_graph_backends_unmodelled():
    assert obs.align_counters("ref", 160, 24, 16).__dict__ == \
        ref_obs.align_counters("ref", 160, 24, 16).__dict__
    for backend in ("graph_torch", "graph_cuda", "lax", "pallas_dc"):
        with pytest.raises(KeyError):
            obs.align_counters(backend, 160, 24, 16)


def test_dc_counters_reject_bad_geometry():
    with pytest.raises(ValueError):
        obs.dc_window_counters(48, 8)
    with pytest.raises(ValueError):
        obs.dc_window_counters(64, 8, store="nope")


# ----------------------------------------------------------------- specs --
def test_bundled_specs_match_reference_and_h100_is_sourced():
    for name in ("cpu_host", "gpu_generic"):
        assert obs.DeviceSpec.load(name).__dict__ == \
            ref_obs.DeviceSpec.load(name).__dict__
    h100 = obs.DeviceSpec.load("h100_sxm")
    assert h100.hbm_bw == 3.35e12 and h100.peak_flops == 989e12
    assert h100.link_bw == 450e9
    # the counted word operations a second that csrc/word_ops.cu ran on
    # the card (its DC mix), not the guide's 64 instructions a clock per SM
    assert h100.peak_word_ops == 6.81e13
    assert "word_ops.cu" in h100.description
    for field in ("hbm_bw", "peak_flops", "link_bw", "peak_word_ops",
                  "launch_overhead_s"):
        assert field in h100.description
    with pytest.raises(ValueError, match="bundled"):
        obs.DeviceSpec.load("tpu_v5e")  # no TPU number enters the port


@pytest.mark.parametrize("device,card,spec", [
    ("cpu", None, "cpu_host"),
    ("cuda:0", "NVIDIA H100 80GB HBM3", "h100_sxm"),
    ("cuda", "NVIDIA H100 NVL", "h100_sxm"),
    ("cuda:0", "NVIDIA H100 PCIe", "gpu_generic"),
    ("cuda:0", "NVIDIA A100-SXM4-80GB", "gpu_generic"),
])
def test_spec_for_device(monkeypatch, device, card, spec):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: card)
    if card is not None:  # a CUDA device must be visible
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert obs.DeviceSpec.for_device(device).name == spec
    rf = obs.RooflineManager(device=device, measure=False)
    assert rf.spec.name == spec
    assert rf.report()["device_spec"]["card"] == (card or "cpu")


# -------------------------------------------------------------- manager --
FLUSHES = [(160, 24, 16, 0.02), (160, 24, 16, 0.03), (320, 24, 16, 0.04),
           (1280, 24, 256, None), (64, 8, 8, 0.001)]


@pytest.mark.parametrize("port,ref", TWINS)
def test_roofline_report_matches_reference(port, ref):
    spec = "cpu_host"
    got_m, want_m = Metrics(), RefMetrics()
    got_tr, want_tr = obs.Tracer(), ref_obs.Tracer()
    got = obs.RooflineManager(spec=obs.DeviceSpec.load(spec), metrics=got_m,
                              tracer=got_tr, measure=False, device="cpu")
    want = ref_obs.RooflineManager(spec=ref_obs.DeviceSpec.load(spec),
                                   metrics=want_m, tracer=want_tr,
                                   measure=False)
    for cap, k, batch, align_s in FLUSHES:
        c = got.record_flush(port, cap, k, batch, align_s=align_s)
        w = want.record_flush(ref, cap, k, batch, align_s=align_s,
                              block_bt=batch)
        assert (c.word_ops, c.hbm_bytes, c.launches) == \
            (w.word_ops, w.hbm_bytes, w.launches)
    g, w = got.report(measure=False), want.report(measure=False)
    card = g["device_spec"].pop("card")
    assert card == "cpu" and g["device_spec"] == w["device_spec"]
    assert len(g["kernels"]) == len(w["kernels"]) == 4
    for gr, wr in zip(g["kernels"], w["kernels"]):
        assert gr["kernel"] == wr["kernel"].replace(ref, port, 1)
        assert gr["backend"] == port and wr["backend"] == ref
        for key in ADDED_ROW_KEYS:
            assert gr.pop(key) is None  # nothing measured
        for key in ("kernel", "backend"):
            gr.pop(key), wr.pop(key)
        assert wr.pop("block_bt") == wr["batch"]  # no batch tile in the port
        assert gr == wr
    # the Metrics counters and the Perfetto counter samples, by name
    assert {k.replace(port, ref, 1): v
            for k, v in got_m.snapshot().items()} == want_m.snapshot()
    assert [(s.name.replace(port, ref, 1), s.attrs) for s in got_tr.log.spans()] \
        == [(s.name, s.attrs) for s in want_tr.log.spans()]


def test_roofline_disabled_and_unmodelled_backends_record_nothing():
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load("cpu_host"),
                             enabled=False, measure=False, device="cpu")
    assert rf.record_flush("torch", 160, 24, 16, align_s=0.01) is None
    assert rf.report()["kernels"] == []
    rf.enabled = True
    assert rf.record_flush("graph_cuda", 160, 24, 16, align_s=0.01) is None
    assert rf.report()["kernels"] == []


@pytest.mark.parametrize("backend", ["torch", "cuda_dc", "cuda_dc_v2"])
def test_measured_side_has_no_kernel_on_the_cpu(backend):
    assert "no CUDA kernel" in measured_align_cost(backend, 64, 8, 8,
                                                   device="cpu")["error"]
    rf = obs.RooflineManager(device="cpu")
    rf.record_flush(backend, 64, 8, 8, align_s=0.005)
    (row,) = rf.report(measure=True)["kernels"]
    assert "no CUDA kernel" in row["measure_error"]
    assert row["measured_launches"] is None and row["kernel_s"] is None
    assert row["pct_of_roof_kernel"] is None


def test_report_folds_a_measurement_into_kernel_columns():
    """``pct_of_roof_kernel`` is analytic ops over the kernels' measured
    device seconds, against the roof at the site's intensity."""
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load("h100_sxm"),
                             measure=False, device="cpu")
    rf.record_flush("cuda_dc_v2", 160, 24, 256, align_s=0.7)
    site = rf.site("cuda_dc_v2", 160, 24, 256)
    site.measured = {"measured_ops": None, "measured_bytes": None,
                     "measured_launches": 6, "measured_kernel_s": 6.84e-5}
    (row,) = rf.report()["kernels"]
    c = site.counters
    roof = rf.spec.roof_ops_per_s(c.intensity)
    assert row["measured_launches"] == 6 and row["kernel_s"] == 6.84e-5
    assert row["pct_of_roof_kernel"] == round(c.word_ops / 6.84e-5 / roof, 6)
    assert 0 < row["pct_of_roof"] < row["pct_of_roof_kernel"] < 1


# ------------------------------------------------------------------ http --
def _get(url: str) -> tuple[int, str]:
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read().decode()


def _traced():
    metrics = Metrics()
    metrics.counter("reads_total").inc(7)
    tr = obs.Tracer()
    with tr.span("flush"):
        with tr.span("align"):
            pass
    return metrics, tr


def test_obs_server_endpoints():
    metrics, tr = _traced()
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load("cpu_host"), device="cpu")
    rf.record_flush("cuda_dc", 160, 24, 16, align_s=0.02)
    with obs.ObsServer(metrics=metrics, tracer=tr, roofline=rf,
                       port=0) as srv:
        assert srv.url.startswith("http://127.0.0.1:")
        assert _get(srv.url + "/healthz") == (200, "ok\n")
        code, body = _get(srv.url + "/metrics")
        assert code == 200 and "reads_total 7" in body
        code, body = _get(srv.url + "/trace?n=1")
        doc = json.loads(body)
        assert code == 200 and [s["name"] for s in doc["spans"]] == ["flush"]
        assert doc["dropped"] == 0
        code, body = _get(srv.url + "/attrib")
        assert code == 200
        assert json.loads(body) == obs.build_ledger(tr.log).report().to_dict()
        code, body = _get(srv.url + "/roofline?measure=0")
        (row,) = json.loads(body)["kernels"]
        assert row["kernel"] == "cuda_dc/cap160" and row["measure_error"] is None
        code, body = _get(srv.url + "/roofline")  # measure=1: no CPU kernel
        (row,) = json.loads(body)["kernels"]
        assert code == 200 and "no CUDA kernel" in row["measure_error"]


def test_obs_server_trace_bad_n_is_400_and_large_n_clamps():
    tr = obs.Tracer(log=obs.TraceLog(max_spans=8))
    for _ in range(12):
        with tr.span("flush"):
            pass
    with obs.ObsServer(tracer=tr, port=0) as srv:
        for bad in ("foo", "-5", "1.5", ""):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.url + f"/trace?n={bad}")
            assert ei.value.code == 400
        code, body = _get(srv.url + "/trace?n=999999999")
        assert code == 200 and len(json.loads(body)["spans"]) == 8
        assert json.loads(body)["dropped"] == 4


@pytest.mark.parametrize("path", ["/metrics", "/trace", "/attrib",
                                  "/roofline", "/nope"])
def test_obs_server_404s(path):
    with obs.ObsServer(port=0) as srv:  # nothing attached
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + path)
        assert ei.value.code == 404


# ---------------------------------------------------------------- engine --
@pytest.fixture(scope="module")
def golden_service():
    return sg.setup(sg.parse_args(GOLDEN_ARGS + ["--device", "cpu"]))


def test_engine_roofline_matches_reference_engine(golden_service):
    """The port's engine on the golden reads, traced, against the
    reference's engine on the same reads with ``lax``."""
    from repro.core import minimizer_index as ref_index
    from repro.serve import EngineConfig as RefConfig
    from repro.serve import ServeEngine as RefEngine

    svc = golden_service
    cfg = dict(buckets=(128,), max_batch=4, minimizer_w=8, minimizer_k=12,
               filter_k=svc.config.filter_k)
    spec = "cpu_host"
    tr = obs.Tracer()
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load(spec), tracer=tr,
                             measure=False, device="cpu")
    with ServeEngine(svc.index, EngineConfig(align_backend="torch", **cfg),
                     tracer=tr, roofline=rf) as eng:
        got_res = eng.map_all(svc.reads)
        got_flushes = eng.metrics.snapshot()["batches_flushed"]
    ref_tr = ref_obs.Tracer()
    ref_rf = ref_obs.RooflineManager(spec=ref_obs.DeviceSpec.load(spec),
                                     tracer=ref_tr, measure=False)
    from repro.genomics import simulate as ref_simulate

    ref_epi = ref_index.build_epoched_index(
        ref_simulate.random_reference(svc.ref_len, seed=1), w=8, k=12)
    with RefEngine(ref_epi, RefConfig(align_backend="lax", **cfg),
                   tracer=ref_tr, roofline=ref_rf) as eng:
        want_res = eng.map_all(svc.reads)
        want_flushes = eng.metrics.snapshot()["batches_flushed"]
    assert [(r.position, r.distance) for r in got_res] == \
        [(r.position, r.distance) for r in want_res]

    (got,) = rf.report(measure=False)["kernels"]
    (want,) = ref_rf.report(measure=False)["kernels"]
    assert got["kernel"] == "torch/cap128" and want["kernel"] == "lax/cap128"
    assert got["calls"] == got_flushes and want["calls"] == want_flushes
    for key in ("bucket_cap", "k", "batch", "launches_per_call",
                "exact", "analytic_ops", "analytic_tb_bytes", "bytes",
                "intensity"):
        assert got[key] == want[key], key
    assert "block_bt" not in got and want["block_bt"] == want["batch"]
    assert got["align_s"] > 0
    rep = obs.build_ledger(tr.log).report()
    assert rep.coverage >= 0.9 and rep.n_flushes == got_flushes
    aligns = [s for s in tr.log.spans() if s.name == "align"]
    assert len(aligns) == got_flushes
    assert all(s.attrs["word_ops"] == got["analytic_ops"] for s in aligns)
    arow = next(r for r in rep.stages if r["stage"] == "align")
    assert arow["word_ops"] == got["analytic_ops"] * got_flushes


@pytest.mark.parametrize("mode,stages", [
    ({"pipelined": True}, {"align"}),
    ({"align_sharded": True}, {"scatter", "merge_device", "align_shard"}),
], ids=["pipelined", "align_sharded"])
def test_sharded_engine_records_roofline(golden_service, mode, stages):
    """The pipelined flush records the align interval it replays; the
    timed sharded flush records its ``align_shard`` interval."""
    svc = golden_service
    tr, m = obs.Tracer(), Metrics()
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load("cpu_host"), tracer=tr,
                             metrics=m, measure=False, device="cpu")
    cfg = EngineConfig(buckets=(128,), max_batch=4, minimizer_w=8,
                       minimizer_k=12, filter_k=svc.config.filter_k,
                       align_backend="cuda_dc_v2", num_shards=2, **mode)
    with ServeEngine(svc.index, cfg, metrics=m, tracer=tr, roofline=rf) as eng:
        assert eng.metrics is m
        eng.map_all(svc.reads)
    (row,) = rf.report(measure=False)["kernels"]
    flushes = m.snapshot()["batches_flushed"]
    assert row["kernel"] == "cuda_dc_v2/cap128" and row["calls"] == flushes
    assert m.snapshot()["kernel_cuda_dc_v2_cap128_launches"] == \
        flushes * row["launches_per_call"]
    names = {s.name for s in tr.log.spans()
             if s.kind in ("span", "async") and s.name != "flush"}
    assert stages <= names <= set(STAGE_ORDER)
    aligns = [s for s in tr.log.spans() if s.name in ("align", "align_shard")]
    assert aligns and all(s.attrs["word_ops"] == row["analytic_ops"]
                          for s in aligns)
    assert row["align_s"] > 0


def test_engine_holds_the_device_lock_around_a_flush(golden_service):
    """While the roofline manager's ``device_lock`` is held (its measured
    run profiling the card), no flush runs; the wait shows in the read's
    ``enqueue_wait``, not inside the flush span."""
    svc = golden_service
    tr = obs.Tracer()
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load("cpu_host"),
                             measure=False, device="cpu")
    cfg = EngineConfig(buckets=(128,), max_batch=1, minimizer_w=8,
                       minimizer_k=12, filter_k=svc.config.filter_k,
                       align_backend="torch")
    with ServeEngine(svc.index, cfg, tracer=tr, roofline=rf) as eng:
        with rf.device_lock:
            fut = eng.submit(svc.reads[0])
            time.sleep(0.3)
            assert not fut.done()
            t_release = time.monotonic()
        assert fut.result(timeout=60).position >= 0
    (wait,) = [s for s in tr.log.spans() if s.name == "enqueue_wait"]
    (flush,) = [s for s in tr.log.spans() if s.name == "flush"]
    assert wait.duration_s >= 0.3 and flush.t_start >= t_release


def test_device_records_are_the_cards_only():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.roofline import device_records

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8) + 1
    assert device_records(prof) == []


def test_graph_engine_is_traced_but_unmodelled(tmp_path):
    out = tmp_path / "g.gaf"
    s = sg.main(["--mode", "graph"] + GOLDEN_ARGS + [
        "--device", "cpu", "--align-backend", "graph_cuda",
        "--trace-out", str(tmp_path / "g.json"), "--out", str(out)])
    assert out.read_bytes() == (DATA / "serve_graph_golden.gaf").read_bytes()
    assert s["roofline"]["kernels"] == []  # no graph model, as the reference
    stages = {r["stage"] for r in s["attrib"]["stages"]}
    assert {"prefilter", "dc_filter", "align"} <= stages


# -------------------------------------------------------------- launcher --
def _trace_stage_names(path) -> set:
    doc = json.loads(pathlib.Path(path).read_text())
    return {e["name"] for e in doc["traceEvents"]
            if e["ph"] in ("X", "b", "e") and e["name"] != "flush"}


@pytest.mark.parametrize("mode,golden", [
    ("linear", "serve_golden.paf"), ("graph", "serve_graph_golden.gaf")])
def test_traced_cli_keeps_the_golden_bytes(tmp_path, capsys, mode, golden):
    trace, out = tmp_path / "t.json", tmp_path / "out"
    s = sg.main(["--mode", mode] + GOLDEN_ARGS + [
        "--device", "cpu", "--trace-out", str(trace), "--http-port", "0",
        "--out", str(out)])
    assert out.read_bytes() == (DATA / golden).read_bytes()
    names = _trace_stage_names(trace)
    assert names and names <= set(STAGE_ORDER)
    text = capsys.readouterr().out
    assert "obs endpoints at http://127.0.0.1:" in text
    assert "stage attribution:" in text and f"wrote {trace}" in text
    assert s["attrib"]["coverage"] >= 0.9
    if mode == "linear":
        (row,) = s["roofline"]["kernels"]
        assert row["kernel"] == "torch/cap128"
        assert "roofline torch/cap128:" in text


def test_variants_flag_matches_the_reference(tmp_path):
    """``--variants 12`` builds another graph (so not the golden GAF) and
    the port's GAF is the reference's at the same flag, traced."""
    argv = ["--mode", "graph"] + GOLDEN_ARGS + ["--variants", "12"]
    want, got = tmp_path / "ref.gaf", tmp_path / "port.gaf"
    ref_sg.main(argv + ["--out", str(want)])
    s = sg.main(argv + ["--device", "cpu", "--trace-out",
                        str(tmp_path / "t.json"), "--http-port", "0",
                        "--out", str(got)])
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes() != (DATA / "serve_graph_golden.gaf").read_bytes()
    assert _trace_stage_names(tmp_path / "t.json") <= set(STAGE_ORDER)
    assert s["mapped"] == 10


def test_explicit_default_variants_is_the_golden_graph(tmp_path):
    out = tmp_path / "g.gaf"
    sg.main(["--mode", "graph"] + GOLDEN_ARGS + [
        "--variants", "15", "--device", "cpu", "--out", str(out)])
    assert out.read_bytes() == (DATA / "serve_graph_golden.gaf").read_bytes()


def test_use_kernel_is_the_cuda_dc_alias(tmp_path):
    out = tmp_path / "k.paf"
    s = sg.main(GOLDEN_ARGS + ["--device", "cpu", "--use-kernel",
                               "--out", str(out)])
    assert s["align_backend"] == "cuda_dc"
    assert out.read_bytes() == (DATA / "serve_golden.paf").read_bytes()


@pytest.mark.parametrize("module", [sg, ref_sg], ids=["port", "reference"])
def test_use_kernel_with_an_explicit_backend_is_an_error(capsys, module):
    argv = GOLDEN_ARGS + ["--use-kernel", "--align-backend", "torch"]
    parse = module.parse_args if module is sg else module.main
    with pytest.raises(SystemExit) as ei:
        parse(argv)
    assert ei.value.code == 2
    assert "deprecated alias" in capsys.readouterr().err


@pytest.mark.parametrize("changed", [
    ["--variants", "12"], ["--ref-len", "3200"], ["--read-len", "120"]])
def test_serve_refuses_setup_fields(changed):
    """A `serve` run may not differ from its `setup` in the reference,
    its variants or anything else outside `PER_RUN_FIELDS`."""
    base = ["--mode", "graph"] + GOLDEN_ARGS + ["--device", "cpu"]
    svc = sg.setup(sg.parse_args(base + ["--reads", "2"]))
    assert svc.variants == 15
    with pytest.raises(ValueError, match="own setup"):
        sg.serve(svc, sg.parse_args(base + changed))


def test_serve_takes_the_callers_tracer_roofline_and_metrics(golden_service):
    """The objects a caller passes are the ones the run fills (what
    chip_smoke.py's own HTTP endpoint reads while the run goes on)."""
    tr, m = obs.Tracer(), Metrics()
    rf = obs.RooflineManager(spec=obs.DeviceSpec.load("cpu_host"), tracer=tr,
                             measure=False, device="cpu")
    args = sg.parse_args(GOLDEN_ARGS + ["--device", "cpu", "--align-backend",
                                        "cuda_dc"])
    seen = []
    with obs.ObsServer(metrics=m, tracer=tr, roofline=rf, port=0) as srv:
        def poll():
            for _ in range(400):
                seen.append(_get(srv.url + "/healthz")[0])
                time.sleep(0.01)

        t = threading.Thread(target=poll)
        t.start()
        s = sg.serve(golden_service, args, tracer=tr, roofline=rf, metrics=m)
        t.join()
        doc = json.loads(_get(srv.url + "/roofline?measure=0")[1])
        attrib = json.loads(_get(srv.url + "/attrib")[1])
    assert seen and set(seen) == {200}
    assert rf.metrics is m and s["metrics"] == m.snapshot()
    assert doc == s["roofline"]
    assert doc["kernels"][0]["calls"] == m.snapshot()["batches_flushed"]
    assert attrib == s["attrib"]
