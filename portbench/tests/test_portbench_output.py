"""The shape of a run's output, the command's refusals, and a whole run
at CPU size against the plain reference."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from conftest import make_root
from portbench import harness
from portbench import run as entry

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def cpu_run(root, workload, seconds=12.0, trace=0, **kw):
    args = types.SimpleNamespace(workload=workload, seed=2 ** 31 + 77,
                                 seconds=seconds, trace=trace,
                                 t_start=time.perf_counter())
    return harness.run(args, device="cpu", root=root, **kw)


@pytest.mark.parametrize("workload", ["linear-bulk", "graph-bulk"])
def test_a_cpu_run_is_correct_and_its_result_well_formed(tiny_root, workload):
    out = cpu_run(tiny_root, workload)
    r = out["result"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["checks"]["checked_reads"]["value"] >= 80
    assert out["info"]["mapped_share"] > 0.8  # every read comes from the deployment
    # the graph configuration fixes its own batch over the traffic's
    assert out["info"]["batch"] == (40 if workload == "graph-bulk" else 48)
    json.dumps(r)


def test_a_traced_cpu_run_reports_the_per_layer_metrics_it_can_read(tiny_root):
    r = cpu_run(tiny_root, "linear-bulk", trace=1)["result"]
    # on the CPU there is no device trace: its readers return nothing
    assert set(r["metrics"]) == {"pipeline_wait_pct", "seed_filter_ms", "align_ms"}
    assert r["correct"] is True


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, monkeypatch, capsys):
    root = make_root(tmp_path / "root")
    stub = tmp_path / "stubs" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    (root / "portbench" / "metrics" / "loads_jax.py").write_text(
        "def read(ctx):\n    import jax  # noqa: F401\n\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "loads_jax", "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "pipeline",
                               "moves": "reads_per_s", "workloads": ["linear-bulk"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "jax" not in sys.modules
    try:
        out = cpu_run(root, "linear-bulk", trace=1)
        capsys.readouterr()
        rc = entry.report(out)
    finally:
        sys.modules.pop("jax", None)
    assert out["result"]["correct"] is False
    assert out["info"]["forbidden_modules"] == ["jax"]
    assert rc != 0
    printed = capsys.readouterr()
    assert printed.out == "" and "jax" in printed.err


def test_report_prints_the_result_last(tiny_root, capsys):
    out = cpu_run(tiny_root, "linear-bulk")
    capsys.readouterr()
    assert entry.report(out) == 0
    printed = capsys.readouterr()
    assert json.loads(printed.out.splitlines()[-1]) == out["result"]
    assert printed.err.splitlines()[-2:] == ["check mismatched_reads 0 limit 0",
                                             f"check checked_reads "
                                             f"{out['result']['checks']['checked_reads']['value']} limit 1"]


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "linear-bulk", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_with_only_the_benchmark_beside_it(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "linear-bulk", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_is_well_formed():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["portbench"]
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "reads_per_s"} <= e2e
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        tr = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        assert (ROOT / "portbench" / "arrivals" / f"{tr['arrivals']}.py").is_file()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    for w in b["workloads"]:
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024
