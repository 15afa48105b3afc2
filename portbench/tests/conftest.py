"""Fixtures of the harness's tests: the port and the benchmark on the
path, and a copy of the benchmark's cells shrunk to CPU size."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# CPU sizes: references of tens of kbp, batches of tens of reads
TINY_LENGTH = 30000
TINY_TRAFFIC = dict(batch=48, pool_batches=2, check_per_batch=48,
                    check_block=96, profiled_batches=1)

# the graph mode, which has no cell in ``BENCHMARK.json`` (its runs on the
# card spread too widely for a bound yet): a variation graph over a small
# backbone, the linear cells' index and mapper, and a batch of its own
GRAPH_CONFIG = {
    "name": "graph-tiny", "mode": "graph", "reference_length": 20000,
    "variants": {"per_bp": 200, "snp_ins_del": [2, 1, 1]},
    "index": {"minimizer_w": 10, "minimizer_k": 15, "freq_frac": 0.0002},
    "tiles": {"tile_stride": 64, "tile_margin": 64},
    "mapper": {"p_cap": 160, "w": 64, "o": 24, "k": 24, "filter_bits": 128,
               "filter_k": 12, "max_candidates": 4, "backend": "auto"},
    "kernels": ["bitalign"], "control": {"filter_bits": 64},
    "reduced": []}
GRAPH_CELLS = [("graph-bulk", "bulk"), ("graph-foreign", "foreign90")]


def make_root(path: Path, **traffic) -> Path:
    """A checkout-shaped directory: the benchmark's folders found by name,
    and a ``BENCHMARK.json`` that holds the benchmark's cells and the graph
    cells, with CPU-sized configurations and traffic."""
    shutil.copytree(ROOT / "portbench", path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["reference_length"] = TINY_LENGTH
        (path / c["file"]).write_text(json.dumps(cfg))
    graph_file = "portbench/configs/graph-tiny.json"
    batch = traffic.get("batch", 40)
    (path / graph_file).write_text(json.dumps(
        {**GRAPH_CONFIG, "traffic": {"batch": batch, "check_per_batch": batch}}))
    bench["configs"].append({"name": "graph-tiny", "reduced": [], "file": graph_file})
    bench["workloads"] += [{"name": n, "config": "graph-tiny", "traffic": t,
                            "chips": 1} for n, t in GRAPH_CELLS]
    tdir = path / "portbench" / "traffic"
    for t in {w["traffic"] for w in bench["workloads"]}:
        tr = json.loads((ROOT / "portbench" / "traffic" / f"{t}.json").read_text())
        tr.update(TINY_TRAFFIC, **traffic)
        (tdir / f"{t}.json").write_text(json.dumps(tr))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
