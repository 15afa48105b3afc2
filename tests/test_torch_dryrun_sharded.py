"""The sharded dry run at full width: `repro_torch.launch.dryrun` as rank 0
of a fake process group, one process per arch and mesh (a process's
group has one world size).

One arch per family — dense (yi-6b), vision stub (internvl2-1b), MoE
(mixtral-8x7b), Mamba hybrid (jamba), RWKV-6 (rwkv6-7b),
encoder-decoder (seamless-m4t-medium) — runs every cell (train,
prefill, decode, and long_500k where the arch has it) on the 16x16 mesh
through the module's own entry point (``--arch A --multi-pod single``),
at the dry run's cuts (one and two blocks, LOOP_SEQ tokens where a slot
loops over time); internvl2-1b's train cell runs on 2x16x16 too.  Every
cell: no error, a sharded record, ``collectives`` and
``memory.measured``; train cells issue collectives; no 16x16 cell has
cross-pod bytes and the 2x16x16 train cell has; rank 0's measured peak
extended to full depth is at least the spec count of its shard bytes,
and a cell whose step was cut to LOOP_SEQ tokens claims no measured fit.
The processes run at most three at a time, each with its own timeout.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("jamba-1.5-large-398b", "rwkv6-7b", "seamless-m4t-medium",
            "mixtral-8x7b", "yi-6b", "internvl2-1b")
# (name, dryrun arguments, timeout s), the longest first
RUNS = [("multi_internvl2-1b_train", ["--arch", "internvl2-1b", "--shape",
                                      "train_4k", "--multi-pod", "multi"], 600)]
RUNS += [(f"single_{a}", ["--arch", a, "--multi-pod", "single"], 600)
         for a in FAMILIES]
AT_ONCE = 3


def _run(out: Path, name: str, args: list[str], timeout: float) -> int:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    with open(out / f"{name}.log", "w") as log:
        try:
            return subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--results", str(out / f"{name}.json")],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            return -1


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_sharded")
    with ThreadPoolExecutor(AT_ONCE) as pool:
        codes = dict(zip([n for n, *_ in RUNS],
                         pool.map(lambda r: _run(out, *r), RUNS)))
    failed = {n: (out / f"{n}.log").read_text()[-3000:]
              for n, code in codes.items() if code}
    assert not failed, failed
    res = {}
    for name, *_ in RUNS:
        res.update(json.loads((out / f"{name}.json").read_text()))
    return res


def test_every_family_and_kind_ran_sharded(records):
    kinds = {(r["arch"], r["shape"].split("_")[0]) for r in records.values()}
    for arch in FAMILIES:
        assert {(arch, k) for k in ("train", "prefill", "decode")} <= kinds
    assert "internvl2-1b|train_4k|2x16x16" in records
    for key, r in records.items():
        assert "error" not in r, (key, r.get("error"))
        sharded = r["sharded"]
        assert sharded["error"] is None, (key, sharded.get("trace"))
        assert sharded["lower_blocks"] == r["lower_blocks"], key
        assert sharded.get("lower_seq") == r.get("lower_seq"), key
        assert sharded["lower_s"] > 0
        assert r["collectives"] is not None and r["memory"]["measured"], key


def test_collectives_of_each_cell(records):
    for key, r in records.items():
        c = r["collectives"]
        assert c["link_bytes"] == pytest.approx(
            c["cross_pod_bytes"] + c["intra_pod_bytes"]), key
        if r["shape"] == "train_4k":
            assert c["n_ops"] > 0 and c["per_kind_bytes"]["all_reduce"] > 0, key
        if r["mesh"] == "16x16":
            assert c["cross_pod_bytes"] == 0, key
        else:
            assert c["cross_pod_bytes"] > 0, key
        n_blocks = int(r["lower_blocks"].split(" of ")[1].split()[0])
        assert c["loop_trip_correction"] == n_blocks, key


def test_measured_peak_covers_the_spec_count(records):
    for key, r in records.items():
        mem = r["memory"]
        measured = mem["measured"]
        assert measured["peak_bytes_full_depth_est"] >= mem["per_device_total"], key
        if r.get("lower_seq"):  # activations of the cut length: no fit
            assert measured["fits_measured"] is None, key
            assert measured["lower_seq"] == r["lower_seq"], key
            assert r["collectives"]["lower_seq"] == r["lower_seq"], key
        else:
            assert measured["fits_measured"] == (
                measured["peak_bytes_full_depth_est"] <= mem["hbm_bytes"]), key
        if r["shape"] == "train_4k":
            assert measured["peak_bytes_2_blocks"] > measured["peak_bytes_1_block"]
