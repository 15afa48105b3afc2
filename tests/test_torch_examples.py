"""The port's examples (`examples/torch_*.py`) run on the CPU.

Each runs as a user would run it, in a subprocess with ``--device cpu``
(`torch_train_lm.py` for one step, its checkpoints under the test's
temporary directory), and exits 0, so its own final ``assert`` held.
What `torch_quickstart.py` and `torch_edit_distance_demo.py` print (the
distance and CIGAR, the two distances) equals what the reference's
`examples/quickstart.py` and `examples/edit_distance_demo.py` print.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_read_mapping", "torch_graph_alignment",
            "torch_edit_distance_demo", "torch_train_lm")
_RUNS: dict[str, str] = {}


def run(script: str, *args: str) -> str:
    """stdout of ``examples/<script>.py args`` (checked to exit 0)."""
    key = " ".join((script,) + args)
    if key not in _RUNS:
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": str(ROOT / "src")}
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{script}.py"), *args],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        _RUNS[key] = proc.stdout
    return _RUNS[key]


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs_on_the_cpu(script, tmp_path):
    args = ("--device", "cpu")
    if script == "torch_train_lm":
        args += ("--steps", "1", "--ckpt-dir", str(tmp_path / "ck"))
    out = run(script, *args)
    assert out.strip()
    if script == "torch_train_lm":
        assert re.search(r"step\s+0 loss=\S+", out), out
    if script == "torch_read_mapping":
        assert "position-correct:" in out and "on cpu" in out


def _lines(out: str, *prefixes: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


def test_quickstart_prints_the_reference_distance_and_cigar():
    want = _lines(run("quickstart"), "edit distance:", "CIGAR:")
    got = _lines(run("torch_quickstart", "--device", "cpu"),
                 "edit distance:", "CIGAR:")
    assert len(want) == 2 and got == want


def test_edit_distance_demo_prints_the_reference_distances():
    keys = ("sequence lengths:", "GenASM windowed distance:",
            "Myers (Edlib) distance:")
    want = _lines(run("edit_distance_demo"), *keys)
    got = _lines(run("torch_edit_distance_demo", "--device", "cpu"), *keys)
    assert len(want) == 3 and got == want


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_imports_neither_jax_nor_repro(script):
    import ast

    roots = set()
    for node in ast.walk(ast.parse(
            (ROOT / "examples" / f"{script}.py").read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
