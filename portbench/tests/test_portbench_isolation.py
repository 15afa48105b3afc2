"""No module of the benchmark loads JAX or the JAX package, and the
yardstick (reference, generator, counts, readers) loads nothing of the
program.  Top-level names are compared whole: ``repro_torch`` begins
with ``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: what later changes to the program cannot move
YARDSTICK = ["reference", "metrics", "arrivals", "generate.py", "work.py"]


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def files(*parts):
    for p in parts:
        q = BENCH / p
        yield from (sorted(q.rglob("*.py")) if q.is_dir() else [q])


def test_no_module_imports_jax_or_the_jax_package():
    for f in files("."):
        bad = imported_tops(f) & NEVER
        assert not bad, f"{f.relative_to(BENCH)} imports {bad}"


def test_the_yardstick_imports_nothing_of_the_program():
    for f in files(*YARDSTICK):
        assert "repro_torch" not in imported_tops(f), f.relative_to(BENCH)


def test_the_reference_loads_nothing_of_the_program_when_run():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.linear, portbench.reference.graph, "
            "portbench.generate, portbench.work; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}); "
            "print(bad); sys.exit(bool(bad))") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
