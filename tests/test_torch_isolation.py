"""The port stands alone: no JAX and nothing of `repro` in `repro_torch`.

A static scan of every module of `src/repro_torch/` and of
`chip_smoke.py`, a fresh interpreter that imports each entry point (the
service, the edit-distance and SeGraM modules, the obs plane's HTTP
endpoint and roofline layer, the LM trainer, the dry run and its report,
the sharding resolver and the read pipeline), the service's and the
trainer's refusal to fall back to the CPU, and a scan of the port's
tests for an in-process import of `repro.shard`.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


# the model zoo's slices: every module they added is among the scanned
# sources
LM_MODULES = ["configs/__init__.py", "configs/base.py", "configs/genasm.py",
              "configs/internlm2_1_8b.py", "models/layers.py",
              "models/attention.py", "models/frontends.py",
              "models/transformer.py", "models/model_zoo.py",
              "models/convert.py", "models/moe.py", "models/mamba.py",
              "models/rwkv6.py", "models/encdec.py", "train/serve.py",
              "train/optimizer.py", "train/loop.py", "ckpt/checkpoint.py",
              "dist/fault.py", "launch/train.py"]


# the distribution and dry-run slice's modules
DIST_MODULES = ["dist/sharding.py", "train/grad_compress.py", "launch/mesh.py",
                "launch/roofline.py", "launch/dryrun.py", "launch/report.py",
                "genomics/pipeline.py", "align/inputs.py"]


def test_lm_modules_are_scanned():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in SOURCES[:-1]}
    assert set(LM_MODULES) <= scanned, set(LM_MODULES) - scanned
    assert set(DIST_MODULES) <= scanned, set(DIST_MODULES) - scanned
    assert len([p for p in scanned if p.startswith("configs/")]) == 13


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def _imports_nothing_forbidden(module: str) -> None:
    code = (f"import sys; import {module}; "
            "mods = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(mods); assert not mods, mods")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_point_imports_no_jax_or_repro():
    _imports_nothing_forbidden("repro_torch.launch.serve_genomics")


@pytest.mark.parametrize("module", ["repro_torch.core.edit_distance",
                                    "repro_torch.core.segram.segram"])
def test_use_case_module_imports_no_jax_or_repro(module):
    _imports_nothing_forbidden(module)


@pytest.mark.parametrize("module", ["repro_torch.obs.http",
                                    "repro_torch.obs.roofline"])
def test_obs_module_imports_no_jax_or_repro(module):
    _imports_nothing_forbidden(module)


def test_lm_trainer_imports_no_jax_or_repro():
    _imports_nothing_forbidden("repro_torch.launch.train")


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun",
                                    "repro_torch.launch.report",
                                    "repro_torch.dist.sharding",
                                    "repro_torch.genomics.pipeline"])
def test_dist_entry_points_import_no_jax_or_repro(module):
    _imports_nothing_forbidden(module)


def test_lm_trainer_default_device_raises_without_cuda(tmp_path):
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default --device cuda is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-6b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_default_device_raises_without_cuda(tmp_path):
    from repro_torch.launch import serve_genomics

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default --device cuda is valid")
    out = tmp_path / "never.paf"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_genomics.main(["--ref-len", "2000", "--reads", "2",
                             "--out", str(out)])
    assert not out.exists()


def _imports_repro_shard(tree: ast.AST) -> list[str]:
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.split(".")[:2] == ["repro", "shard"]]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = (node.module or "").split(".")
            if mod[:2] == ["repro", "shard"] or (
                    mod == ["repro"] and any(a.name == "shard"
                                             for a in node.names)):
                bad.append(node.module)
    return bad


def test_port_tests_never_import_repro_shard():
    """`repro.shard` runs only in the subprocess of
    tests/torch_shard_reference.py: imported in a test process it would
    stay in `sys.modules`, and the JAX package's own shard tests sharing
    that worker would pass or fail by test order."""
    tests = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(tests) > 10
    for path in tests:
        bad = _imports_repro_shard(ast.parse(path.read_text()))
        assert not bad, f"{path.name} imports {bad}"
    probe = ast.parse("import repro.shard\nfrom repro import shard")
    assert len(_imports_repro_shard(probe)) == 2  # the scan sees both forms
