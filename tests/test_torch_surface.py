"""The port's public surface against the reference's, name by name.

For every module of `src/repro`, every top-level public name (a def, a
class, an assignment, or a name bound by ``from ... import``) must have
a twin of the same name in the same-named module of `src/repro_torch`,
or stand in `KEPT` with its reason.  The reasons are few on purpose:
Pallas tile machinery, JAX-only scopes, TPU constants and HLO parsing,
pytree initialisers that the port's ``nn.Module``s replace, names the
reference re-imports from another package, and a name whose twin would
be a different function.  Beside the scan: fresh interpreters import
`repro_torch.graph` and `repro_torch.align` in either order without
JAX, and the docstring gate of `tools/check_docstrings.py` holds for
the port's twins of its scope and the port's new entry points.
"""
from __future__ import annotations

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

PALLAS = "Pallas tile machinery: no CUDA kernel of the port takes a batch tile"
JAX_SCOPE = "a JAX-only scope (x64 on demand); the port's keys are int64 always"
TPU = "a TPU constant or XLA HLO parsing; the port's terms are launch/roofline's H100 ones"
PYTREE = ("a pytree initialiser; the port's nn.Module (`DecoderLM`, "
          "`EncDecLM`) builds the parameters")
BATCHED = ("the port's `align` takes [B, ...] where the reference's takes one "
           "pair (the reference vmaps it in `align_batch`)")
DIFFERENT = ("a twin would be a different function under this name: the "
             "reference reads dryrun_results.json when the module is "
             "imported; the port reads it in `main`")
ORACLE = ("`kernels/ref.py` is the pure-jnp oracle of the Pallas kernels; "
          "`repro_torch.kernels.ops` plays its role (each KERNELS entry's plain "
          "version)")
# a name the reference binds by ``from <another package> import name``
REIMPORTED = {"partial": "functools", "lax": "jax", "pl": "jax.experimental",
              "P": "jax.sharding", "NamedSharding": "jax.sharding",
              "OrderedDict": "collections"}

KEPT = {
    ("align/__init__.py", "autotune"): PALLAS,
    ("align/__init__.py", "block_size_for"): PALLAS,
    ("align/__init__.py", "clear_autotune_cache"): PALLAS,
    ("align/__init__.py", "needs_interpret"): PALLAS,
    ("align/api.py", "DEFAULT_BT"): PALLAS,
    ("align/api.py", "autotune"): PALLAS,
    ("align/api.py", "block_size_for"): PALLAS,
    ("align/api.py", "clear_autotune_cache"): PALLAS,
    ("align/api.py", "model_seed"): PALLAS,
    ("align/api.py", "needs_interpret"): PALLAS,
    ("kernels/genasm_dc.py", "DEFAULT_BT"): PALLAS,
    ("obs/__init__.py", "predict_block_bt"): PALLAS,
    ("obs/roofline.py", "predict_block_bt"): PALLAS,
    ("obs/roofline.py", "effective_block"): PALLAS,
    ("shard/merge.py", "x64_scope"): JAX_SCOPE,
    ("launch/roofline.py", "HBM_BW"): TPU,
    ("launch/roofline.py", "LINK_BW"): TPU,
    ("launch/roofline.py", "PEAK_FLOPS"): TPU,
    ("launch/roofline.py", "parse_collectives"): TPU,
    ("models/transformer.py", "init_params"): PYTREE,
    ("models/transformer.py", "init_block"): PYTREE,
    ("models/encdec.py", "init_params"): PYTREE,
    ("core/genasm.py", "align"): BATCHED,
    ("launch/report.py", "res"): DIFFERENT,
    **{("kernels/ref.py", name): ORACLE
       for name in ("window_dc_batch", "window_dc_batch_v2",
                    "bitalign_dc_batch", "myers_distance_batch")},
}
# KEPT entries whose name the port does have (with the difference given)
KEPT_WITH_TWIN = {("core/genasm.py", "align")}

GRAPH_EXPORTS = (
    "EpochedGraphIndex", "GraphArrays", "GraphIndex", "GraphMapExecutor",
    "GraphMapResult", "as_graph_text", "batched_graph_align",
    "bitalign_search", "build_epoched_graph_index", "build_graph_index",
    "graph_align", "graph_backend_name", "load_graph_index", "map_batch",
    "map_batch_index", "pack_graph_text", "pack_linear_text",
    "save_graph_index", "tile_prefilter", "tile_rung", "unmapped_result",
    "unpack_graph_text")


def bound_names(path: Path) -> dict[str, str | None]:
    """Top-level public names of a module: name -> the package it is
    imported from (``from M import name``; None for a name it defines).
    A relative or `repro`/`repro_torch` source counts as its own."""
    out: dict[str, str | None] = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for x in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(x, ast.Name):
                        out[x.id] = None
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            own = node.level or (node.module or "").split(".")[0] in (
                "repro", "repro_torch")
            for a in node.names:
                out[a.asname or a.name] = None if own else node.module
    return {k: v for k, v in out.items() if not k.startswith("_")}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", REF_MODULES)
def test_public_names_have_twins(module):
    ref_names = bound_names(REF / module)
    port_path = PORT / module
    port_names = bound_names(port_path) if port_path.exists() else {}
    missing = []
    for name, source in sorted(ref_names.items()):
        if name in port_names or (module, name) in KEPT:
            continue
        if source is not None and REIMPORTED.get(name) == source:
            continue
        missing.append(f"{name} (from {source})" if source else name)
    assert not missing, f"{module}: no twin and no kept difference: {missing}"


def test_kept_differences_are_current():
    for (module, name), reason in KEPT.items():
        assert name in bound_names(REF / module), (module, name)
        port_path = PORT / module
        has_twin = port_path.exists() and name in bound_names(port_path)
        assert has_twin == ((module, name) in KEPT_WITH_TWIN), (module, name)
        assert reason in (PALLAS, JAX_SCOPE, TPU, PYTREE, BATCHED, DIFFERENT,
                          ORACLE)
    for name, pkg in REIMPORTED.items():
        assert any(bound_names(REF / m).get(name) == pkg for m in REF_MODULES), \
            (name, pkg)


def test_graph_exports_match_the_reference():
    ref = set(bound_names(REF / "graph" / "__init__.py"))
    assert ref == set(GRAPH_EXPORTS)
    assert set(GRAPH_EXPORTS) <= set(bound_names(PORT / "graph" / "__init__.py"))


FRESH = f"""
import sys
import {{first}}
from repro_torch.graph import ({", ".join(GRAPH_EXPORTS)})
import repro_torch.align as align
assert "graph_cuda" in align.available_backends()
assert "graph_torch" in align.available_backends()
assert align.get_backend("graph_cuda").fn is batched_graph_align
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("first", ["repro_torch.graph", "repro_torch.align",
                                   "repro_torch.core.mapper",
                                   "repro_torch.graph.mapper"])
def test_fresh_interpreter_imports_either_order(first):
    proc = subprocess.run(
        [sys.executable, "-c", FRESH.format(first=first)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _check_docstrings():
    spec = importlib.util.spec_from_file_location(
        "check_docstrings", ROOT / "tools" / "check_docstrings.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DOC_SCOPE = sorted(
    {m.replace("src/repro/", "src/repro_torch/")
     for m in _check_docstrings().SCOPE}
    | {f"src/repro_torch/{m}" for m in (
        "graph/__init__.py", "graph/backends.py", "core/mapper.py",
        "core/edit_distance.py", "core/myers.py", "kernels/ops.py")})


@pytest.mark.parametrize("module", DOC_SCOPE)
def test_port_docstring_gate(module):
    tool = _check_docstrings()
    assert tool.check_file(ROOT / module) == []


def test_nested_slot_remat_twin_gives_the_same_gradients(monkeypatch):
    """`transformer.NESTED_SLOT_REMAT`, the reference's knob, checkpoints
    each slot of a multi-slot block; on or off, the loss and gradients
    are the same."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import model_zoo, transformer

    cfg = reduced(get_config("jamba-1.5-large-398b"), n_layers=8)
    assert len(cfg.pattern) > 1
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    batch = dict(tokens=tokens, targets=torch.roll(tokens, -1, 1),
                 mask=torch.ones(2, 32))
    runs = []
    for nested in (False, True):
        monkeypatch.setattr(transformer, "NESTED_SLOT_REMAT", nested)
        model = model_zoo.init(cfg, device="cpu")
        loss, _ = model_zoo.loss_fn(cfg, model, batch, remat=True)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in model.parameters()]))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_shardify_gives_each_spec_its_placements():
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import dryrun

    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    got = dryrun.shardify(mesh, {"w": ("data", None),
                                 "blocks": {"wo": (None, "model")},
                                 "b": (None,)})
    assert got == {"w": (Shard(0), Replicate()),
                   "blocks": {"wo": (Replicate(), Shard(1))},
                   "b": (Replicate(), Replicate())}
