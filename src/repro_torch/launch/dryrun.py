"""Multi-pod dry run: every (arch × shape × mesh) cell, checked without the pod.

Port of `repro.launch.dryrun`.  For each cell, on the production mesh
shapes (16×16 ``("data", "model")``, 256 H100s; 2×16×16 ``("pod",
"data", "model")``, 512):

* the parameters, the AdamW moments, the batch and the decode state are
  built on ``meta`` at full size (`model_zoo.init(device="meta")`,
  `model_zoo.input_specs`), and every spec is resolved on the mesh
  shape (`dist.sharding` against `launch.mesh.production_shape`: no
  process group, no card);
* ``memory``: each tensor's local shard bytes on one H100 (its bytes
  over the product of the mesh axes its spec names), summed by kind and
  in all, and whether the sum fits the card's 80 GB (8e10 bytes).
  Activations are not counted: nothing is compiled, so no temp size
  exists (the reference's ``memory_analysis`` has one);
* ``analytic``: the roofline terms of `launch/roofline.py` for 256 or
  512 H100s (the ``h100_sxm`` spec);
* ``lower_s``: the seconds to run the cell's step on ``meta`` at the
  global shapes (train: `train/loop.build_train_step`'s step, forward
  and backward of every microbatch and the AdamW update; prefill;
  decode), the port's stand-in for the reference's lowering.  The step
  does not depend on the mesh, so it runs once per (arch, shape) and
  both mesh records carry that time.  The reference's lowering traces
  each ``lax.scan`` body once; eager PyTorch on ``meta`` runs every trip
  (~0.1–5 ms an op through the shape functions; yi-6b ``train_4k`` at
  full depth 17 s, mixtral 62 s), so the step runs one block (the scan
  over blocks traced once; the record says so in ``lower_blocks``).
  RWKV-6's WKV recurrence takes a trip a token and Mamba's scan a trip
  a chunk, so even one block is slow there (rwkv6-7b ``train_4k`` 125 s,
  jamba 80 s, on this module's host CPU): a train or prefill step of an
  arch with a ``rwkv`` or ``mamba`` slot runs at ``LOOP_SEQ`` tokens, and
  the record says so in ``lower_seq``.  ``memory`` and ``analytic``
  keep the cell's full shape.

``memory`` counts what the specs place, no more.  The hand
redistributions of `dist/sharding.py` hold more on a rank than its
shard: the embedding gather and the chunked loss take whole tensors,
the MoE combine works on replicated expert outputs, and attention
replicates q, k and v over "model" wherever the KV heads do not divide
it (every arch but seamless-m4t-medium on the 16-way axis:
`attention._on_shards`).  So ``fits`` is an under-count for a step.

Without counterpart, written as null: ``compile_s`` (eager PyTorch
compiles no whole-step program), ``cost`` (XLA's ``cost_analysis``;
the analytic terms stand for it) and ``collectives`` (parsed from XLA
HLO text, which the port never produces).  ``--no-compile`` is kept for
the reference's command lines and changes nothing.

Resumable: results accrue in ``dryrun_results_torch.json`` at the repo
root (gitignored; ``--results`` names another file), never in the
reference's ``dryrun_results.json``; rerun with ``--skip-done`` after an
interruption.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model_zoo
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import serve as serve_mod

RESULTS = Path(__file__).resolve().parents[3] / "dryrun_results_torch.json"
HBM_BYTES = 80e9  # one H100's 80 GB
LOOP_SEQ = 256  # a train or prefill step's tokens where a slot loops over time


def microbatches_for(cfg, shape) -> int:
    """Gradient-accumulation depth: keep per-microbatch boundary activations
    ~1 GB a device (the reference's memory plan)."""
    if shape.kind != "train":
        return 1
    big = cfg.d_model >= 8192 or cfg.n_layers >= 90
    return 8 if big else (4 if cfg.d_model >= 4096 else 2)


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def local_bytes(t: torch.Tensor, spec, sizes: dict[str, int]) -> int:
    """One device's shard of ``t`` under ``spec`` (``_fit`` only shards a
    dim that the axes divide, so this is exact)."""
    parts = 1
    for w in spec:
        for a in ((w,) if isinstance(w, str) else tuple(w or ())):
            parts *= sizes[a]
    return t.numel() * t.element_size() // parts


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def cell_state(cfg, shape, *, blocks: int | None = None):
    """The cell's tensors on ``meta``: (cfg run, model, opt state or None,
    inputs).  ``blocks`` cuts the depth to that many blocks."""
    run_cfg = cfg if blocks is None else replace(
        cfg, n_layers=blocks * len(cfg.pattern))
    model = model_zoo.init(run_cfg, device="meta")
    opt = None
    if shape.kind == "train":
        opt = opt_mod.init(opt_mod.AdamWConfig(), dict(model.named_parameters()))
    return run_cfg, model, opt, model_zoo.input_specs(run_cfg, shape)


def memory_record(cfg, shape, sizes) -> dict:
    """Local shard bytes per device at full size, by kind."""
    _, model, opt, specs = cell_state(cfg, shape)
    named = dict(model.named_parameters())
    pspecs = shd.param_specs(named, sizes)
    out = {"param_bytes": sum(local_bytes(p, pspecs[k], sizes)
                              for k, p in named.items())}
    out["opt_bytes"] = 0 if opt is None else sum(
        local_bytes(opt[m][k], pspecs[k], sizes)
        for m in ("m", "v") for k in named)
    batch = specs["batch"]
    bspecs = shd.batch_specs(batch, sizes)
    out["batch_bytes"] = sum(local_bytes(a, bspecs[k], sizes)
                             for k, a in batch.items())
    out["state_bytes"] = 0
    if "state" in specs:
        sspecs = shd.state_specs(specs["state"], sizes)
        out["state_bytes"] = sum(local_bytes(a, _spec_at(sspecs, path), sizes)
                                 for path, a in _leaves(specs["state"]))
    total = sum(out.values())
    out.update(per_device_total=total, hbm_bytes=HBM_BYTES,
               fits=total <= HBM_BYTES)
    return out


def run_step(cfg, shape, blocks: int | None = 1) -> dict:
    """The cell's step on ``meta`` at the global shapes, timed, at
    ``blocks`` blocks (None: all); a train or prefill step of an arch
    that loops over time runs at ``LOOP_SEQ`` tokens."""
    if blocks is not None and blocks >= cfg.n_blocks:
        blocks = None
    full_seq = shape.seq_len
    if shape.kind != "decode" and {"rwkv", "mamba"} & set(cfg.pattern):
        shape = replace(shape, seq_len=min(LOOP_SEQ, full_seq))
    run_cfg, model, opt, specs = cell_state(cfg, shape, blocks=blocks)
    t0 = time.perf_counter()
    if shape.kind == "train":
        tcfg = train_loop.TrainConfig(
            microbatches=microbatches_for(cfg, shape),
            sp=cfg.d_model >= 8192 or cfg.n_layers >= 90)
        step = train_loop.build_train_step(run_cfg, tcfg)
        step(model, opt, specs["batch"])
    elif shape.kind == "prefill":
        serve_mod.build_prefill_step(run_cfg)(model, specs["batch"])
    else:
        serve_mod.build_decode_step(run_cfg)(model, specs["state"],
                                             specs["batch"], shape.seq_len - 1)
    rec = {"lower_s": time.perf_counter() - t0}
    if blocks is not None:
        rec["lower_blocks"] = f"{blocks} of {cfg.n_blocks} blocks"
    if shape.seq_len != full_seq:
        rec["lower_seq"] = f"{shape.seq_len} of {full_seq} tokens"
    return rec


def analytic_record(cfg, shape, chips: int) -> dict:
    if shape.kind == "train":
        an = rf.train_analytic(cfg, shape, chips,
                               microbatches=microbatches_for(cfg, shape))
    else:
        an = rf.serve_analytic(cfg, shape, chips,
                               prefill=shape.kind == "prefill")
    t = rf.terms(an.flops, an.hbm_bytes, an.coll_bytes, chips)
    return {
        "flops_global": an.flops, "hbm_bytes_global": an.hbm_bytes,
        "coll_bytes_global": an.coll_bytes, **t,
        "model_flops_6nd": an.notes.get("model_flops_6nd", 0.0),
        "useful_ratio_6nd": (
            an.notes.get("model_flops_6nd", 0.0) / an.flops if an.flops else 0.0),
        "params_total": an.notes.get("params_total", 0.0),
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               step: dict | None = None) -> dict:
    """One cell's record; ``step`` reuses a ``run_step`` record of the same
    (arch, shape)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    sizes = production_shape(multi_pod=multi_pod)
    chips = math.prod(sizes.values())
    step = run_step(cfg, shape) if step is None else step
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
            "chips": chips, **step, "compile_s": None, "cost": None,
            "collectives": None,
            "memory": memory_record(cfg, shape, sizes),
            "analytic": analytic_record(cfg, shape, chips)}


def load_results(path: Path = RESULTS) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(res: dict, path: Path = RESULTS):
    path.write_text(json.dumps(res, indent=1))


def main(argv=None, *, results: Path = RESULTS) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--results", type=Path, default=results,
                    help="the results file (default: the repo's "
                         "dryrun_results_torch.json)")
    args = ap.parse_args(argv)
    results = args.results

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    res = load_results(results)
    for arch in archs:
        shapes = [args.shape] if args.shape else cells(arch)
        for shape_name in shapes:
            step = None
            for mp in meshes:
                key = f"{arch}|{shape_name}|{mesh_name(mp)}"
                if args.skip_done and key in res and "error" not in res[key]:
                    print(f"skip {key}")
                    continue
                print(f"=== {key} ===", flush=True)
                try:
                    if step is None:
                        step = run_step(get_config(arch), get_shape(shape_name))
                    rec = lower_cell(arch, shape_name, mp, step=step)
                    print(json.dumps({"lower_s": rec["lower_s"],
                                      "memory": rec["memory"]}), flush=True)
                except Exception as e:  # record and continue
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name(mp),
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print("ERROR:", rec["error"], flush=True)
                res[key] = rec
                save_results(res, results)
    errs = [k for k, v in res.items() if "error" in v]
    print(f"\n{len(res)} cells recorded, {len(errs)} errors")
    for k in errs:
        print("  FAIL:", k, res[k]["error"][:120])
    return res


if __name__ == "__main__":
    main()
