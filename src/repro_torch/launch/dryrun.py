"""Multi-pod dry run: every (arch × shape × mesh) cell, checked without the pod.

Port of `repro.launch.dryrun`.  For each cell, on the production mesh
shapes (16×16 ``("data", "model")``, 256 H100s; 2×16×16 ``("pod",
"data", "model")``, 512):

* the parameters, the AdamW moments, the batch and the decode state are
  built on ``meta`` at full size (`model_zoo.init(device="meta")`,
  `model_zoo.input_specs`), and every spec is resolved on the mesh
  shape (`dist.sharding` against `launch.mesh.production_shape`; no
  card);
* ``memory``: each tensor's local shard bytes on one H100 (its bytes
  over the product of the mesh axes its spec names), summed by kind and
  in all, and whether the sum fits the card's 80 GB (8e10 bytes).
  Activations are not counted here (the sharded step measures them,
  below; the reference's ``memory_analysis`` has a temp size);
* ``analytic``: the roofline terms of `launch/roofline.py` for 256 or
  512 H100s (the ``h100_sxm`` spec);
* ``lower_s``: the seconds to run the cell's step on ``meta`` at the
  global shapes (train: `train/loop.build_train_step`'s step, forward
  and backward of every microbatch and the AdamW update; prefill;
  decode), the port's stand-in for the reference's lowering.  This
  mesh-free step does not depend on the mesh, so it runs once per
  (arch, shape) and both mesh records carry that time.  The reference's lowering traces
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
`attention._on_shards`).  So ``fits`` is an upper count for a step.

The sharded step (``sharded_record``): each cell's step also runs with
its mesh's placements, as rank 0 of a fake process group of 256 or 512
ranks (`launch/mesh.fake_production_mesh`; collectives return at once
and move no data), on ``meta``, at 1 and at 2 blocks with the
``LOOP_SEQ`` cut of the mesh-free step.  It fills

* ``sharded``: its ``lower_s`` at 1 block (and ``lower_s_2_blocks``),
  its cuts, and ``error`` (null, or the exception with the tail of its
  traceback in ``trace``; the loop goes on);
* ``collectives``: rank 0's functional collectives
  (`launch/rank_trace.CollectiveCounter`: ``n_ops``,
  ``per_kind_bytes``, the ring-weighted ``link_bytes`` split into
  ``cross_pod_bytes`` and ``intra_pod_bytes``), extended linearly from
  1 and 2 blocks to all blocks (``loop_trip_correction``) — the
  reference parses them from XLA's HLO instead;
* ``memory.measured``: rank 0's peak of live local bytes
  (`launch/rank_trace.LiveBytes`), extended to full depth
  (``peak_bytes_full_depth_est``, its ``method``) and held against
  80 GB (``fits_measured``), beside the spec count.

A step cut to ``LOOP_SEQ`` tokens (RWKV-6's and jamba's train and
prefill cells) is extended over blocks, not over tokens: its
``collectives`` and ``memory.measured`` carry ``lower_seq``, their
activation bytes are the cut length's, and its ``fits_measured`` is
null, so those cells are left out of the measured fit count.

The tracing modes add Python work to every op, so the sharded
``lower_s`` is a host time of the instrumented step.  A fake group's
world size is fixed while it lives: ``--multi-pod both`` (the default)
runs the two meshes one after the other in one process; run
``--multi-pod single`` and ``multi`` in two processes (or ``--arch``
per process) to run them side by side.

Without counterpart, written as null: ``compile_s`` (eager PyTorch
compiles no whole-step program) and ``cost`` (XLA's ``cost_analysis``;
the analytic terms stand for it).  ``--no-compile`` is kept for the
reference's command lines and changes nothing.

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
from repro_torch.launch import rank_trace
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import fake_production_mesh, production_shape
# a name the reference module binds too
from repro_torch.launch.mesh import make_production_mesh  # noqa: F401
from repro_torch.models import model_zoo
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import serve as serve_mod

DOC = __doc__  # the reference keeps this text under that name
RESULTS = Path(__file__).resolve().parents[3] / "dryrun_results_torch.json"
HBM_BYTES = 80e9  # one H100's 80 GB
LOOP_SEQ = 256  # a train or prefill step's tokens where a slot loops over time


def shardify(mesh, spec_tree):
    """Each spec of a ``{name: spec}`` tree (nested dicts allowed) as its
    DTensor placements on ``mesh``: the port's form of the reference's
    tree of ``NamedSharding``."""
    if isinstance(spec_tree, dict):
        return {k: shardify(mesh, v) for k, v in spec_tree.items()}
    return shd.placements(spec_tree, mesh)


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


def memory_record(cfg, shape, sizes, *, blocks: int | None = None) -> dict:
    """Local shard bytes per device at full size (or at ``blocks``
    blocks), by kind."""
    _, model, opt, specs = cell_state(cfg, shape, blocks=blocks)
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


def step_shape(cfg, shape):
    """The shape a cell's step runs at: a train or prefill step of an arch
    whose slots loop over time takes ``LOOP_SEQ`` tokens."""
    if shape.kind != "decode" and {"rwkv", "mamba"} & set(cfg.pattern):
        return replace(shape, seq_len=min(LOOP_SEQ, shape.seq_len))
    return shape


def train_config(cfg, shape) -> train_loop.TrainConfig:
    return train_loop.TrainConfig(
        microbatches=microbatches_for(cfg, shape),
        sp=cfg.d_model >= 8192 or cfg.n_layers >= 90)


def cut_record(cfg, shape, blocks: int | None) -> dict:
    """How far a step was cut: ``lower_blocks`` and ``lower_seq``."""
    rec = {}
    if blocks is not None:
        rec["lower_blocks"] = f"{blocks} of {cfg.n_blocks} blocks"
    run = step_shape(cfg, shape)
    if run.seq_len != shape.seq_len:
        rec["lower_seq"] = f"{run.seq_len} of {shape.seq_len} tokens"
    return rec


def run_step(cfg, shape, blocks: int | None = 1) -> dict:
    """The cell's step on ``meta`` at the global shapes, timed, at
    ``blocks`` blocks (None: all); a train or prefill step of an arch
    that loops over time runs at ``LOOP_SEQ`` tokens."""
    if blocks is not None and blocks >= cfg.n_blocks:
        blocks = None
    run_cfg, model, opt, specs = cell_state(cfg, step_shape(cfg, shape),
                                            blocks=blocks)
    t0 = time.perf_counter()
    if shape.kind == "train":
        step = train_loop.build_train_step(run_cfg, train_config(cfg, shape))
        step(model, opt, specs["batch"])
    elif shape.kind == "prefill":
        serve_mod.build_prefill_step(run_cfg)(model, specs["batch"])
    else:
        serve_mod.build_decode_step(run_cfg)(model, specs["state"],
                                             specs["batch"], shape.seq_len - 1)
    return {"lower_s": time.perf_counter() - t0,
            **cut_record(cfg, shape, blocks)}


def run_sharded(cfg, shape, mesh, blocks: int) -> dict:
    """The cell's step with its mesh's placements, as rank 0 of the fake
    group of ``mesh``, on ``meta`` at ``blocks`` blocks (and the
    ``LOOP_SEQ`` cut of ``run_step``): train on parameters, moments and a
    batch placed by `dist.sharding.shard_put`; prefill and decode on
    parameters, batch and decode state placed by their specs.  Returns the
    seconds, rank 0's peak live bytes (`rank_trace.LiveBytes`) and its
    collectives (`rank_trace.CollectiveCounter`)."""
    run_shape = step_shape(cfg, shape)
    run_cfg, model, opt, specs = cell_state(cfg, run_shape, blocks=blocks)
    pspecs = shd.param_specs(model, mesh)
    shd.shard_put(model, mesh, pspecs)
    batch = shd.shard_put(specs["batch"], mesh,
                          shd.batch_specs(specs["batch"], mesh))
    held = [list(model.parameters()), batch]
    if opt is not None:
        opt = {"step": opt["step"], "m": shd.shard_put(opt["m"], mesh, pspecs),
               "v": shd.shard_put(opt["v"], mesh, pspecs)}
        held.append(opt)
    if "state" in specs:
        state = shd.shard_state(specs["state"], mesh)
        held.append(state)
    with rank_trace.LiveBytes(held) as mem, \
            rank_trace.CollectiveCounter(mesh) as coll:
        t0 = time.perf_counter()
        if shape.kind == "train":
            train_loop.build_train_step(run_cfg, train_config(cfg, shape),
                                        mesh)(model, opt, batch)
        elif shape.kind == "prefill":
            serve_mod.build_prefill_step(run_cfg, mesh)(model, batch)
        else:
            serve_mod.build_decode_step(run_cfg, mesh)(
                model, state, batch, shape.seq_len - 1)
        seconds = time.perf_counter() - t0
    return {"s": seconds, "peak_bytes": mem.peak, **coll.summary()}


def _extend(one, two, n: int):
    """A count at 1 and 2 blocks, extended linearly to ``n`` blocks."""
    return one + (n - 1) * (two - one)


def sharded_record(cfg, shape, mesh, sizes, spec_total: int) -> dict:
    """A cell's ``sharded`` record, its ``collectives`` and its
    ``memory.measured``, from ``run_sharded`` at 1 and 2 blocks;
    ``spec_total`` is the cell's ``memory.per_device_total``.

    Collectives: every count and byte total extended linearly to
    ``n_blocks`` (a block adds the same collectives to every
    microbatch, and every microbatch runs; the reference's
    ``parse_collectives`` multiplies a loop body's collectives by the
    trip count instead).  Memory: a train step keeps every block's
    boundary activations for the backward, so its peak is extended
    linearly from 1 and 2 blocks; prefill and decode hold one block's
    activations at a time, so their estimate is the one-block peak plus
    the spec bytes of the blocks that did not run.

    A step cut to ``LOOP_SEQ`` tokens is extended over blocks only: its
    activation bytes and the collectives that move activations are those
    of the cut length, so both records carry ``lower_seq`` and the method
    says so, and ``fits_measured`` is null (no fit is claimed).
    """
    n = cfg.n_blocks
    seq = cut_record(cfg, shape, 1).get("lower_seq")
    at_seq = "" if seq is None else (
        f"; at {seq}: activations and their collectives grow with the "
        "tokens, so this is not the cell's figure")
    runs = [run_sharded(cfg, shape, mesh, b) for b in (1, 2)]
    one, two = runs
    kinds = sorted(set(one["per_kind_bytes"]) | set(two["per_kind_bytes"]))
    coll = {k: _extend(one[k], two[k], n) for k in
            ("n_ops", "link_bytes", "cross_pod_bytes", "intra_pod_bytes")}
    coll["per_kind_bytes"] = {
        k: _extend(one["per_kind_bytes"].get(k, 0.0),
                   two["per_kind_bytes"].get(k, 0.0), n) for k in kinds}
    coll.update(loop_trip_correction=n,
                microbatches=microbatches_for(cfg, shape),
                method="runs at 1 and 2 blocks, extended linearly to "
                       f"{n} blocks; rank 0's bytes of each op's result"
                       + at_seq,
                per_run={str(b): {k: r[k] for k in (
                    "n_ops", "per_kind_bytes", "cross_pod_bytes",
                    "intra_pod_bytes")} for b, r in zip((1, 2), runs)})
    if shape.kind == "train":
        est = _extend(one["peak_bytes"], two["peak_bytes"], n)
        method = "train: peaks at 1 and 2 blocks, extended linearly"
    else:
        rest = spec_total - memory_record(cfg, shape, sizes,
                                          blocks=1)["per_device_total"]
        est = one["peak_bytes"] + rest
        method = ("the one-block peak plus the spec bytes of the "
                  f"{n - 1} blocks that did not run")
    measured = {"peak_bytes_1_block": one["peak_bytes"],
                "peak_bytes_2_blocks": two["peak_bytes"],
                "peak_bytes_full_depth_est": est, "method": method + at_seq,
                "fits_measured": None if seq else est <= HBM_BYTES}
    if seq:
        coll["lower_seq"] = measured["lower_seq"] = seq
    sharded = {"lower_s": one["s"], "lower_s_2_blocks": two["s"],
               **cut_record(cfg, shape, 1), "error": None}
    return {"sharded": sharded, "collectives": coll, "measured": measured}


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
               step: dict | None = None, mesh=None) -> dict:
    """One cell's record; ``step`` reuses a ``run_step`` record of the same
    (arch, shape).  With ``mesh`` (the cell's fake production mesh), the
    sharded step runs too: ``sharded``, ``collectives`` and
    ``memory.measured``; an error there is recorded in ``sharded``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    sizes = production_shape(multi_pod=multi_pod)
    chips = math.prod(sizes.values())
    step = run_step(cfg, shape) if step is None else step
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
           "chips": chips, **step, "compile_s": None, "cost": None,
           "collectives": None,
           "memory": memory_record(cfg, shape, sizes),
           "analytic": analytic_record(cfg, shape, chips)}
    if mesh is not None:
        try:
            got = sharded_record(cfg, shape, mesh, sizes,
                                 rec["memory"]["per_device_total"])
        except Exception as e:  # record and continue
            rec["sharded"] = {**cut_record(cfg, shape, 1),
                              "error": f"{type(e).__name__}: {e}"[:2000],
                              "trace": traceback.format_exc()[-3000:]}
            rec["memory"]["measured"] = None
        else:
            rec.update(sharded=got["sharded"], collectives=got["collectives"])
            rec["memory"]["measured"] = got["measured"]
    return rec


def load_results(path: Path = RESULTS) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(res: dict, path: Path = RESULTS):
    path.write_text(json.dumps(res, indent=1))


def cell_ok(rec: dict) -> bool:
    return "error" not in rec and not (rec.get("sharded") or {}).get("error")


def main(argv=None, *, results: Path = RESULTS) -> dict:
    ap = argparse.ArgumentParser(
        description=DOC, formatter_class=argparse.RawDescriptionHelpFormatter)
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
    steps: dict = {}  # (arch, shape) -> run_step record, shared by meshes
    for mp in meshes:
        todo = []
        for arch in archs:
            for shape_name in [args.shape] if args.shape else cells(arch):
                key = f"{arch}|{shape_name}|{mesh_name(mp)}"
                if args.skip_done and key in res and cell_ok(res[key]):
                    print(f"skip {key}")
                else:
                    todo.append((key, arch, shape_name))
        if not todo:
            continue
        with fake_production_mesh(multi_pod=mp) as mesh:
            for key, arch, shape_name in todo:
                print(f"=== {key} ===", flush=True)
                try:
                    if (arch, shape_name) not in steps:
                        steps[arch, shape_name] = run_step(
                            get_config(arch), get_shape(shape_name))
                    rec = lower_cell(arch, shape_name, mp,
                                     step=steps[arch, shape_name], mesh=mesh)
                    print(json.dumps({
                        "lower_s": rec["lower_s"],
                        "sharded": rec["sharded"],
                        "collectives": rec["collectives"] and {
                            k: rec["collectives"][k] for k in
                            ("n_ops", "cross_pod_bytes", "intra_pod_bytes")},
                        "memory": {k: v for k, v in rec["memory"].items()
                                   if k != "measured"},
                        "measured": rec["memory"]["measured"]}), flush=True)
                except Exception as e:  # record and continue
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name(mp),
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print("ERROR:", rec["error"], flush=True)
                if not cell_ok(rec) and "error" not in rec:
                    print("SHARDED ERROR:", rec["sharded"]["error"][:300],
                          flush=True)
                res[key] = rec
                save_results(res, results)
    errs = [k for k, v in res.items() if not cell_ok(v)]
    print(f"\n{len(res)} cells recorded, {len(errs)} errors")
    for k in errs:
        print("  FAIL:", k, (res[k].get("error")
                             or res[k]["sharded"]["error"])[:120])
    return res


if __name__ == "__main__":
    main()
