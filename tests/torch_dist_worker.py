"""The gloo worlds of tests/test_torch_dist.py, on the CPU.

    python tests/torch_dist_worker.py pod DIR    # 2 ranks, mesh ("pod",)
    python tests/torch_dist_worker.py train DIR  # 4 ranks, ("data", "model")
    python tests/torch_dist_worker.py serve DIR  # 4 ranks, ("data", "model")

Every rank reads its inputs from DIR (written by the test), meets the
others through a ``FileStore`` in DIR (so pytest-xdist workers never
share a port), and writes its results there.  Imports torch and
`repro_torch` only.

``pod``: `train.grad_compress.compressed_psum_mean` over the pod group,
each rank with its own row of ``pod_in.npz``, directly and through
``make_pod_compressed_allreduce``; rank r writes ``pod_out_{r}.npz``.

``train``: for each case of ``train_cases.txt`` (a line ``name arch
fp32 data model sp``), the port's model (weights ``{name}.pt``, batch
``{name}_batch.npz``) distributed with ``shard_put`` over a (data,
model) mesh of the 4 ranks, one ``build_train_step`` step with
microbatches 2 (and sequence-parallel constraints if ``sp`` is 1) on
DTensor parameters and a DTensor batch; rank 0 writes the loss, grad
norm, each gradient (captured at the optimizer) and each updated
parameter, whole, to ``{name}_sharded.pt``.  A case with ``fp32`` 1
runs with fp32 activations, one with 0 with bf16.

``serve``: for each case of ``serve_cases.txt`` (a line ``name arch fp32
data model kv_int8``), the port's model (``{name}.pt``) distributed with
``shard_put`` over a (data, model) mesh; the prefill batch of
``{name}_serve.npz`` placed by ``batch_specs`` through
``model_zoo.prefill_fn(..., mesh=)``, then the decode state
(``decode_state_init``, the int8 KV cache where ``kv_int8`` is 1) placed
by ``shard_state`` and one ``decode_fn(..., mesh=)`` step for each column
of its ``decode`` tokens (the encoder-decoder cross-attending its
``memory``); rank 0 writes the prefill and decode logits, the state
whole, and each state leaf's placements beside those of its spec, to
``{name}_served.pt``.  Then, if ``train_cases.txt`` exists, its train
cases as ``train`` runs them.
"""
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
ADAMW = dict(lr=5e-3, warmup_steps=2, total_steps=50)


def _activations(fp32: bool):
    """The models' compute dtype: fp32, or the shipped bf16."""
    import importlib

    for name in ("layers", "transformer", "encdec", "mamba", "rwkv6", "moe",
                 "model_zoo", "attention"):
        mod = importlib.import_module(f"repro_torch.models.{name}")
        if hasattr(mod, "COMPUTE_DTYPE"):
            mod.COMPUTE_DTYPE = torch.float32 if fp32 else torch.bfloat16


def _load_model(out: Path, name: str, cfg):
    from repro_torch.models.model_zoo import model_class

    model = model_class(cfg)(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(torch.load(out / f"{name}.pt"))
    return model


def pod_rank(rank: int, out: Path) -> None:
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import grad_compress as gc

    mesh = make_debug_mesh((2,), ("pod",), device_type="cpu")
    inp = np.load(out / "pod_in.npz")
    x = torch.from_numpy(inp["x"][rank])
    r = torch.from_numpy(inp["r"][rank])
    mean, resid = gc.compressed_psum_mean(x, r, mesh.get_group("pod"))
    fn = gc.make_pod_compressed_allreduce(mesh, {"g": ()})
    tmean, tresid = fn({"g": x}, {"g": r})
    np.savez(out / f"pod_out_{rank}.npz", mean=mean.numpy(),
             resid=resid.numpy(), tree_mean=tmean["g"].numpy(),
             tree_resid=tresid["g"].numpy())


def train_rank(rank: int, out: Path) -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import loop, optimizer as opt_mod

    for line in (out / "train_cases.txt").read_text().splitlines():
        name, arch, fp32, data, model_ax, sp = line.split()
        _activations(fp32 == "1")
        mesh = make_debug_mesh((int(data), int(model_ax)), ("data", "model"),
                               device_type="cpu")
        cfg = reduced(get_config(arch))
        model = _load_model(out, name, cfg)
        tcfg = loop.TrainConfig(microbatches=2, sp=sp == "1",
                                adamw=opt_mod.AdamWConfig(**ADAMW))
        pspecs = shd.param_specs(model, mesh)
        opt = opt_mod.init(tcfg.adamw, dict(model.named_parameters()))
        opt = {"step": opt["step"],
               "m": shd.shard_put(opt["m"], mesh, pspecs),
               "v": shd.shard_put(opt["v"], mesh, pspecs)}
        shd.shard_put(model, mesh, pspecs)
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(out / f"{name}_batch.npz").items()}
        batch = shd.shard_put(batch, mesh, shd.batch_specs(batch, mesh))

        grads, real = {}, loop.opt_mod.apply

        def capture(acfg, params, state, g):
            grads.update({k: v.full_tensor() for k, v in g.items()
                          if v is not None})
            return real(acfg, params, state, g)

        loop.opt_mod.apply = capture
        try:
            _, _, met = loop.build_train_step(cfg, tcfg, mesh)(model, opt, batch)
        finally:
            loop.opt_mod.apply = real
        params = {k: p.full_tensor() for k, p in model.named_parameters()}
        if rank == 0:
            torch.save({"loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"]),
                        "grads": grads, "params": params,
                        "placements": {k: [repr(x) for x in p.placements]
                                       for k, p in model.named_parameters()}},
                       out / f"{name}_sharded.pt")


def serve_rank(rank: int, out: Path) -> None:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model_zoo, transformer

    def placed(batch):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if "memory" in batch:  # the encoder's output, in the compute dtype
            batch["memory"] = batch["memory"].to(transformer.COMPUTE_DTYPE)
        return shd.shard_put(batch, mesh, shd.batch_specs(batch, mesh))

    def whole(tree):
        return {k: whole(v) if isinstance(v, dict) else v.full_tensor()
                for k, v in tree.items()}

    def placements(tree, specs):
        return {k: placements(v, specs[k]) if isinstance(v, dict) else (
            isinstance(v, DTensor) and v.placements == shd.placements(
                specs[k], mesh), [repr(x) for x in v.placements])
            for k, v in tree.items()}

    for line in (out / "serve_cases.txt").read_text().splitlines():
        name, arch, fp32, data, model_ax, kv_int8 = line.split()
        _activations(fp32 == "1")
        transformer.KV_INT8 = kv_int8 == "1"
        mesh = make_debug_mesh((int(data), int(model_ax)), ("data", "model"),
                               device_type="cpu")
        cfg = reduced(get_config(arch))
        model = shd.shard_put(_load_model(out, name, cfg), mesh)
        inp = dict(np.load(out / f"{name}_serve.npz"))
        toks = inp.pop("decode")
        memory = inp.pop("memory", None)
        prefill = model_zoo.prefill_fn(cfg, model, placed(inp), mesh=mesh)
        b, steps = toks.shape
        state = shd.shard_state(model_zoo.decode_state_init(
            cfg, b, steps + 8, device="cpu"), mesh)
        specs = shd.state_specs(state, mesh)
        decode = []
        for pos in range(steps):
            batch = {"tokens": toks[:, pos: pos + 1]}
            if memory is not None:
                batch["memory"] = memory
            logits, same = model_zoo.decode_fn(cfg, model, state, placed(batch),
                                               pos, mesh=mesh)
            assert same is state
            decode.append(logits.full_tensor())
        got = {"prefill": prefill.full_tensor(),  # collectives: every rank
               "decode": torch.stack(decode, 1), "state": whole(state),
               "placements": placements(state, specs)}
        if rank == 0:
            torch.save(got, out / f"{name}_served.pt")
        transformer.KV_INT8 = False
    if (out / "train_cases.txt").exists():
        train_rank(rank, out)


def run(rank: int, world: int, case: str, out: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    try:
        {"pod": pod_rank, "train": train_rank, "serve": serve_rank}[case](
            rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    case, out = sys.argv[1], sys.argv[2]
    world = {"pod": 2, "train": 4, "serve": 4}[case]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(run, args=(world, case, out), nprocs=world)


if __name__ == "__main__":
    main()
