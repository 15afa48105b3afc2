"""Train-step builder: microbatch accumulation + remat + AdamW + sharding.

Port of `repro.train.loop`.  ``train_step(params, opt_state, batch)``
accumulates gradients over ``microbatches`` sequential slices of the
batch (``_split_micro``'s ``[n, B/n, ...]``), each slice forward and
backward under per-block remat, in the fp32 ``.grad`` of the parameters,
then takes one optimizer step in place.  Autograd takes the place of
``jax.value_and_grad``.

With a ``mesh`` (a DeviceMesh), the parameters and the optimizer's
moments are DTensors (`dist.sharding.shard_put`) and the step runs on
them: DTensor's autograd reduces each gradient over the data axes into
its parameter's placement, and AdamW updates each rank's shards.
Microbatch ``i`` holds the rows ``_split_micro`` gives it, and is
distributed over the data axes on its own (``batch_specs``): the
reference's scan cannot take a batch sharded on its first dimension
(`repro.train.loop:58` fails on the installed JAX), so the port cuts
the global rows first.  The metrics come back as plain tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import model_zoo
from . import optimizer as opt_mod


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    adamw: opt_mod.AdamWConfig = opt_mod.AdamWConfig()
    sp: bool = False  # sequence-parallel activation constraints


def _split_micro(batch, n: int):
    """[B, ...] -> [n, B/n, ...] per leaf."""
    return {k: a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))
            for k, a in batch.items()}


def _on_mesh(mb, mesh):
    """One microbatch's global rows as DTensors over the data axes."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import batch_specs, placements

    specs = batch_specs(mb, mesh)
    return {k: distribute_tensor(a.contiguous(), mesh,
                                 placements(specs[k], mesh),
                                 src_data_rank=None)
            for k, a in mb.items()}


def _plain(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def build_train_step(cfg, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt, metrics)``."""
    from repro_torch.dist.sharding import sharded_ops

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if mesh is not None:  # every rank holds the global rows
            batch = {k: _plain(a) for k, a in batch.items()}
        n = tcfg.microbatches
        micro = _split_micro(batch, n) if n > 1 else {k: a[None] for k, a in batch.items()}
        loss = acc = 0.0
        with sharded_ops(mesh):
            for i in range(n):
                mb = {k: a[i] for k, a in micro.items()}
                if mesh is not None:
                    mb = _on_mesh(mb, mesh)
                l_i, metrics = model_zoo.loss_fn(cfg, params, mb, mesh=mesh,
                                                 sp=tcfg.sp)
                l_i.backward()  # fp32 .grad accumulates over the slices
                loss = loss + l_i.detach()
                acc = acc + metrics["acc"]
            grads = {k: p.grad for k, p in named.items()}
            if n > 1:
                for g in grads.values():
                    if g is not None:
                        g.div_(n)
                loss, acc = loss / n, acc / n
            _, opt_state, om = opt_mod.apply(tcfg.adamw, named, opt_state, grads)
        for p in named.values():
            p.grad = None
        metrics = {"loss": loss, "acc": acc, **om}
        if mesh is not None:
            metrics = {k: _plain(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def init_state(cfg, tcfg: TrainConfig, generator: torch.Generator | None = None,
               *, device="cuda"):
    params = model_zoo.init(cfg, generator, device=device)
    opt_state = opt_mod.init(tcfg.adamw, dict(params.named_parameters()))
    return params, opt_state
