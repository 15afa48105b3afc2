"""Train-step builder: microbatch accumulation + remat + AdamW.

Port of `repro.train.loop`.  ``train_step(params, opt_state, batch)``
accumulates gradients over ``microbatches`` sequential slices of the
batch (``_split_micro``'s ``[n, B/n, ...]``), each slice forward and
backward under per-block remat, in the fp32 ``.grad`` of the parameters,
then takes one optimizer step in place.  Autograd takes the place of
``jax.value_and_grad``.
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


def build_train_step(cfg, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt, metrics)``."""

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        n = tcfg.microbatches
        micro = _split_micro(batch, n) if n > 1 else {k: a[None] for k, a in batch.items()}
        loss = acc = 0.0
        for i in range(n):
            mb = {k: a[i] for k, a in micro.items()}
            l_i, metrics = model_zoo.loss_fn(cfg, params, mb, mesh=mesh, sp=tcfg.sp)
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
        return params, opt_state, {"loss": loss, "acc": acc, **om}

    return train_step


def init_state(cfg, tcfg: TrainConfig, generator: torch.Generator | None = None,
               *, device="cuda"):
    params = model_zoo.init(cfg, generator, device=device)
    opt_state = opt_mod.init(tcfg.adamw, dict(params.named_parameters()))
    return params, opt_state
