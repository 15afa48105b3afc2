"""Config → model builder: init, loss, prefill, decode for every family.

Port of `repro.models.model_zoo`.  Families: decoder-only (dense, MoE,
hybrid, SSM; ``params`` is a `transformer.DecoderLM`), encoder-decoder
(seamless; an `encdec.EncDecLM` fed ``frames`` to train and prefill and
the encoder ``memory`` to decode), VLM (prefix embeddings).  Everything
that allocates runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card ``cuda`` raises rather than falling
back to the CPU.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from . import encdec, transformer
# a name the reference module binds too
from .frontends import frontend_embed_shape  # noqa: F401
from .layers import COMPUTE_DTYPE, chunked_logits_xent


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.enc_layers > 0


def model_class(cfg: ModelConfig) -> type:
    return encdec.EncDecLM if is_encdec(cfg) else transformer.DecoderLM


def init(cfg: ModelConfig, generator: torch.Generator | None = None, *,
         device="cuda"):
    """Random weights from ``generator`` (default: seed 0 on ``device``)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return model_class(cfg)(cfg, generator=generator, device=dev)


def loss_fn(cfg: ModelConfig, params, batch, *, remat: bool = True, mesh=None,
            sp: bool = False):
    """batch: dict(tokens, targets, mask [, frames | prefix_embeds])."""
    if is_encdec(cfg):
        hidden, aux = encdec.forward(cfg, params, batch["tokens"],
                                     batch["frames"], remat=remat, mesh=mesh)
    elif cfg.frontend == "vision_stub":
        hidden, aux = transformer.forward(
            cfg, params, batch["tokens"], prefix_embeds=batch["prefix_embeds"],
            remat=remat, mesh=mesh, sp=sp)
        hidden = hidden[:, batch["prefix_embeds"].shape[1]:]  # loss on text only
    else:
        hidden, aux = transformer.forward(cfg, params, batch["tokens"],
                                          remat=remat, mesh=mesh, sp=sp)
    if sp:  # the chunked loss cuts the sequence: gathered over "model" first
        from repro_torch.dist.sharding import gather_sequence

        hidden = gather_sequence(hidden)
    emb = (params.embed.tokens if cfg.tie_embeddings else params.lm_head.w.T)
    xent, acc = chunked_logits_xent(hidden, emb, batch["targets"], batch["mask"])
    return xent + aux, {"xent": xent, "aux": aux, "acc": acc}


@torch.no_grad()
def prefill_fn(cfg: ModelConfig, params, batch, *, mesh=None):
    """Prefill: hidden-states forward; returns last-position logits (a
    DTensor with ``mesh``, on DTensor parameters and batch)."""
    from repro_torch.dist.sharding import sharded_ops

    if is_encdec(cfg):
        memory = encdec.encode(cfg, params, batch["frames"], mesh=mesh)
        hidden = encdec.decode(cfg, params, batch["tokens"], memory, mesh=mesh)
    else:
        prefix = (batch["prefix_embeds"] if cfg.frontend == "vision_stub"
                  else None)
        hidden, _ = transformer.forward(cfg, params, batch["tokens"],
                                        prefix_embeds=prefix, mesh=mesh)
    with sharded_ops(mesh):
        return transformer.logits_head(cfg, params, hidden[:, -1:])[:, -1]


def decode_state_init(cfg: ModelConfig, batch: int, max_len: int, *,
                      device="cuda"):
    mod = encdec if is_encdec(cfg) else transformer
    return mod.decode_state_init(cfg, batch, max_len,
                                 device=resolve_device(device))


@torch.no_grad()
def decode_fn(cfg: ModelConfig, params, state, batch, pos, *, mesh=None):
    """One token for the whole batch against the decode state (updated in
    place and returned); the encoder-decoder reads ``batch["memory"]``.
    With ``mesh`` the parameters, batch and state are DTensors
    (`dist.sharding.shard_put`, `shard_state`)."""
    if is_encdec(cfg):
        return encdec.decode_step(cfg, params, state, batch["tokens"], pos,
                                  batch["memory"], mesh)
    return transformer.decode_step(cfg, params, state, batch["tokens"], pos,
                                   mesh)


# --------------------------------------------------------------- batches ---

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """``meta`` tensors standing in for every model input of a shape.

    For ``decode`` shapes the decode state is part of the inputs (the
    serve step's signature): one new token against a ``seq_len`` cache,
    and for the encoder-decoder the encoder memory of ``frontend_len``
    rows.
    """
    B, S = shape.global_batch, shape.seq_len
    fd = cfg.frontend_dim or cfg.d_model
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec((B, S), torch.int32)}
        if shape.kind == "train":
            specs["targets"] = _spec((B, S), torch.int32)
            specs["mask"] = _spec((B, S), torch.float32)
        if is_encdec(cfg):
            specs["frames"] = _spec((B, S, fd), torch.float32)
        elif cfg.frontend == "vision_stub":
            specs["prefix_embeds"] = _spec((B, cfg.frontend_len or 256, fd),
                                           torch.float32)
        return {"batch": specs}
    state = decode_state_init(cfg, B, S, device="meta")
    specs = {"tokens": _spec((B, 1), torch.int32)}
    if is_encdec(cfg):
        specs["memory"] = _spec((B, cfg.frontend_len or 4096, cfg.d_model),
                                COMPUTE_DTYPE)
    return {"state": state, "batch": specs}


def _sorted_leaves(tree, path=()):
    """Leaves in the reference's pytree order (dict keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _sorted_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                device="cuda"):
    """Concrete random batch matching ``input_specs``: the reference's numbers
    (numpy ``default_rng(seed)``, drawn leaf by leaf in its order)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    specs = input_specs(cfg, shape)
    out: dict = {}
    for path, s in _sorted_leaves(specs):
        if s.dtype.is_floating_point:
            a = torch.from_numpy(rng.normal(0, 0.02, size=s.shape)).to(s.dtype)
        else:
            a = torch.from_numpy(rng.integers(0, cfg.vocab, size=s.shape)).to(s.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.to(dev)
    if "mask" in out.get("batch", {}):
        out["batch"]["mask"] = torch.ones_like(out["batch"]["mask"])
    return out
