"""Encoder-decoder backbone (seamless-m4t).

Port of `repro.models.encdec`.  The audio frontend is a stub: the
encoder takes precomputed frame embeddings (``frames``), projects them
with ``frontend_proj`` and runs bidirectional attention layers; the
decoder runs causal self attention, cross attention on the encoder's
``memory`` and the MLP in each layer.  ``EncDecLM.enc_blocks[i]`` and
``dec_blocks[i]`` hold row ``i`` of the reference's stacked
``enc_blocks::...`` and ``dec_blocks::...`` leaves (`models/convert.py`).
Each layer is recomputed in the backward (``torch.utils.checkpoint``
for the reference's per-layer remat).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import (COMPUTE_DTYPE, apply_norm, dense_init, embed_init,
                     holder, make_norm, mlp_apply, mlp_init)
from .transformer import embed_tokens, logits_head


def _layer(cfg, names, *, generator, device) -> nn.Module:
    kw = dict(generator=generator, device=device)
    m = nn.Module()
    for name in names:
        if name.startswith("norm"):
            setattr(m, name, make_norm(cfg, cfg.d_model, device=device))
        elif name == "mlp":
            m.mlp = mlp_init(cfg, **kw)
        else:
            setattr(m, name, attn.attn_init(cfg, **kw))
    return m


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder LM; the functions below apply it.
    Built on ``device`` (``"meta"`` allocates nothing) from ``generator``
    in a fixed order."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.enc_blocks = nn.ModuleList(
            _layer(cfg, ("norm1", "attn", "norm2", "mlp"), **kw)
            for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(
            _layer(cfg, ("norm1", "attn", "norm_x", "xattn", "norm2", "mlp"),
                   **kw)
            for _ in range(cfg.n_layers))
        self.embed = embed_init(cfg, **kw)
        self.enc_norm = make_norm(cfg, cfg.d_model, device=device)
        self.final_norm = make_norm(cfg, cfg.d_model, device=device)
        fd = cfg.frontend_dim or cfg.d_model
        self.frontend_proj = holder(w=dense_init((fd, cfg.d_model), **kw))


def _layers(body, blocks, x, remat: bool, mesh, *args):
    from repro_torch.dist.sharding import constrain_activations

    for lp in blocks:
        x = constrain_activations(x, mesh)
        if remat and torch.is_grad_enabled():
            x = checkpoint(body, lp, x, *args, use_reentrant=False)
        else:
            x = body(lp, x, *args)
    return x


def encode(cfg, model, frames, *, remat=True, mesh=None):
    """frames: [B, S_enc, frontend_dim] stub embeddings -> memory
    [B, S_enc, D] bf16.  With ``mesh`` the parameters and ``frames`` are
    DTensors and the residual stream is constrained at every layer
    (batch over the data axes), as `transformer.forward` constrains it."""
    from repro_torch.dist.sharding import sharded_ops

    with sharded_ops(mesh):
        x = frames.to(COMPUTE_DTYPE) @ model.frontend_proj.w.to(COMPUTE_DTYPE)
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device).expand(b, s)

        def body(lp, x):
            h = apply_norm(cfg, lp.norm1, x)
            y = x + attn.attention(cfg, lp.attn, h, pos, causal=False)
            return y + mlp_apply(cfg, lp.mlp, apply_norm(cfg, lp.norm2, y))

        x = _layers(body, model.enc_blocks, x, remat, mesh)
        return apply_norm(cfg, model.enc_norm, x)


def decode(cfg, model, tokens, memory, *, remat=True, mesh=None):
    """tokens: [B, S_dec]; memory: [B, S_enc, D] -> hidden [B, S_dec, D]."""
    from repro_torch.dist.sharding import sharded_ops

    with sharded_ops(mesh):
        x = embed_tokens(model, tokens, mesh)
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device).expand(b, s)

        def body(lp, x, memory):
            h = apply_norm(cfg, lp.norm1, x)
            y = x + attn.attention(cfg, lp.attn, h, pos, causal=True)
            hx = apply_norm(cfg, lp.norm_x, y)
            y = y + attn.cross_attention(cfg, lp.xattn, hx, memory)
            return y + mlp_apply(cfg, lp.mlp, apply_norm(cfg, lp.norm2, y))

        x = _layers(body, model.dec_blocks, x, remat, mesh, memory)
        return apply_norm(cfg, model.final_norm, x)


def forward(cfg, model, tokens, frames, *, remat=True, mesh=None):
    """(hidden [B, S_dec, D], aux loss 0)."""
    memory = encode(cfg, model, frames, remat=remat, mesh=mesh)
    hidden = decode(cfg, model, tokens, memory, remat=remat, mesh=mesh)
    return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)


def decode_state_init(cfg, batch: int, max_len: int, *, device=None):
    """The decoder's KV caches, stacked over ``n_layers``: ``k`` and ``v``
    [n_layers, B, max_len, Hkv, hd] bf16, ``pos`` [n_layers, max_len]."""
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(kv, dtype=COMPUTE_DTYPE, device=device),
            "pos": torch.full((cfg.n_layers, max_len), -1, dtype=torch.int32,
                              device=device)}


def decode_step(cfg, model, state, tokens, pos, memory, mesh=None):
    """One decoder token that cross-attends the (precomputed) encoder
    ``memory``.  tokens: [B, 1]; pos: an int or a 0-d integer tensor.  The
    new K/V go to row ``pos`` clamped into the cache, as the reference's
    ``dynamic_update_slice`` clamps its start.  Returns (logits
    [B, padded_vocab] fp32, state), the state updated in place.  With
    ``mesh`` the parameters, tokens, memory and state are DTensors and
    each rank writes its own shard of the cache
    (`transformer._attn_decode`)."""
    from repro_torch.dist.sharding import row_placements, sharded_ops

    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=tokens.device, dtype=torch.int64)
    else:
        pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
    kv_placements, st = None, state
    if mesh is not None:  # each rank reads and writes its own shard
        kv_placements = row_placements(state["k"].placements)
        st = {k: v.to_local() for k, v in state.items()}
    write = torch.clamp(pos, 0, st["k"].shape[2] - 1).reshape(1)
    with sharded_ops(mesh):
        x = embed_tokens(model, tokens, mesh)
        for i, lp in enumerate(model.dec_blocks):
            h = apply_norm(cfg, lp.norm1, x)
            a, k_new, v_new = attn.decode_attention(
                cfg, lp.attn, h, st["k"][i], st["v"][i], st["pos"][i], pos,
                kv_placements=kv_placements)
            st["k"][i].index_copy_(1, write, k_new)
            st["v"][i].index_copy_(1, write, v_new)
            st["pos"][i].index_copy_(0, write, pos.reshape(1).to(torch.int32))
            y = x + a
            hx = apply_norm(cfg, lp.norm_x, y)
            y = y + attn.cross_attention(cfg, lp.xattn, hx, memory)
            x = y + mlp_apply(cfg, lp.mlp, apply_norm(cfg, lp.norm2, y))
        x = apply_norm(cfg, model.final_norm, x)
        return logits_head(cfg, model, x)[:, -1], state
