"""Decoder-only LM assembled from a ModelConfig: the dense family.

Port of `repro.models.transformer` for the configurations whose pattern
is attention only, with dense MLPs: yi-6b, internlm2-1.8b, command-r-35b
(parallel block), nemotron-4-340b (squared ReLU) and internvl2-1b (qkv
bias, prefix embeddings).  Layers are grouped into the config's pattern;
``DecoderLM.blocks[b].slot{i}`` holds the parameters that the reference
stacks over pattern groups, under the same leaf names:
JAX ``blocks::slot0::attn::wq`` [n_blocks, d, H, hd] is
``blocks.{b}.slot0.attn.wq`` [d, H, hd] here (`models/convert.py`).
The reference's ``lax.scan`` over blocks is a loop; its per-block remat
is ``torch.utils.checkpoint``.

Entry points: ``forward`` (train/prefill hidden states), ``logits_head``,
``decode_state_init`` and ``decode_step`` (one token against the cache).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from .layers import (COMPUTE_DTYPE, apply_norm, dense_init, embed_init,
                     holder, make_norm, mlp_apply, mlp_init)

# int8 KV cache (per-position, per-head symmetric scales), the reference's
# module flag of the same name: read by ``decode_state_init``
KV_INT8 = False

# The model-zoo modules still to port, by slot kind (ROADMAP Queue 1).
_NEXT = {"moe": "models/moe.py (mixtral, qwen3-moe)",
         "mamba": "models/mamba.py (jamba)",
         "rwkv": "models/rwkv6.py"}


def check_supported(cfg) -> None:
    """Raise for what the dense slice does not carry."""
    for kind in cfg.pattern:
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers wait for {_NEXT[kind]}, the "
                "next model-zoo module in ROADMAP Queue 1")
    if cfg.moe_slots:
        raise NotImplementedError(
            f"{cfg.name}: MoE slots wait for {_NEXT['moe']}, the next "
            "model-zoo module in ROADMAP Queue 1")


def _no_mesh(mesh, sp) -> None:
    if mesh is not None or sp:
        raise NotImplementedError(
            "mesh/sp need dist/sharding.py, not yet ported (ROADMAP Queue 1)")


def _slot(cfg, *, generator, device) -> nn.Module:
    kw = dict(generator=generator, device=device)
    m = nn.Module()
    m.norm1 = make_norm(cfg, cfg.d_model, device=device)
    m.attn = attn.attn_init(cfg, **kw)
    m.norm2 = make_norm(cfg, cfg.d_model, device=device)
    m.mlp = mlp_init(cfg, **kw)
    return m


def _slot_apply(cfg, p, x, positions):
    h = apply_norm(cfg, p.norm1, x)
    a = attn.attention(cfg, p.attn, h, positions)
    if cfg.parallel_block:
        # command-r style: MLP on the same normed input, single residual add
        return x + a + mlp_apply(cfg, p.mlp, h)
    x = x + a
    h2 = apply_norm(cfg, p.norm2, x)
    return x + mlp_apply(cfg, p.mlp, h2)


def block_apply(cfg, bp, x, positions):
    for i in range(len(cfg.pattern)):
        x = _slot_apply(cfg, getattr(bp, f"slot{i}"), x, positions)
    return x


def constrain_activations(x, mesh=None, seq_axis=False):
    """No-op without a mesh (dist/sharding.py is not yet ported)."""
    _no_mesh(mesh, seq_axis)
    return x


class DecoderLM(nn.Module):
    """Parameters of a dense decoder-only LM; the functions below apply it.

    Built on ``device``; ``device="meta"`` allocates nothing (shapes only,
    `models/convert.py` fills such a model).  Weights are drawn from
    ``generator`` (a ``torch.Generator`` on ``device``) in a fixed order.
    """

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        blocks = []
        for _ in range(cfg.n_blocks):
            b = nn.Module()
            for i in range(len(cfg.pattern)):
                setattr(b, f"slot{i}", _slot(cfg, **kw))
            blocks.append(b)
        self.blocks = nn.ModuleList(blocks)
        self.embed = embed_init(cfg, **kw)
        self.final_norm = make_norm(cfg, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = holder(w=dense_init((cfg.d_model, cfg.padded_vocab),
                                               **kw))
        if cfg.frontend != "none":
            fd = cfg.frontend_dim or cfg.d_model
            self.frontend_proj = holder(w=dense_init((fd, cfg.d_model), **kw))


def forward(cfg, model, tokens, *, prefix_embeds=None, remat: bool = True,
            mesh=None, sp: bool = False):
    """tokens: [B, S] integer -> hidden [B, S(+P), D] bf16, aux loss (0)."""
    _no_mesh(mesh, sp)
    x = model.embed.tokens[tokens.long()].to(COMPUTE_DTYPE)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(COMPUTE_DTYPE) @ model.frontend_proj.w.to(
            COMPUTE_DTYPE)
        x = torch.cat([pe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for bp in model.blocks:
        x = constrain_activations(x, mesh, seq_axis=sp)
        if remat and torch.is_grad_enabled():
            x = checkpoint(block_apply, cfg, bp, x, positions,
                           use_reentrant=False)
        else:
            x = block_apply(cfg, bp, x, positions)
    x = apply_norm(cfg, model.final_norm, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_head(cfg, model, x):
    w = model.embed.tokens.T if cfg.tie_embeddings else model.lm_head.w
    return (x @ w.to(x.dtype)).float()


# ---------------------------------------------------------------- decode ---

def decode_state_init(cfg, batch: int, max_len: int, *, device=None):
    """Per-slot decode state, stacked over blocks: ``state["slot0"]["k"]``
    is [n_blocks, B, S, Hkv, hd], as the reference stacks it."""
    check_supported(cfg)
    s = max_len if cfg.sliding_window is None else min(max_len,
                                                       cfg.sliding_window)
    nb = cfg.n_blocks
    kv = (nb, batch, s, cfg.n_kv_heads, cfg.hd)

    def one_slot():
        st = {"pos": torch.full((nb, s), -1, dtype=torch.int32, device=device)}
        if KV_INT8:
            st.update(
                k=torch.zeros(kv, dtype=torch.int8, device=device),
                v=torch.zeros(kv, dtype=torch.int8, device=device),
                k_scale=torch.zeros(kv[:-1], dtype=torch.bfloat16, device=device),
                v_scale=torch.zeros(kv[:-1], dtype=torch.bfloat16, device=device))
        else:
            st.update(k=torch.zeros(kv, dtype=COMPUTE_DTYPE, device=device),
                      v=torch.zeros(kv, dtype=COMPUTE_DTYPE, device=device))
        return st

    return {f"slot{i}": one_slot() for i in range(len(cfg.pattern))}


def _quant(x):
    """[B, 1, Hkv, dh] -> int8 and a per-head bf16 scale."""
    x32 = x.float()
    s = torch.clamp(torch.amax(torch.abs(x32), dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def _slot_decode(cfg, p, st, blk: int, x, pos):
    """One slot of one block; writes the new K/V into ``st`` in place.
    ``pos`` is a 0-d int64 tensor on the device, as the reference's traced
    position: nothing here reads it on the host."""
    h = apply_norm(cfg, p.norm1, x)
    s_max = st["k"].shape[2]
    if cfg.sliding_window is not None:
        write = pos % s_max  # ring layout; cache "pos" keeps absolutes
    else:
        write = torch.clamp(pos, max=s_max - 1)
    write = write.reshape(1)
    int8 = "k_scale" in st
    if int8:
        ck = st["k"][blk].to(COMPUTE_DTYPE) * st["k_scale"][blk][..., None]
        cv = st["v"][blk].to(COMPUTE_DTYPE) * st["v_scale"][blk][..., None]
    else:
        ck, cv = st["k"][blk], st["v"][blk]
    a, k_new, v_new = attn.decode_attention(cfg, p.attn, h, ck, cv,
                                            st["pos"][blk], pos)
    if int8:
        (k_new, ks), (v_new, vs) = _quant(k_new), _quant(v_new)
        st["k_scale"][blk].index_copy_(1, write, ks)
        st["v_scale"][blk].index_copy_(1, write, vs)
    st["k"][blk].index_copy_(1, write, k_new)
    st["v"][blk].index_copy_(1, write, v_new)
    st["pos"][blk].index_copy_(0, write, pos.reshape(1).to(torch.int32))
    # The reference's decode takes the sequential residual form even for a
    # parallel_block config (command-r), unlike its forward; the port
    # follows the reference (ROADMAP Queue 3).
    x = x + a
    h2 = apply_norm(cfg, p.norm2, x)
    return x + mlp_apply(cfg, p.mlp, h2)


def decode_step(cfg, model, state, tokens, pos):
    """One decode step.  tokens: [B, 1] integer; pos: the cache length (an
    int, or a 0-d integer tensor on the device).

    Returns (logits [B, padded_vocab] fp32, state).  The state is updated
    in place (where the reference donates it) and returned.
    """
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=tokens.device, dtype=torch.int64)
    else:
        pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
    x = model.embed.tokens[tokens.long()].to(COMPUTE_DTYPE)
    for blk, bp in enumerate(model.blocks):
        for i in range(len(cfg.pattern)):
            x = _slot_decode(cfg, getattr(bp, f"slot{i}"), state[f"slot{i}"],
                             blk, x, pos)
    x = apply_norm(cfg, model.final_norm, x)
    return logits_head(cfg, model, x)[:, -1], state
