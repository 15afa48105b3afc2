"""Decoder-only LM assembled from a ModelConfig.

Port of `repro.models.transformer`.  Layers are grouped into the
config's repeating pattern (Jamba's [mamba x4, attn, mamba x3]); each
slot is an ``attn``, ``mamba`` or ``rwkv`` mixer followed by the RWKV
channel mix, an MoE MLP (the config's ``moe_slots``) or a dense MLP.
``DecoderLM.blocks[b].slot{i}`` holds the parameters that the reference
stacks over pattern groups, under the same leaf names:
JAX ``blocks::slot0::attn::wq`` [n_blocks, d, H, hd] is
``blocks.{b}.slot0.attn.wq`` [d, H, hd] here (`models/convert.py`).
The reference's ``lax.scan`` over blocks is a loop; its per-block remat
is ``torch.utils.checkpoint``.

Entry points: ``forward`` (train/prefill hidden states and the MoE aux
loss), ``logits_head``, ``decode_state_init`` and ``decode_step`` (one
token against the per-slot decode state, updated in place).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import mamba as mb
from . import moe as moe_mod
from . import rwkv6 as rk
from .layers import (COMPUTE_DTYPE, apply_norm, dense_init, embed_init,
                     holder, make_norm, mlp_apply, mlp_init)
# a name the reference module binds too
from .layers import EMBED, VOCAB  # noqa: F401

# int8 KV cache (per-position, per-head symmetric scales), the reference's
# module flag of the same name: read by ``decode_state_init``
KV_INT8 = False


def _slot(cfg, slot: int, kind: str, *, generator, device) -> nn.Module:
    """One slot's parameters, drawn in the reference's order: norm1, the
    mixer, norm2, then the channel mix, MoE or MLP."""
    kw = dict(generator=generator, device=device)
    m = nn.Module()
    m.norm1 = make_norm(cfg, cfg.d_model, device=device)
    if kind == "attn":
        m.attn = attn.attn_init(cfg, **kw)
    elif kind == "mamba":
        m.mamba = mb.mamba_init(cfg, **kw)
    else:
        m.rwkv = rk.rwkv_init(cfg, **kw)
    m.norm2 = make_norm(cfg, cfg.d_model, device=device)
    if kind == "rwkv":
        m.cmix = rk.rwkv_channel_mix_init(cfg, **kw)
    elif slot in cfg.moe_slots:
        m.moe = moe_mod.moe_init(cfg, **kw)
    else:
        m.mlp = mlp_init(cfg, **kw)
    return m


def _mlp_part(cfg, p, kind, h, aux, mesh):
    """The slot's second half on normed ``h``: (out, aux + its MoE aux)."""
    if kind == "rwkv":
        return rk.rwkv_channel_mix(cfg, p.cmix, h), aux
    if hasattr(p, "moe"):
        m, a = moe_mod.moe_apply(cfg, p.moe, h, mesh)
        return m, aux + a
    return mlp_apply(cfg, p.mlp, h), aux


def _slot_apply(cfg, p, x, positions, kind, aux, mesh):
    from repro_torch.dist.sharding import as_residual, gather_sequence

    h = gather_sequence(apply_norm(cfg, p.norm1, x))
    if kind == "attn":
        a = attn.attention(cfg, p.attn, h, positions)
    elif kind == "mamba":
        a = mb.mamba_apply(cfg, p.mamba, h)
    else:
        a = rk.rwkv_apply(cfg, p.rwkv, h)
    if cfg.parallel_block:
        # command-r style: MLP on the same normed input, single residual add
        m, aux = _mlp_part(cfg, p, kind, h, aux, mesh)
        return x + as_residual(a, x) + as_residual(m, x), aux
    x = x + as_residual(a, x)
    m, aux = _mlp_part(cfg, p, kind, gather_sequence(apply_norm(cfg, p.norm2, x)),
                       aux, mesh)
    return x + as_residual(m, x), aux


# the reference's opt-in knob, off there and here: a checkpoint per slot
# inside a multi-slot block (its note: jamba train_4k's temp memory grew
# 63 -> 72.6 GB/device with it on)
NESTED_SLOT_REMAT = False


def block_apply(cfg, bp, x, positions, mesh=None):
    """One block: (x, the block's aux loss fp32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    nested = NESTED_SLOT_REMAT and len(cfg.pattern) > 1
    for i, kind in enumerate(cfg.pattern):
        args = (cfg, getattr(bp, f"slot{i}"), x, positions, kind, aux, mesh)
        if nested and torch.is_grad_enabled():
            x, aux = checkpoint(_slot_apply, *args, use_reentrant=False)
        else:
            x, aux = _slot_apply(*args)
    return x, aux


class DecoderLM(nn.Module):
    """Parameters of a decoder-only LM; the functions below apply it.

    Built on ``device``; ``device="meta"`` allocates nothing (shapes only,
    `models/convert.py` fills such a model).  Weights are drawn from
    ``generator`` (a ``torch.Generator`` on ``device``) in a fixed order.
    """

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        blocks = []
        for _ in range(cfg.n_blocks):
            b = nn.Module()
            for i, kind in enumerate(cfg.pattern):
                setattr(b, f"slot{i}", _slot(cfg, i, kind, **kw))
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
    """tokens: [B, S] integer -> hidden [B, S(+P), D] bf16, aux loss (the
    MoE slots' load-balance loss summed over blocks, fp32).

    ``mesh``/``sp``: the parameters and inputs are DTensors on ``mesh``
    (`dist.sharding.shard_put`), and the residual stream is constrained at
    every block boundary (batch over the data axes; with ``sp`` the
    sequence over "model", sequence parallelism).
    """
    from repro_torch.dist.sharding import sharded_ops

    with sharded_ops(mesh):
        return _forward(cfg, model, tokens, prefix_embeds, remat, mesh, sp)


def embed_tokens(model, tokens, mesh=None):
    """The token embeddings in the compute dtype; on a mesh the DTensor
    table is gathered (`dist.sharding.gather_rows`)."""
    from repro_torch.dist.sharding import gather_rows

    if mesh is None:
        x = model.embed.tokens[tokens.long()]
    else:
        x = gather_rows(model.embed.tokens, tokens)
    return x.to(COMPUTE_DTYPE)


def _forward(cfg, model, tokens, prefix_embeds, remat, mesh, sp):
    from repro_torch.dist.sharding import constrain_activations

    x = embed_tokens(model, tokens, mesh)
    if prefix_embeds is not None:
        pe = prefix_embeds.to(COMPUTE_DTYPE) @ model.frontend_proj.w.to(
            COMPUTE_DTYPE)
        x = torch.cat([pe, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    auxs = []
    for bp in model.blocks:
        x = constrain_activations(x, mesh, seq_axis=sp)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(block_apply, cfg, bp, x, positions, mesh,
                                use_reentrant=False)
        else:
            x, aux = block_apply(cfg, bp, x, positions, mesh)
        auxs.append(aux)
    x = apply_norm(cfg, model.final_norm, x)
    return x, torch.stack(auxs).sum()


def logits_head(cfg, model, x):
    w = model.embed.tokens.T if cfg.tie_embeddings else model.lm_head.w
    return (x @ w.to(x.dtype)).float()


# ---------------------------------------------------------------- decode ---

def _kv_state(cfg, batch: int, max_len: int, nb: int, device):
    s = max_len if cfg.sliding_window is None else min(max_len,
                                                       cfg.sliding_window)
    kv = (nb, batch, s, cfg.n_kv_heads, cfg.hd)
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


def decode_state_init(cfg, batch: int, max_len: int, *, device=None):
    """Per-slot decode state by slot kind, stacked over blocks, as the
    reference stacks it: an attention slot's ``k`` is [n_blocks, B, S, Hkv,
    hd], a mamba slot's ``h`` [n_blocks, B, di, n], an rwkv slot's
    ``tm.wkv`` [n_blocks, B, H, dh, dh]."""
    nb = cfg.n_blocks

    def one_slot(kind):
        if kind == "attn":
            return _kv_state(cfg, batch, max_len, nb, device)
        if kind == "mamba":
            return mb.mamba_decode_init(cfg, batch, nb, device=device)
        return rk.rwkv_decode_init(cfg, batch, nb, device=device)

    return {f"slot{i}": one_slot(kind) for i, kind in enumerate(cfg.pattern)}


def _quant(x):
    """[B, 1, Hkv, dh] -> int8 and a per-head bf16 scale."""
    x32 = x.float()
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which rounds apart from the reference's division
    s = torch.clamp(torch.amax(torch.abs(x32), dim=-1)
                    / torch.full((), 127.0, device=x.device), min=1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def _attn_decode(cfg, p, st, blk: int, h, pos):
    """Attention against block ``blk``'s KV cache; writes the new K/V into
    ``st`` in place.  ``pos`` is a 0-d int64 tensor on the device, as the
    reference's traced position: nothing here reads it on the host.

    A DTensor state (`dist.sharding.shard_state`) is read and written on
    each rank's local shards: the new token's q, k and v are
    redistributed to the cache's placements (`attention.decode_attention`),
    so the state keeps its placements."""
    kv_placements = None
    if hasattr(st["k"], "to_local"):
        from repro_torch.dist.sharding import row_placements

        kv_placements = row_placements(st["k"].placements)
        st = {k: v.to_local() for k, v in st.items()}
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
                                            st["pos"][blk], pos,
                                            kv_placements=kv_placements)
    if int8:
        (k_new, ks), (v_new, vs) = _quant(k_new), _quant(v_new)
        st["k_scale"][blk].index_copy_(1, write, ks)
        st["v_scale"][blk].index_copy_(1, write, vs)
    st["k"][blk].index_copy_(1, write, k_new)
    st["v"][blk].index_copy_(1, write, v_new)
    st["pos"][blk].index_copy_(0, write, pos.reshape(1).to(torch.int32))
    return a


def _slot_decode(cfg, p, st, blk: int, x, pos, kind, mesh=None):
    """One slot of one block; updates the slot's state rows in place."""
    h = apply_norm(cfg, p.norm1, x)
    if kind == "attn":
        a = _attn_decode(cfg, p, st, blk, h, pos)
    elif kind == "mamba":
        a = mb.mamba_decode(cfg, p.mamba, h, st["conv"][blk], st["h"][blk])
    else:
        a = rk.rwkv_apply(cfg, p.rwkv, h, shift=st["tm"]["shift"][blk],
                          wkv=st["tm"]["wkv"][blk])
    # The reference's decode takes the sequential residual form even for a
    # parallel_block config (command-r), unlike its forward; the port
    # follows the reference (ROADMAP Queue 3).
    x = x + a
    h2 = apply_norm(cfg, p.norm2, x)
    if kind == "rwkv":
        m = rk.rwkv_channel_mix(cfg, p.cmix, h2, shift=st["cm"]["shift"][blk])
    elif hasattr(p, "moe"):
        m, _ = moe_mod.moe_apply(cfg, p.moe, h2, mesh)
    else:
        m = mlp_apply(cfg, p.mlp, h2)
    return x + m


def decode_step(cfg, model, state, tokens, pos, mesh=None):
    """One decode step.  tokens: [B, 1] integer; pos: the cache length (an
    int, or a 0-d integer tensor on the device).

    Returns (logits [B, padded_vocab] fp32, state).  The state is updated
    in place (where the reference donates it) and returned.  With
    ``mesh``, the parameters, the tokens and the state are DTensors
    (`dist.sharding.shard_put`, `shard_state`), each state leaf keeps its
    placements, and the logits are a DTensor.
    """
    from repro_torch.dist.sharding import sharded_ops

    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=tokens.device, dtype=torch.int64)
    else:
        pos = torch.full((), pos, dtype=torch.int64, device=tokens.device)
    with sharded_ops(mesh):
        x = embed_tokens(model, tokens, mesh)
        for blk, bp in enumerate(model.blocks):
            for i, kind in enumerate(cfg.pattern):
                x = _slot_decode(cfg, getattr(bp, f"slot{i}"),
                                 state[f"slot{i}"], blk, x, pos, kind, mesh)
        x = apply_norm(cfg, model.final_norm, x)
        return logits_head(cfg, model, x)[:, -1], state
