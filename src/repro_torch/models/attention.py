"""GQA attention: blockwise training/prefill + cached decode.

Port of `repro.models.attention`, step for step in plain PyTorch ops.
Blockwise attention takes q blocks against the full KV and recomputes
each block in the backward (``torch.utils.checkpoint`` in place of
``jax.checkpoint``), so the [Sq, Sk] scores of only one block exist at
a time.  Scores are taken in bf16, softmaxed in fp32 and cast back to
the value dtype before the PV product, as in the reference.  Supports
causal masking, sliding windows, logit softcap, non-causal mode and the
encoder-decoder's cross attention.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .layers import EMBED, HEADS, KV_HEADS, apply_rope, dense_init, holder
# a name the reference module binds too
from .layers import COMPUTE_DTYPE  # noqa: F401

NEG_INF = -1e30


def attn_init(cfg, d_model=None, *, generator=None, device=None):
    d = d_model or cfg.d_model
    hd = cfg.hd
    kw = dict(generator=generator, device=device)
    p = dict(
        wq=dense_init((d, cfg.n_heads, hd), **kw),
        wk=dense_init((d, cfg.n_kv_heads, hd), **kw),
        wv=dense_init((d, cfg.n_kv_heads, hd), **kw),
        wo=dense_init((cfg.n_heads, hd, d), in_axis=(0, 1), **kw),
    )
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, hd), device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), device=device)
    return holder(**p)


# each parameter's logical axes (`repro_torch.dist.sharding`)
ATTN_AXES = {
    "wq": (EMBED, HEADS, None),
    "wk": (EMBED, KV_HEADS, None),
    "wv": (EMBED, KV_HEADS, None),
    "wo": (HEADS, None, EMBED),
    "bq": (HEADS, None),
    "bk": (KV_HEADS, None),
    "bv": (KV_HEADS, None),
}


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _out(o, w):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    return o.flatten(-2) @ w.to(o.dtype).flatten(0, 1)


def _qkv(cfg, p, x, positions, rope=True):
    dt = x.dtype
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _q_block(qq, qp, k, v, k_pos, scale, causal, sliding_window, softcap):
    # qq: [B, blk_q, hkv, g, dh]; qp: [blk_q] positions
    s = torch.einsum("bqhgd,bkhd->bhgqk", qq, k).float() * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.ones((qp.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=s.device)
    if causal:
        mask &= qp[:, None] >= k_pos[None, :]
    if sliding_window is not None:
        mask &= qp[:, None] - k_pos[None, :] < sliding_window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)  # [B, blk_q, hkv, g, dh]


def pick_blk_q(sq: int, blk_q: int = 512) -> int:
    """The reference's block rule: the largest divisor of ``sq`` that is at
    most ``blk_q``, preferring multiples of 128."""
    blk_q = min(blk_q, sq)
    aligned = [d for d in range(blk_q, 127, -128) if sq % d == 0]
    if aligned:
        return aligned[0]
    while sq % blk_q:
        blk_q -= 1
    return blk_q


def blockwise_attention(q, k, v, *, causal: bool, q_offset=0,
                        sliding_window: int | None = None,
                        softcap: float | None = None,
                        blk_q: int = 512):
    """Chunked attention: q blocks × full KV, rematerialized per block.

    q: [B, Sq, H, Dh]; k/v: [B, Sk, Hkv, Dh].  Returns [B, Sq, H, Dh].
    DTensors attend on their local shards (`_on_shards`).
    """
    if hasattr(q, "to_local"):
        return _on_shards(q, k, v, causal=causal, q_offset=q_offset,
                          sliding_window=sliding_window, softcap=softcap,
                          blk_q=blk_q)
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    blk_q = pick_blk_q(sq, blk_q)
    nq = sq // blk_q
    scale = 1.0 / np.sqrt(dh)
    qb = q.reshape(b, nq, blk_q, hkv, g, dh)
    k_pos = torch.arange(sk, device=q.device)
    q_pos = (q_offset + torch.arange(sq, device=q.device)).reshape(nq, blk_q)
    outs = []
    for i in range(nq):
        args = (qb[:, i], q_pos[i], k, v, k_pos, scale, causal,
                sliding_window, softcap)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_q_block, *args, use_reentrant=False))
        else:
            outs.append(_q_block(*args))
    out = torch.stack(outs, dim=1)  # [B, nq, blk_q, hkv, g, dh]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _on_shards(q, k, v, **kw):
    """Blockwise attention of DTensor q/k/v on each rank's local shards.

    Batch rows and heads attend independently, so a mesh dimension keeps
    a batch (dim 0) or head (dim 2) shard where q, k and v all carry it
    (the KV heads of a rank's query heads are then its own: heads are
    split in whole contiguous groups); any other placement is replicated
    first.  DTensor cannot take the core's einsums itself: they flatten
    the sharded batch and head dims together.
    """
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import (from_local, local_shard,
                                           work_placements)

    keep = tuple(pq if pq == pk == pv else Replicate() for pq, pk, pv in
                 zip(work_placements(q), k.placements, v.placements))
    out = blockwise_attention(*(local_shard(t, keep) for t in (q, k, v)), **kw)
    return from_local(out, q.device_mesh, keep, q.shape)


def attention(cfg, p, x, positions, *, causal=True):
    """Full attention layer (projections + blockwise core)."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = blockwise_attention(
        q, k, v, causal=causal, sliding_window=cfg.sliding_window,
        softcap=cfg.attn_logit_softcap,
    )
    return _out(out, p.wo)


def cross_attention(cfg, p, x, memory):
    """Encoder-decoder cross attention: queries from ``x`` [B, S, D], keys
    and values from the encoder ``memory`` [B, S_enc, D]; no RoPE and no
    bias, as in the reference."""
    q, k, v = _proj(x, p.wq), _proj(memory, p.wk), _proj(memory, p.wv)
    return _out(blockwise_attention(q, k, v, causal=False), p.wo)


def decode_attention(cfg, p, x, cache_k, cache_v, cache_pos, cache_len, *,
                     kv_placements=None):
    """Single-token decode against a KV cache.

    x: [B, 1, D]; cache_k/v: [B, S, Hkv, Dh]; cache_pos: [S] the absolute
    position stored in each cache slot (-1 = empty; ring layout for
    sliding windows); cache_len: the current position, an int or a 0-d
    integer tensor.  The cache scores and the new token's own score share
    one softmax.
    Returns (out [B, 1, D], new_k [B, 1, Hkv, Dh], new_v).

    On a mesh, ``x`` and the parameters are DTensors and the cache is a
    rank's local shard of a state placed as ``kv_placements`` (one
    placement per mesh dimension, of a [B, S, Hkv, Dh] row): q, k and v
    are redistributed to those placements (a query head's KV head is then
    its rank's own: heads split in whole groups), the core runs on local
    tensors, and new_k/new_v come back as local shards, ready to write.
    """
    b = x.shape[0]
    pos = torch.as_tensor(cache_len, device=x.device).reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(cfg, p, x, pos)
    if kv_placements is None:
        out = _decode_core(cfg, q, k, v, cache_k, cache_v, cache_pos, pos[:1])
        return _out(out, p.wo), k, v
    from repro_torch.dist.sharding import from_local, local_shard

    shape = q.shape
    q, k, v = (local_shard(t, kv_placements) for t in (q, k, v))
    out = _decode_core(cfg, q, k, v, cache_k, cache_v, cache_pos, pos[:1])
    out = from_local(out, x.device_mesh, kv_placements, shape)
    return _out(out, p.wo), k, v


def _decode_core(cfg, q, k, v, cache_k, cache_v, cache_pos, pos):
    """The decode attention core on plain tensors: q [B, 1, H, Dh], k/v
    [B, 1, Hkv, Dh], the cache, pos [1, 1] -> [B, 1, H, Dh]."""
    dt = q.dtype
    b, s, hkv, dh = cache_k.shape
    h = q.shape[2]
    g = h // hkv
    scale = 1.0 / np.sqrt(dh)
    qh = q.reshape(b, hkv, g, dh)
    cp = cache_pos[None, :]
    valid = (cp >= 0) & (cp < pos)
    if cfg.sliding_window is not None:
        valid &= (pos - cp) <= cfg.sliding_window
    sc = torch.einsum("bhgd,bshd->bhgs", qh, cache_k).float() * scale
    s_self = torch.einsum("bhgd,bhd->bhg", qh, k[:, 0]).float() * scale
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        sc = cap * torch.tanh(sc / cap)
        s_self = cap * torch.tanh(s_self / cap)
    sc = torch.where(valid[:, None, None], sc, NEG_INF)
    full = torch.cat([sc, s_self[..., None]], dim=-1)
    w = torch.softmax(full, dim=-1).to(dt)
    out = torch.einsum("bhgs,bshd->bhgd", w[..., :-1], cache_v) + \
        w[..., -1][..., None] * v[:, 0][:, :, None, :]
    return out.reshape(b, 1, h, dh).to(dt)
