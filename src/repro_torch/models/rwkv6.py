"""RWKV-6 "Finch" time mix with data-dependent decay (arXiv:2404.05892).

Port of `repro.models.rwkv6` in plain PyTorch ops (the reference's WKV
recurrence is plain `jnp`: no Pallas kernel lies on this path).  The WKV
state is a per-head [dh, dh] matrix updated with a per-channel,
data-dependent decay; the recurrence runs one time step after another,
as the reference's inner ``lax.scan``, and the chunking only decides
which lengths are accepted (the reference's reshape rule).  The decay's
LoRA is an fp32 product, as in the reference.  Channel mix is the RWKV
gated MLP.  Decode carries (last-token shift, WKV state), updated in
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import COMPUTE_DTYPE, EMBED, HEADS, MLP, dense_init, holder
from .mamba import n_chunks

LORA_R = 64


def rwkv_init(cfg, *, generator=None, device=None):
    d = cfg.d_model
    h = cfg.n_heads if cfg.n_heads > 0 else d // 64
    dh = d // h
    kw = dict(generator=generator, device=device)
    return holder(
        mu=torch.full((5, d), 0.5, device=device),  # token-shift mixes r,k,v,w,g
        wr=dense_init((d, d), **kw), wk=dense_init((d, d), **kw),
        wv=dense_init((d, d), **kw), wg=dense_init((d, d), **kw),
        wo=dense_init((d, d), **kw),
        w0=torch.full((d,), -6.0, device=device),  # decay bias
        w_lora_a=dense_init((d, LORA_R), **kw),
        w_lora_b=dense_init((LORA_R, d), **kw).mul_(0.1),
        u=torch.zeros((h, dh), device=device),  # bonus (first-occurrence) term
        ln_x=torch.ones(d, device=device),
    )


RWKV_AXES = {
    "mu": (None, EMBED),
    "wr": (EMBED, MLP), "wk": (EMBED, MLP), "wv": (EMBED, MLP),
    "wg": (EMBED, MLP), "wo": (MLP, EMBED),
    "w0": (EMBED,), "w_lora_a": (EMBED, None), "w_lora_b": (None, EMBED),
    "u": (HEADS, None), "ln_x": (EMBED,),
}


def _time_shift(x, last=None):
    """x: [B, L, D] -> the previous token's x (zeros, or ``last``, at 0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_step(S, r, k, v, w, u):
    """One time step.  r/k/v/w: [B, H, dh]; S: [B, H, dh(k), dh(v)];
    y = r . S + (r . u) v, the bonus term without k as the reference's
    einsum writes it; S <- diag(w) S + k (x) v."""
    y = torch.einsum("bhk,bhkv->bhv", r, S) + (r * u).sum(-1, keepdim=True) * v
    return S * w[..., None] + k[..., None] * v[:, :, None, :], y


def _wkv_chunked(r, k, v, w, u, chunk: int):
    """WKV linear attention with per-step decay over r/k/v/w [B, L, H, dh]
    fp32 (w the decay in (0, 1)); u: [H, dh].  Returns (y [B, L, H, dh],
    the final state)."""
    b, L, h, dh = r.shape
    n_chunks(L, chunk)
    S = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(L):
        S, y = _wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _wkv_on_shards(cfg, r, k, v, w, u, wkv=None):
    """The WKV recurrence of DTensor r/k/v/w [B, L, H, dh] on each rank's
    local shards: batch rows and heads are independent, so a mesh
    dimension keeps r's batch (dim 0) or head (dim 2) shard and k, v, w
    and the bonus ``u`` [H, dh] are redistributed alike (anything else is
    replicated).  Left to DTensor, every time step's einsums would flatten
    the sharded batch and head dims together.  With ``wkv`` (one block's
    rows of a placed decode state, [B, H, dh, dh]) it takes one step from
    that state and writes the new state back in the state's placements.
    Returns y [B, L, H, dh], a DTensor."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import (from_local, local_shard,
                                           work_placements, write_state)

    mesh = r.device_mesh
    keep = work_placements(r)
    heads = tuple(Shard(0) if pl.is_shard(2) else Replicate()
                  for pl in keep)  # u's [H, dh] placements
    shape = r.shape
    r, k, v, w = (local_shard(t, keep) for t in (r, k, v, w))
    u = local_shard(u, heads, keep)
    if wkv is None:
        chunk = min(cfg.mamba.chunk if cfg.mamba else 128, shape[1])
        y, _ = _wkv_chunked(r, k, v, w, u, chunk)
    else:
        rows = tuple(Shard(1) if pl.is_shard(2) else pl for pl in keep)
        S, y = _wkv_step(wkv.redistribute(mesh, rows).to_local(), r[:, 0],
                         k[:, 0], v[:, 0], w[:, 0], u)
        write_state(wkv, from_local(S, mesh, rows, wkv.shape))
        y = y[:, None]
    return from_local(y, mesh, keep, shape)


def rwkv_apply(cfg, p, x, *, shift=None, wkv=None):
    """Time-mix block.  x: [B, L, D].  With a decode state (``shift`` [B, D],
    ``wkv`` [B, H, dh, dh], one block's rows) the block takes one step
    (L = 1) from it and updates both in place."""
    dt_ = x.dtype
    b, L, d = x.shape
    h = cfg.n_heads
    dh = d // h
    xprev = _time_shift(x, shift)
    mu = p.mu.to(dt_)

    def mix(i):
        return x * mu[i] + xprev * (1 - mu[i])

    def heads(i, wt):
        return (mix(i) @ wt.to(dt_)).reshape(b, L, h, dh).float()

    r, k, v = heads(0, p.wr), heads(1, p.wk), heads(2, p.wv)
    # data-dependent decay (the Finch contribution), in fp32
    dd = torch.tanh(mix(3).float() @ p.w_lora_a) @ p.w_lora_b
    w = torch.exp(-torch.exp(p.w0 + dd)).reshape(b, L, h, dh)
    g = F.silu(mix(4) @ p.wg.to(dt_))

    if hasattr(r, "to_local"):
        y = _wkv_on_shards(cfg, r, k, v, w, p.u, wkv)
        if shift is not None:
            from repro_torch.dist.sharding import write_state

            write_state(shift, x[:, -1])
    elif wkv is None:
        chunk = min(cfg.mamba.chunk if cfg.mamba else 128, L)
        y, _ = _wkv_chunked(r, k, v, w, p.u, chunk)
    else:
        S, y = _wkv_step(wkv, r[:, 0], k[:, 0], v[:, 0], w[:, 0], p.u)
        y = y[:, None]
        shift.copy_(x[:, -1])
        wkv.copy_(S)
    # group norm over heads (ln_x), population variance
    yh = y.reshape(b, L, d).to(dt_).reshape(b, L, h, dh).float()
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + 1e-5)
    y = (yh.reshape(b, L, d) * p.ln_x).to(dt_) * g
    return y @ p.wo.to(dt_)


def rwkv_channel_mix_init(cfg, *, generator=None, device=None):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)
    return holder(mu=torch.full((2, d), 0.5, device=device),
                  wk=dense_init((d, f), **kw), wv=dense_init((f, d), **kw),
                  wr=dense_init((d, d), **kw))


RWKV_CM_AXES = {"mu": (None, EMBED), "wk": (EMBED, MLP), "wv": (MLP, EMBED),
                "wr": (EMBED, MLP)}


def rwkv_channel_mix(cfg, p, x, *, shift=None):
    """The RWKV gated MLP; with ``shift`` [B, D] (a decode state row) the
    previous token comes from it and it is updated in place."""
    dt_ = x.dtype
    xprev = _time_shift(x, shift)
    mu = p.mu.to(dt_)
    xk = x * mu[0] + xprev * (1 - mu[0])
    xr = x * mu[1] + xprev * (1 - mu[1])
    kk = torch.square(F.relu(xk @ p.wk.to(dt_)))
    out = torch.sigmoid(xr @ p.wr.to(dt_)) * (kk @ p.wv.to(dt_))
    if hasattr(shift, "to_local"):  # a row of a placed decode state
        from repro_torch.dist.sharding import write_state

        write_state(shift, x[:, -1])
    elif shift is not None:
        shift.copy_(x[:, -1])
    return out


def rwkv_decode_init(cfg, batch: int, n_blocks: int, *, device=None):
    """Decode state of an rwkv slot, stacked over ``n_blocks``."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    nb = n_blocks

    def shift():
        return torch.zeros((nb, batch, d), dtype=COMPUTE_DTYPE, device=device)

    return {"tm": {"shift": shift(),
                   "wkv": torch.zeros((nb, batch, h, dh, dh),
                                      dtype=torch.float32, device=device)},
            "cm": {"shift": shift()}}
