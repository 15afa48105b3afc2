"""Shared model layers: norms, RoPE, MLPs, the chunked loss.

Port of `repro.models.layers`.  Parameters are fp32 and cast to the
compute dtype, bf16, at use; norms, RoPE and the loss run in fp32
inside.  The functions take the parameter holders of
`repro_torch.models.transformer` (modules whose attributes are the JAX
tree's leaf names) and plain tensors.  Attention, the MLPs and the loss
are plain PyTorch ops, as the reference writes them in plain `jnp`: no
Pallas kernel lies on this path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

COMPUTE_DTYPE = torch.bfloat16

# logical axis names (resolved to mesh axes in `repro_torch.dist.sharding`)
EMBED, MLP, HEADS, KV_HEADS, QKV, VOCAB, EXPERT, CONV, STATE, NONE = (
    "embed", "mlp", "heads", "kv_heads", "qkv", "vocab", "expert", "conv",
    "state", None,
)


def dense_init(shape, in_axis=0, *, generator=None, device=None) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in fp32; ``in_axis`` may be a tuple."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis]))
    scale = 1.0 / np.sqrt(fan_in)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        out.uniform_(-scale, scale, generator=generator)
    return out


def holder(**tensors: torch.Tensor) -> nn.Module:
    """A module whose parameters are ``tensors`` under their own names."""
    m = nn.Module()
    for name, t in tensors.items():
        m.register_parameter(name, nn.Parameter(t))
    return m


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def make_norm(cfg, d, *, device=None) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return holder(scale=torch.ones(d, device=device))
    return holder(scale=torch.ones(d, device=device),
                  bias=torch.zeros(d, device=device))


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # one host-to-device copy per (head_dim, theta, device), not one a call
    return torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                        device=device)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, Dh]; positions: [..., S] integer.  Half-rotation RoPE:
    the head dim splits into halves (x1, x2), not interleaved pairs."""
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, theta, x.device)  # [dh/2]
    ang = positions[..., :, None].float() * freqs  # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(cfg, d_model=None, d_ff=None, *, generator=None, device=None):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    if cfg.act == "silu_glu":
        return holder(wi=dense_init((d, f), **kw), wg=dense_init((d, f), **kw),
                      wo=dense_init((f, d), **kw))
    return holder(wi=dense_init((d, f), **kw), wo=dense_init((f, d), **kw))


MLP_AXES = {
    "wi": (EMBED, MLP),
    "wg": (EMBED, MLP),
    "wo": (MLP, EMBED),
}


def mlp_apply(cfg, p, x):
    dt = x.dtype
    if cfg.act == "silu_glu":
        h = F.silu(x @ p.wg.to(dt)) * (x @ p.wi.to(dt))
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(x @ p.wi.to(dt)))
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p.wi.to(dt), approximate="tanh")
    return h @ p.wo.to(dt)


def embed_init(cfg, *, generator=None, device=None):
    w = torch.empty((cfg.padded_vocab, cfg.d_model), dtype=torch.float32,
                    device=device)
    if w.device.type != "meta":
        w.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    return holder(tokens=w)


def _xent_chunk(xc, et, tc, mc):
    logits = (xc @ et).float()  # [B, c, V]
    if hasattr(logits, "to_local"):
        return _xent_on_shards(logits, tc, mc)
    return _xent_sums(logits, tc, mc)


def _xent_on_shards(logits, tc, mc):
    """The chunk's sums from DTensor logits: the vocab dim gathered whole,
    then each rank sums its own rows (targets and mask placed alike) and
    the sums are partial over the mesh dims that split the rows.  DTensor's
    gather along a sharded vocab dim, and its backward, have no rule that
    takes these placements in every PyTorch release."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(2) else p
               for p in logits.placements)
    logits = logits.redistribute(mesh, pl)
    loss, acc = _xent_sums(logits.to_local(), tc.redistribute(mesh, pl).to_local(),
                           mc.redistribute(mesh, pl).to_local())
    sums = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    return (DTensor.from_local(loss, mesh, sums),
            DTensor.from_local(acc, mesh, sums))


def _xent_sums(logits, tc, mc):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
    loss = torch.sum((lse - tgt) * mc)
    acc = torch.sum((torch.argmax(logits, -1) == tc) * mc)
    return loss, acc


def chunked_logits_xent(x, emb, targets, mask, *, chunk: int = 512):
    """Cross-entropy against a tied/untied vocab projection, seq-chunked.

    ``x``: [B, S, D]; ``emb``: [V, D]; ``targets``/``mask``: [B, S].
    Each chunk's [B, c, V] logits exist only inside a checkpoint: the
    backward recomputes them instead of keeping every chunk's fp32 logits,
    as the reference's ``lax.scan`` body does.
    """
    b, s, d = x.shape
    n_chunks = max(s // chunk, 1)
    c = s // n_chunks
    xs = x.reshape(b, n_chunks, c, d)
    ts = targets.reshape(b, n_chunks, c).long()
    ms = mask.reshape(b, n_chunks, c).float()
    et = emb.to(COMPUTE_DTYPE).T
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        args = (xs[:, i], et, ts[:, i], ms[:, i])
        if torch.is_grad_enabled():
            lc, ac = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            lc, ac = _xent_chunk(*args)
        loss = loss + lc
        acc = acc + ac
    denom = torch.clamp(torch.sum(mask.float()), min=1.0)
    return loss / denom, acc / denom
