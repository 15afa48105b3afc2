"""Mamba (S6 selective scan) block for the Jamba hybrid architecture.

Port of `repro.models.mamba` in plain PyTorch ops (the reference's scan
is plain `jnp`: no Pallas kernel lies on this path).  The scan inputs
are stored in bf16 and each chunk's recurrence runs in fp32.  Within a
chunk the diagonal recurrence ``h_t = a_t h_{t-1} + b_t`` is a
log-depth doubling scan over the chunk axis (7 steps at chunk 128) in
place of the reference's ``lax.associative_scan``; the chunk boundary
state is carried by a Python loop, each chunk recomputed in the
backward.  Decode keeps (conv window, h state) per layer and updates
them in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import COMPUTE_DTYPE, EMBED, MLP, dense_init, holder
# a name the reference module binds too
from .layers import STATE  # noqa: F401


def mamba_init(cfg, *, generator=None, device=None):
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    dt_rank = max(d // 16, 1)
    kw = dict(generator=generator, device=device)
    conv_w = torch.empty((mc.d_conv, di), dtype=torch.float32, device=device)
    if conv_w.device.type != "meta":
        conv_w.normal_(0.0, 1.0, generator=generator).mul_(0.1)
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32, device=device)
    return holder(
        in_proj=dense_init((d, 2 * di), **kw),
        conv_w=conv_w,
        conv_b=torch.zeros(di, device=device),
        x_proj=dense_init((di, dt_rank + 2 * mc.d_state), **kw),
        dt_proj=dense_init((dt_rank, di), **kw),
        dt_bias=torch.zeros(di, device=device),
        A_log=torch.log(a).expand(di, mc.d_state).clone(),
        D=torch.ones(di, device=device),
        out_proj=dense_init((di, d), **kw),
    )


MAMBA_AXES = {
    "in_proj": (EMBED, MLP),
    "conv_w": (None, MLP),
    "conv_b": (MLP,),
    "x_proj": (MLP, None),
    "dt_proj": (None, MLP),
    "dt_bias": (MLP,),
    "A_log": (MLP, None),
    "D": (MLP,),
    "out_proj": (MLP, EMBED),
}


def n_chunks(L: int, chunk: int) -> int:
    """The reference's chunking of a length-``L`` scan: ``L // chunk``
    chunks (at least one) of ``L // nc`` steps.  It reshapes ``L`` into
    that product and fails where the product is not ``L`` (``L = 257``
    at chunk 128); so does the port, without padding."""
    nc = max(L // chunk, 1)
    if nc * (L // nc) != L:
        raise ValueError(f"a scan of length {L} does not split into "
                         f"{nc} chunks of {L // nc} (chunk {chunk})")
    return nc


def _doubling_scan(a, b):
    """Inclusive scan of ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)`` over
    axis 1 in log2(c) steps (Hillis-Steele)."""
    c = a.shape[1]
    off = 1
    while off < c:
        a, b = (torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1),
                torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], 1))
        off *= 2
    return a, b


def _chunk_step(h, uc, dtc, bc, cc, A):
    # uc/dtc: [b, c, di], bc/cc: [b, c, n], bf16 storage; h: [b, di, n] fp32
    uc, dtc, bc, cc = uc.float(), dtc.float(), bc.float(), cc.float()
    da = torch.exp(dtc[..., None] * A)  # [b, c, di, n]
    dbu = (dtc * uc)[..., None] * bc[:, :, None, :]
    a_acc, b_acc = _doubling_scan(da, dbu)
    h_t = a_acc * h[:, None] + b_acc
    y = torch.einsum("bcdn,bcn->bcd", h_t, cc)
    return h_t[:, -1], y


def _ssm_chunked(u, dt, B, C, A, chunk: int):
    """Diagonal SSM over time, chunked.

    u/dt: [b, L, di]; B/C: [b, L, n]; A: [di, n].  Returns y [b, L, di]
    fp32.
    """
    b, L, di = u.shape
    nc = n_chunks(L, chunk)
    h = torch.zeros((b, di, B.shape[-1]), dtype=torch.float32, device=u.device)
    ys = []
    for args in zip(*(t.chunk(nc, dim=1) for t in (u, dt, B, C))):
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk_step, h, *args, A, use_reentrant=False)
        else:
            h, y = _chunk_step(h, *args, A)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _on_shards(x, channel: int):
    """The placements a per-channel op keeps for DTensor ``x`` [b, L, C]:
    each mesh dim keeps a batch (dim 0) or channel (dim 2) shard, and
    replicates otherwise; and, for a [.., C] or [C, ..] operand whose
    channel dim is ``channel``, its matching placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import work_placements

    keep = work_placements(x)
    chan = tuple(Shard(channel) if pl.is_shard(2) else Replicate()
                 for pl in keep)
    return keep, chan


def _causal_conv(xs, w, b, d_conv: int):
    """Depthwise causal conv1d of xs [B, L, di] with w [d_conv, di], summed
    term by term in the input dtype, plus the bias, then SiLU."""
    L = xs.shape[1]
    xp = F.pad(xs, (0, 0, d_conv - 1, 0))
    conv = xp[:, 0: L] * w[0]
    for i in range(1, d_conv):
        conv = conv + xp[:, i: i + L] * w[i]
    return F.silu(conv + b)


def _conv_on_shards(xs, w, b, d_conv: int):
    """``_causal_conv`` of DTensors on each rank's batch rows and channels
    as local tensors (PyTorch 2.11's DTensor fails on the pad)."""
    from repro_torch.dist.sharding import from_local, local_shard

    keep, w_chan = _on_shards(xs, 1)
    _, b_chan = _on_shards(xs, 0)
    y = _causal_conv(local_shard(xs, keep), local_shard(w, w_chan, keep),
                     local_shard(b, b_chan, keep), d_conv)
    return from_local(y, xs.device_mesh, keep, xs.shape)


def _ssm_on_shards(u, dt, B, C, A, chunk: int):
    """``_ssm_chunked`` of DTensors on each rank's batch rows and channels
    as local tensors: u/dt keep their batch and channel shards, B/C their
    batch shard (replicated over the channel axes) and A [di, n] the
    channel shard."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import from_local, local_shard

    keep, chan = _on_shards(u, 0)
    rows = tuple(pl if pl.is_shard(0) else Replicate() for pl in keep)
    y = _ssm_chunked(local_shard(u, keep), local_shard(dt, keep),
                     local_shard(B, rows, keep), local_shard(C, rows, keep),
                     local_shard(A, chan, keep), chunk)
    return from_local(y, u.device_mesh, keep, u.shape)


def _split_proj(mc, p, xs):
    proj = xs @ p.x_proj.to(xs.dtype)
    dt_rank = p.dt_proj.shape[0]
    dt_x, Bx, Cx = torch.split(proj, [dt_rank, mc.d_state, mc.d_state], dim=-1)
    delta = F.softplus(dt_x @ p.dt_proj.to(xs.dtype)
                       + p.dt_bias.to(xs.dtype)).float()
    return delta, Bx, Cx


def mamba_apply(cfg, p, x):
    """x: [B, L, D] -> [B, L, D]."""
    mc = cfg.mamba
    dt_ = x.dtype
    xs, z = torch.chunk(x @ p.in_proj.to(dt_), 2, dim=-1)  # [B, L, di]

    # depthwise causal conv1d, summed term by term in bf16
    sharded = hasattr(xs, "to_local")
    conv = _conv_on_shards if sharded else _causal_conv
    xs = conv(xs, p.conv_w.to(dt_), p.conv_b.to(dt_), mc.d_conv)

    delta, Bx, Cx = _split_proj(mc, p, xs)
    A = -torch.exp(p.A_log)  # [di, n]
    bf = torch.bfloat16
    scan = _ssm_on_shards if sharded else _ssm_chunked
    y = scan(xs.to(bf), delta.to(bf), Bx.to(bf), Cx.to(bf), A, mc.chunk)
    y = (y + xs.float() * p.D).to(dt_)
    y = y * F.silu(z)
    return y @ p.out_proj.to(dt_)


def mamba_decode_init(cfg, batch: int, n_blocks: int, *, device=None):
    """Decode state of a mamba slot, stacked over ``n_blocks``."""
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    return {"conv": torch.zeros((n_blocks, batch, mc.d_conv - 1, di),
                                dtype=COMPUTE_DTYPE, device=device),
            "h": torch.zeros((n_blocks, batch, di, mc.d_state),
                             dtype=torch.float32, device=device)}


def mamba_decode(cfg, p, x, conv_state, h_state):
    """Single-token decode.  x: [B, 1, D]; ``conv_state`` [B, d_conv-1, di]
    and ``h_state`` [B, di, n] are one block's rows of the decode state,
    updated in place (DTensor rows keep their placements:
    `dist.sharding.write_state`).  Returns [B, 1, D]."""
    mc = cfg.mamba
    dt_ = x.dtype
    xs, z = torch.chunk(x[:, 0] @ p.in_proj.to(dt_), 2, dim=-1)
    window = torch.cat([conv_state, xs[:, None]], dim=1)  # [B, d_conv, di]
    conv = torch.einsum("bkd,kd->bd", window, p.conv_w.to(dt_))
    xs = F.silu(conv + p.conv_b.to(dt_))
    delta, Bx, Cx = _split_proj(mc, p, xs)
    A = -torch.exp(p.A_log)
    dA = torch.exp(delta[..., None] * A)  # [B, di, n]
    h = dA * h_state + (delta * xs.float())[..., None] * Bx.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cx.float())
    y = (y + xs.float() * p.D).to(dt_) * F.silu(z)
    if hasattr(conv_state, "to_local"):  # rows of a placed decode state
        from repro_torch.dist.sharding import write_state

        write_state(conv_state, window[:, 1:])
        write_state(h_state, h)
    else:
        conv_state.copy_(window[:, 1:])
        h_state.copy_(h)
    return (y @ p.out_proj.to(dt_))[:, None]
