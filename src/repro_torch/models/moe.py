"""Mixture-of-Experts MLP with capacity-based dispatch.

Port of `repro.models.moe`, step for step in plain PyTorch ops (the
reference writes it in plain `jnp`: no Pallas kernel lies on this
path).  Top-k routing in fp32 over a bf16 router product, capacity
factor token dropping, the Switch-style auxiliary load-balance loss.

Three places where the two libraries differ and the port follows the
reference:

- ``lax.top_k`` puts the lower expert index first among equal
  probabilities and ``torch.topk`` promises no order, so the top k are
  the first k of a stable descending sort.
- Every kept slot of the ``[E, cap]`` dispatch buffer receives exactly
  one token, so the reference's scatter-add into it is an indexed copy;
  the tokens past an expert's capacity all go to one trash row that is
  discarded.
- The reference's combine, ``.at[tok_id].add``, sums a token's k expert
  rows in bf16 one after another.  The port adds them in that order over
  a ``[T, k, D]`` view; ``index_add_`` would leave the order to CUDA's
  atomics, and greedy decoding would no longer be deterministic.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import EMBED, EXPERT, MLP, dense_init, holder
# a name the reference module binds too
from .layers import COMPUTE_DTYPE  # noqa: F401

# dispatch-group size in tokens: the reference's constant, read at call time
MOE_CHUNK_TOKENS = 16_384


def moe_init(cfg, *, generator=None, device=None):
    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.d_ff_expert
    kw = dict(generator=generator, device=device)
    p = dict(router=dense_init((d, e), **kw),
             wi=dense_init((e, d, f), in_axis=1, **kw),
             wg=dense_init((e, d, f), in_axis=1, **kw),
             wo=dense_init((e, f, d), in_axis=1, **kw))
    if cfg.act != "silu_glu":
        del p["wg"]
    return holder(**p)


MOE_AXES = {
    "router": (EMBED, None),
    "wi": (EXPERT, EMBED, MLP),
    "wg": (EXPERT, EMBED, MLP),
    "wo": (EXPERT, MLP, EMBED),
}


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``max(ceil(t / E * cf * k), k)``."""
    m = cfg.moe
    return max(math.ceil(t / m.n_experts * m.capacity_factor * m.top_k),
               m.top_k)


def route(cfg, p, xt):
    """xt: [T, D] -> (probs [T, E] fp32, top-k weights [T, k] fp32
    normalised, top-k experts [T, k] int64, lower index first on a tie)."""
    logits = (xt @ p.router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    topw, tope = topw[:, :k], tope[:, :k]
    return probs, topw / topw.sum(-1, keepdim=True), tope


def slots(cfg, tope, cap: int):
    """Each (token, choice)'s row of the flattened ``[E * cap]`` buffer,
    token-major: ``E * cap`` (the trash row) past an expert's capacity.
    Returns (slot [T * k] int64, keep [T * k] bool)."""
    e = cfg.moe.n_experts
    flat_e = tope.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)).long()
    pos = torch.gather(torch.cumsum(onehot, 0), 1, flat_e[:, None])[:, 0] - 1
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, e * cap))
    return slot, keep


def _constrain(x, mesh, want):
    """The reference's sharding constraint: the DTensor ``x`` redistributed
    to ``want`` as `dist.sharding._fit` resolves it; no-op without a mesh."""
    if mesh is None:
        return x
    from repro_torch.dist.sharding import _fit, placements

    return x.redistribute(mesh, placements(_fit(mesh, x.shape, want), mesh))


def _moe_chunk(cfg, p, xt, mesh=None):
    """Route, dispatch, expert compute and combine for one token chunk.
    xt: [T, D] -> ([T, D], aux scalar fp32).

    With a mesh, ``xt`` and the parameters are DTensors.  Routing sees the
    whole chunk, as the reference's global cumsum does under GSPMD: the
    tokens and the router are replicated and routed as local tensors on
    every rank alike; the ``[E, cap, D]`` dispatch and the expert outputs
    are constrained over "model" (expert parallelism), and the combine
    runs on the replicated expert outputs.
    """
    m = cfg.moe
    t, d = xt.shape
    e, k = m.n_experts, m.top_k
    cap = capacity(cfg, t)
    if mesh is not None:
        from repro_torch.dist.sharding import replicated_local, wrap_replicated

        xt = replicated_local(xt)
        probs, topw, tope = route(
            cfg, SimpleNamespace(router=replicated_local(p.router)), xt)
    else:
        probs, topw, tope = route(cfg, p, xt)

    me = probs.mean(0)
    ce = (tope[..., None] == torch.arange(e, device=xt.device)).float().sum(1).mean(0)
    aux = m.router_aux_coef * e * torch.sum(me * ce)

    slot, keep = slots(cfg, tope, cap)
    tok_id = torch.arange(t * k, device=xt.device) // k  # no host sync
    disp = xt.new_zeros((e * cap + 1, d)).index_copy(0, slot, xt[tok_id])
    disp = disp[:-1].reshape(e, cap, d)
    if mesh is not None:
        disp = _constrain(wrap_replicated(disp, mesh), mesh, ("model", None, None))

    dt = xt.dtype
    if cfg.act == "silu_glu":
        h = F.silu(torch.bmm(disp, p.wg.to(dt))) * torch.bmm(disp, p.wi.to(dt))
    else:
        h = torch.square(F.relu(torch.bmm(disp, p.wi.to(dt))))
    eo = torch.bmm(h, p.wo.to(dt))  # [E, cap, D]
    if mesh is not None:
        eo = replicated_local(_constrain(eo, mesh, ("model", None, None)))

    eo_flat = torch.cat([eo.reshape(e * cap, d), eo.new_zeros((1, d))])
    w = (topw.reshape(-1) * keep).to(dt)
    contrib = (eo_flat[slot] * w[:, None]).reshape(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    if mesh is not None:
        return wrap_replicated(out, mesh), wrap_replicated(aux, mesh)
    return out, aux


def moe_apply(cfg, p, x, mesh=None):
    """x: [B, S, D] -> ([B, S, D], aux loss scalar fp32).

    Tokens are dispatched in ``MOE_CHUNK_TOKENS`` chunks when there are at
    least two that divide the tokens evenly, each recomputed in the
    backward; the aux loss is then the mean over chunks.  On a mesh the
    chunks are cut from the gathered tokens (the chunk loop cannot slice
    the data-sharded token dim), as one chunk's tokens are gathered.
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    n_chunks = max(t // MOE_CHUNK_TOKENS, 1)
    if t % n_chunks:
        n_chunks = 1  # irregular sizes: one chunk, as the reference
    on_mesh = () if mesh is None else (mesh,)
    if n_chunks == 1:
        out, aux = _moe_chunk(cfg, p, xt, *on_mesh)
        return out.reshape(b, s, d), aux
    outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    if mesh is not None:  # each chunk is routed whole: gather every token
        from torch.distributed.tensor import Replicate

        xt = xt.redistribute(mesh, (Replicate(),) * mesh.ndim)
    for xc in xt.reshape(n_chunks, t // n_chunks, d):
        if torch.is_grad_enabled():
            o, a = checkpoint(_moe_chunk, cfg, p, xc, *on_mesh,
                              use_reentrant=False)
        else:
            o, a = _moe_chunk(cfg, p, xc, *on_mesh)
        outs.append(o)
        aux = aux + a
    return torch.cat(outs).reshape(b, s, d), aux / n_chunks
