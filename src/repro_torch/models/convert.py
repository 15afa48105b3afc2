"""The weight carrier between the reference's parameter tree and a model.

The reference keeps parameters as a nested dict, with every block's
leaves stacked over a leading axis (``init_params`` vmaps the block
init: ``blocks`` over ``n_blocks``; the encoder-decoder's
``enc_blocks`` and ``dec_blocks`` over their layers).  Its checkpoints
flatten that tree to ``"::"``-joined keys (``blocks::slot0::attn::wq``).
Here a block is a module of its own: ``blocks.{b}.slot0.attn.wq`` is
row ``b`` of that stacked leaf, ``dec_blocks.{i}.xattn.wq`` row ``i``.
``params_to_jax_tree`` and ``load_jax_tree`` map between the two, so a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .model_zoo import model_class, resolve_device

SEP = "::"
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict -> ``{"a::b::c": leaf}``; a flat dict passes through."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def jax_key(name: str) -> tuple[str, int | None]:
    """Module parameter name -> (flat reference key, block row or None)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return SEP.join([parts[0], *parts[2:]]), int(parts[1])
    return SEP.join(parts), None


def params_to_jax_tree(model: nn.Module) -> dict[str, np.ndarray]:
    """The reference's flat keys and shapes (blocks stacked), as fp32 numpy."""
    out: dict[str, np.ndarray] = {}
    rows: dict[str, dict[int, np.ndarray]] = {}
    for name, p in model.named_parameters():
        key, blk = jax_key(name)
        a = p.detach().float().cpu().numpy()
        if blk is None:
            out[key] = a
        else:
            rows.setdefault(key, {})[blk] = a
    for key, by_blk in rows.items():
        out[key] = np.stack([by_blk[b] for b in range(len(by_blk))])
    return out


def load_jax_tree(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a reference tree (nested or flat ``"::"`` keys) into ``model``
    in place; every key must match a parameter, shape for shape."""
    flat = flatten(tree)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            key, blk = jax_key(name)
            if key not in flat:
                raise KeyError(f"{key}: missing from the tree")
            a = np.asarray(flat[key])
            a = a if blk is None else a[blk]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {a.shape} != {tuple(p.shape)}")
            a = np.asarray(a, dtype=np.float32)
            if not a.flags.writeable:  # a view of a read-only (JAX) buffer
                a = a.copy()
            p.copy_(torch.from_numpy(a))
            used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"tree keys with no parameter: {extra}")
    return model


def params_from_jax(cfg, tree: Mapping, *, device="cuda") -> nn.Module:
    """The config's model (a DecoderLM or an EncDecLM) on ``device``,
    holding the reference tree's weights."""
    model = model_class(cfg)(cfg, device="meta").to_empty(
        device=resolve_device(device))
    return load_jax_tree(model, tree)
