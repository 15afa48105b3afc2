"""GenASM: chained divide-and-conquer alignment (DC + TB per window).

The paper's read-alignment dataflow (Figure 4-3): the text region and
query pattern are cut into overlapping windows (W=64, O=24 by default);
per window GenASM-DC generates the intermediate bitvectors and GenASM-TB
commits up to ``W-O`` characters of traceback; windows repeat until the
pattern is consumed.

Port of `repro.core.genasm`.  The reference aligns one pair and vmaps
(`align_batch`); here :func:`align` itself takes ``[B, ...]`` and
advances the whole batch through its window steps together (one
``[B, w]`` DC call per step), which is also the loop
`repro_torch.align.batched` drives the CUDA kernels through — the two
differ only in the DC function, so they are bit-identical by
construction.  Each step traces a ``dc`` and a ``tb`` span (``window``:
the step) into the context's current tracer (`obs.trace.current_tracer`;
`core.mapper.LinearMapExecutor` sets it).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.obs import trace

from . import genasm_dc
from .bitvector import SENTINEL, WILDCARD, pattern_bitmasks
from .genasm_tb import OP_PAD, window_tb, window_tb_r


class GenASMConfig(NamedTuple):
    """Window geometry (paper defaults W=64, O=24, k_window=O)."""

    w: int = 64
    o: int = 24
    k: int = 24
    affine: bool = True
    store_r: bool = False  # v2 TB store: R rows only (3× less TB traffic)

    @property
    def commit(self) -> int:
        return self.w - self.o

    def n_windows(self, max_pattern_len: int) -> int:
        return -(-max_pattern_len // self.commit) + 2

    def ops_cap(self, p_cap: int) -> int:
        """CIGAR ops buffer width every backend emits at ``p_cap``."""
        return self.n_windows(p_cap) * 2 * self.commit


class AlignResult(NamedTuple):
    distance: torch.Tensor  # [B] int32 total edit distance (-1 if failed)
    ops: torch.Tensor  # [B, cap] int8 packed CIGAR (-1 padded)
    n_ops: torch.Tensor  # [B] int32
    text_consumed: torch.Tensor  # [B] int32
    failed: torch.Tensor  # [B] bool — a window had no alignment within k
    nodes: torch.Tensor | None = None  # [B, cap] int32 graph node per op (-1 = I)


def _pad(buf: torch.Tensor, lens: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``[B, *]`` buffers -> ``[B, size]``: trimmed, ``fill`` from ``lens`` on."""
    out = torch.full((buf.shape[0], size), fill, dtype=torch.int8, device=buf.device)
    n = min(buf.shape[1], size)
    out[:, :n] = buf[:, :n]
    idx = torch.arange(size, device=buf.device)
    return torch.where(idx < lens.unsqueeze(1), out, fill)


def pad_pattern(patterns: torch.Tensor, p_lens: torch.Tensor, cap: int,
                cfg: GenASMConfig) -> torch.Tensor:
    """Pad/trim pattern buffers to ``cap + w`` with wildcards after ``p_len``."""
    return _pad(patterns, p_lens, cap + cfg.w, WILDCARD)


def pad_text(texts: torch.Tensor, t_lens: torch.Tensor, cap: int,
             cfg: GenASMConfig) -> torch.Tensor:
    """Pad/trim text buffers to ``cap + w`` with sentinels after ``t_len``."""
    return _pad(texts, t_lens, cap + cfg.w, SENTINEL)


def slice_windows(buf: torch.Tensor, start: torch.Tensor, w: int) -> torch.Tensor:
    """Per-lane ``[B, w]`` windows of ``buf`` at ``start``.

    The start is clamped so the window fits, as ``lax.dynamic_slice``
    clamps it in the reference.
    """
    start = start.clamp(0, buf.shape[1] - w)
    idx = start.unsqueeze(1) + torch.arange(w, device=buf.device)
    return torch.gather(buf, 1, idx)


def window_commit(carry, *, d_min, pc, tc, err, n_ops, stuck, p_len, k):
    """Advance the window-scan carry by one DC+TB window's outcome.

    The single source of the commit rules (fail/stall masking, advance
    gating, completion); operands are ``[B]`` tensors.  Returns
    ``(new_carry, n_emit)`` where ``n_emit`` is the number of CIGAR ops
    this window contributes (0 for done/failed lanes).
    """
    cur_p, cur_t, dist, failed, done = carry
    this_fail = ((d_min > k) | stuck) & (~done)
    skip = done | this_fail
    adv_p = torch.where(skip, 0, pc)
    adv_t = torch.where(skip, 0, tc)
    n_emit = torch.where(skip, 0, n_ops)
    dist = dist + torch.where(skip, 0, err)
    new_done = skip | (cur_p + adv_p >= p_len)
    return (cur_p + adv_p, cur_t + adv_t, dist, failed | this_fail,
            new_done), n_emit


def align(texts: torch.Tensor, patterns: torch.Tensor, p_lens: torch.Tensor,
          t_lens: torch.Tensor, *, cfg: GenASMConfig = GenASMConfig(),
          p_cap: int | None = None, emit_cigar: bool = True,
          dc_fn: Callable | None = None) -> AlignResult:
    """Align ``patterns[b, :p_len]`` against ``texts[b, :t_len]``, anchored
    at ``texts[b, 0]``, for every lane ``b``.

    Semi-global: the pattern must be fully consumed, trailing text is
    free.  ``dc_fn(sub_texts, sub_patterns) -> (d_min, store)`` computes
    one window step's DC over all lanes; the default is the plain
    `genasm_dc.window_dc` (or `window_dc_r` when ``cfg.store_r``).
    """
    if p_cap is None:
        p_cap = int(patterns.shape[-1])
    n_win = cfg.n_windows(p_cap)
    max_steps = 2 * cfg.commit
    w, o, k = cfg.w, cfg.o, cfg.k
    dev = texts.device
    b = texts.shape[0]
    p_lens = p_lens.to(device=dev, dtype=torch.int64)
    t_lens = t_lens.to(device=dev, dtype=torch.int64)
    if dc_fn is None:
        dc = genasm_dc.window_dc_r if cfg.store_r else genasm_dc.window_dc

        def dc_fn(sub_t, sub_p):
            return dc(sub_t, sub_p, w=w, k=k)

    pats = pad_pattern(patterns, p_lens, p_cap, cfg)
    txts = pad_text(texts, t_lens, p_cap + n_win * cfg.commit, cfg)

    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    carry = (zeros, zeros, zeros, torch.zeros(b, dtype=torch.bool, device=dev),
             p_lens <= 0)
    ops_w, n_ops_w = [], []
    tr = trace.current_tracer()
    for i in range(n_win):
        cur_p, cur_t = carry[0], carry[1]
        sub_p = slice_windows(pats, cur_p, w)
        sub_t = slice_windows(txts, cur_t, w)
        with tr.device_span("dc", dev, window=i):
            d_min, store = dc_fn(sub_t, sub_p)
        with tr.span("tb", window=i):
            d_min = d_min.to(torch.int64)
            d_start = torch.clamp(d_min, max=k)
            cap_p = torch.clamp(p_lens - cur_p, max=cfg.commit)
            if cfg.store_r:
                pm = pattern_bitmasks(sub_p, w)
                pc, tc, err, ops, n_ops, stuck = window_tb_r(
                    store, sub_t, pm, d_start, cap_p, w=w, o=o, k=k,
                    affine=cfg.affine)
            else:
                pc, tc, err, ops, n_ops, stuck = window_tb(
                    store, d_start, cap_p, w=w, o=o, k=k, affine=cfg.affine)
            carry, n_emit = window_commit(
                carry, d_min=d_min, pc=pc, tc=tc, err=err,
                n_ops=n_ops, stuck=stuck, p_len=p_lens, k=k)
        ops_w.append(ops)
        n_ops_w.append(n_emit)

    _, fin_t, dist, failed, done = carry
    failed = failed | (~done)
    n_ops_w = torch.stack(n_ops_w, dim=1)  # [B, n_win]
    cap = n_win * max_steps
    if emit_cigar:
        ops_w = torch.stack(ops_w, dim=1)  # [B, n_win, max_steps]
        offsets = torch.cumsum(n_ops_w, dim=1) - n_ops_w  # exclusive prefix
        step_idx = torch.arange(max_steps, device=dev)
        valid = step_idx < n_ops_w.unsqueeze(-1)
        # slot ``cap`` takes the invalid steps and is dropped, as the
        # reference's ``.at[pos].set(mode="drop")`` drops them
        pos = torch.where(valid, offsets.unsqueeze(-1) + step_idx, cap)
        out = torch.full((b, cap + 1), OP_PAD, dtype=torch.int8, device=dev)
        out.scatter_(1, pos.reshape(b, -1), ops_w.reshape(b, -1))
        out = out[:, :cap]
    else:
        out = torch.full((b, 1), OP_PAD, dtype=torch.int8, device=dev)

    return AlignResult(
        distance=torch.where(failed, -1, dist).to(torch.int32),
        ops=out,
        n_ops=n_ops_w.sum(dim=1).to(torch.int32),
        text_consumed=fin_t.to(torch.int32),
        failed=failed,
    )


def align_batch(texts, patterns, p_lens, t_lens, *,
                cfg: GenASMConfig = GenASMConfig(),
                emit_cigar: bool = True) -> AlignResult:
    """The reference's batched signature over :func:`align`, which is
    batched already (the reference vmaps its one-pair ``align``)."""
    return align(texts, patterns, p_lens, t_lens, cfg=cfg,
                 emit_cigar=emit_cigar)
