"""The linear read mapper in plain PyTorch: the benchmark's reference answer.

Seed and extend (paper Figure 2-2): minimizer seeds vote for candidate
diagonals; a GenASM-DC filter takes the exact distance of each read's
first ``filter_bits`` bases against every candidate region and refines
its start; the best candidate by ``(distance, position)`` is aligned by
windowed GenASM.  Built from the benchmark's own reference sequence and
its own index, with nothing taken from the program.
"""
from __future__ import annotations

import torch

from . import genasm, index
from .bits import SENTINEL, WILDCARD

POS_SENTINEL = 2 ** 31 - 1


def ref_window(buf, start, size: int):
    """``[..., size]`` windows of ``buf`` at ``start`` (clamped into
    ``[0, len]``), the sentinel past its end."""
    n = buf.shape[0]
    idx = start.clamp(0, n).unsqueeze(-1) + torch.arange(size, device=buf.device)
    return torch.where(idx < n, buf[idx.clamp(max=n - 1)], SENTINEL)


def lex_best(fd, fpos):
    """Per row, the index of the least ``(distance, position)``."""
    pm = torch.where(fd == fd.min(-1, keepdim=True).values, fpos, POS_SENTINEL)
    return pm.argmin(-1)


def map_reads(ref: torch.Tensor, idx: index.Index, reads, lens, *, p: dict,
              filter_bits: int | None = None) -> dict:
    """Map ``reads [B, cap]`` (``lens [B]``) against ``ref``.

    ``p`` holds the deployment's mapper settings (``p_cap``, ``w``, ``o``,
    ``k``, ``filter_bits``, ``filter_k``, ``max_candidates``,
    ``minimizer_w``, ``minimizer_k``); ``filter_bits`` overrides the
    filter's width (the control).  Returns position and distance (-1
    where unmapped), ``ops`` and ``n_ops``.
    """
    fb = p["filter_bits"] if filter_bits is None else filter_bits
    fk, p_cap = p["filter_k"], p["p_cap"]
    geo = genasm.Geometry(p["w"], p["o"], p["k"])
    b = reads.shape[0]
    ref_len = ref.shape[0]
    lens = lens.to(torch.int64)
    starts, votes = index.seed_candidates(
        reads, idx, w=p["minimizer_w"], k=p["minimizer_k"],
        max_candidates=p["max_candidates"])
    n_cand = starts.shape[1]
    margin = fk + 32
    region_len = fb + 2 * margin
    bit_idx = torch.arange(fb, device=reads.device)
    fpat = torch.where(bit_idx < lens.clamp(max=fb).unsqueeze(1),
                       reads[:, :fb], WILDCARD).to(torch.int8)
    s0 = (starts - margin).clamp(0, max(ref_len - 1, 0))
    region = ref_window(ref, s0, region_len).reshape(b * n_cand, region_len)
    dists = genasm.bitap_search(region, fpat.repeat_interleave(n_cand, dim=0),
                                m_bits=fb, k=fk).reshape(b, n_cand, -1)
    fd = torch.where(votes > 0, dists.min(-1).values, fk + 1)
    fpos = torch.where(votes > 0, s0 + dists.argmin(-1), POS_SENTINEL)
    best = lex_best(fd, fpos).unsqueeze(1)
    pos = torch.gather(fpos, 1, best).squeeze(1)
    best_d = torch.gather(fd, 1, best).squeeze(1)

    t_cap = p_cap + 2 * geo.w
    text = ref_window(ref, pos.clamp(max=ref_len), t_cap).to(torch.int8)
    r = reads[:, :p_cap]
    if r.shape[1] < p_cap:
        r = torch.nn.functional.pad(r, (0, p_cap - r.shape[1]), value=WILDCARD)
    pat = torch.where(torch.arange(p_cap, device=reads.device) < lens.unsqueeze(1),
                      r, WILDCARD).to(torch.int8)
    dist, ops, n_ops, a_failed = genasm.align(
        text, pat, lens, (ref_len - pos).clamp(0, t_cap), geo=geo, p_cap=p_cap)
    failed = a_failed | (best_d > fk)
    return {"position": torch.where(failed, -1, pos).to(torch.int32),
            "distance": torch.where(failed, -1, dist).to(torch.int32),
            "ops": ops, "n_ops": n_ops}
