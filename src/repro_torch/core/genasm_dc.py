"""GenASM-DC: the paper's modified Bitap distance calculation (Algorithm 1).

Batched port of `repro.core.genasm_dc`: every function takes a leading
lane axis (the reference's ``vmap`` written out) and runs its text scan
as a Python loop over ``[B]``-lane tensors (the reference's
``lax.scan``).

  * :func:`window_dc` / :func:`window_dc_r` — one divide-and-conquer
    window per lane, emitting the M/I/D traceback store or the R-only
    store.  They back the ``torch`` align backend and are the plain
    versions of the two CUDA kernels in `repro_torch.kernels`.
  * :func:`bitap_search` — full-length multi-word Bitap over a text
    region per lane (the pre-alignment filter).
"""
from __future__ import annotations

import torch

from .bitvector import n_words, ones, pattern_bitmasks, shl1
# a name the reference module binds too
from .bitvector import msb  # noqa: F401

# TB-store layout along axis -2: match, insertion, deletion.  The
# substitution vector is derived as shl1(deletion) (paper §4.6).
TB_MATCH, TB_INS, TB_DEL = 0, 1, 2


def dc_step(R_old: torch.Tensor, cur_pm: torch.Tensor, k: int, *,
            with_store: bool = True):
    """One text-character step of GenASM-DC over every lane.

    ``R_old``: ``[..., k+1, nw]`` status bitvectors from the previous text
    char; ``cur_pm``: ``[..., nw]`` pattern bitmask of the current char.
    Returns ``(R_new [..., k+1, nw], store [..., k+1, 3, nw] or None)``
    where ``store`` holds the intermediate (M, I, D) bitvectors.
    """
    R0 = shl1(R_old[..., 0, :]) | cur_pm
    rows = [R0]
    if k > 0:
        D = R_old[..., :-1, :]  # R_old[d-1] for d = 1..k
        M = shl1(R_old[..., 1:, :]) | cur_pm.unsqueeze(-2)
        DSM = D & shl1(D) & M
        for d in range(k):  # I = shl1(R_new[d-1]) is the only serial term
            rows.append(DSM[..., d, :] & shl1(rows[-1]))
    R_new = torch.stack(rows, dim=-2)
    if not with_store:
        return R_new, None
    bound = ones(R0.shape[:-1] + (1,) + R0.shape[-1:], device=R0.device)
    if k > 0:
        M_all = torch.cat([R0.unsqueeze(-2), M], dim=-2)
        I_all = torch.cat([bound, shl1(R_new[..., :-1, :])], dim=-2)
        D_all = torch.cat([bound, D], dim=-2)
    else:
        M_all, I_all, D_all = R0.unsqueeze(-2), bound, bound
    return R_new, torch.stack([M_all, I_all, D_all], dim=-2)


def first_match_distance(msbs: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., k+1]`` MSBs -> first ``d`` whose MSB is 0, else ``k+1``."""
    found = msbs == 0
    return torch.where(found.any(-1), found.to(torch.int8).argmax(-1),
                       k + 1).to(torch.int32)


def _dc_scan(text: torch.Tensor, pattern: torch.Tensor, n_bits: int, k: int, *,
             with_store: bool):
    """Scan each lane's text ``i = n-1 .. 0`` against its ``n_bits``-bit
    pattern; yields ``(i, R_new, store)`` per step."""
    n_lanes, n = text.shape
    pm = pattern_bitmasks(pattern, n_bits)  # [N, 5, nw]
    txt = text.to(torch.int64)
    lanes = torch.arange(n_lanes, device=text.device)
    R = ones((n_lanes, k + 1, n_words(n_bits)), device=text.device)
    for i in range(n - 1, -1, -1):
        R, store = dc_step(R, pm[lanes, txt[:, i]], k, with_store=with_store)
        yield i, R, store


def window_dc(sub_text: torch.Tensor, sub_pattern: torch.Tensor, *, w: int, k: int):
    """GenASM-DC over one window per lane.

    ``sub_text``/``sub_pattern``: ``[B, w]`` base ids (4 = sentinel /
    wildcard).  Text is scanned ``i = w-1 .. 0``; the window answers at
    ``i = 0`` (candidate-anchored alignment start).

    Returns ``d_min [B] int32`` (``k+1`` when no alignment) and ``tb
    [B, w, k+1, 3, nw] int32`` — the intermediate bitvectors indexed by
    text position ``i``.
    """
    b = sub_text.shape[0]
    tb = torch.empty((b, w, k + 1, 3, n_words(w)), dtype=torch.int32,
                     device=sub_text.device)
    for i, R, store in _dc_scan(sub_text, sub_pattern, w, k, with_store=True):
        tb[:, i] = store
    return first_match_distance((R[..., -1] >> 31) & 1, k), tb


def window_dc_r(sub_text: torch.Tensor, sub_pattern: torch.Tensor, *, w: int, k: int):
    """GenASM-DC storing only the status rows R (all four TB check
    vectors derive from R).

    Returns ``(d_min [B], R_store [B, w+1, k+1, nw])`` — row ``w`` is the
    all-ones boundary (i = w), row ``i`` the status after text char i.
    """
    b = sub_text.shape[0]
    store = ones((b, w + 1, k + 1, n_words(w)), device=sub_text.device)
    for i, R, _ in _dc_scan(sub_text, sub_pattern, w, k, with_store=False):
        store[:, i] = R
    return first_match_distance((R[..., -1] >> 31) & 1, k), store


def bitap_search(text: torch.Tensor, pattern: torch.Tensor, *, m_bits: int, k: int):
    """Full-length multi-word Bitap search of each lane's pattern in its text.

    ``text``: ``[N, n]`` base ids; ``pattern``: ``[N, m_bits]``
    (wildcard-padded).  Returns ``dists [N, n] int32``: for each text
    position ``i`` the minimum ``d <= k`` such that the full pattern
    matches ``text[i:]`` with ``d`` edits (``k+1`` where none).
    """
    n_lanes, n = text.shape
    top = torch.empty((n_lanes, n, k + 1), dtype=torch.int32, device=text.device)
    for i, R, _ in _dc_scan(text, pattern, m_bits, k, with_store=False):
        top[:, i] = R[..., -1]  # MSB word; the distance is taken once below
    return first_match_distance((top >> 31) & 1, k)
