"""`"ref"` backend: exact host-side DP with traceback (oracle-backed).

Same anchored semi-global semantics as the GenASM aligner (alignment
starts at ``text[0]``, the pattern must be fully consumed, trailing text
is free), computed by the obviously-correct O(nm) DP that
the reference's `core/oracle.levenshtein_prefix` scores — extended here
with a traceback so it emits the packed M/X/I/D CIGAR the rest of the
stack consumes.  Copied from `repro.align.refdp`.

Runs on the host in numpy (the backend adapter moves its results to the
caller's device), so the serve engine can select it like any other
while it stays off the accelerator: it is ground truth for tests and an
end-of-the-line debugging fallback, never a production path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bitvector import WILDCARD
from repro_torch.core.genasm_tb import OP_D, OP_I, OP_M, OP_PAD, OP_X


def _matches(p: int, c: int) -> bool:
    # wildcard pattern char matches everything (incl. text sentinels)
    return p == c or p == WILDCARD


def align_one(pattern: np.ndarray, text: np.ndarray, cap: int):
    """Exact semi-global alignment of one pair.

    Returns ``(distance, ops [cap] int8, n_ops, text_consumed)``.
    ``n_ops`` is the true op count even when ``cap`` truncates the
    stored buffer (the distances-only dispatch path uses ``cap=1`` but
    still reports the count, matching the windowed backends).
    """
    m, n = len(pattern), len(text)
    D = np.empty((m + 1, n + 1), np.int32)
    # anchored at text[0]: text consumed before the pattern starts costs
    # (row 0 = deletions); trailing text is free (min over the last row)
    D[0, :] = np.arange(n + 1)
    D[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        pc = pattern[i - 1]
        for j in range(1, n + 1):
            cost = 0 if _matches(pc, text[j - 1]) else 1
            D[i, j] = min(D[i - 1, j] + 1,      # I: consume pattern
                          D[i, j - 1] + 1,      # D: consume text
                          D[i - 1, j - 1] + cost)
    j_end = int(np.argmin(D[m, :]))
    dist = int(D[m, j_end])

    ops_rev = []
    i, j = m, j_end
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            cost = 0 if _matches(pattern[i - 1], text[j - 1]) else 1
            if D[i, j] == D[i - 1, j - 1] + cost:
                ops_rev.append(OP_M if cost == 0 else OP_X)
                i -= 1
                j -= 1
                continue
        if i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops_rev.append(OP_I)
            i -= 1
            continue
        ops_rev.append(OP_D)
        j -= 1

    ops = np.full((cap,), OP_PAD, np.int8)
    n_store = min(len(ops_rev), cap)
    ops[:n_store] = np.asarray(ops_rev[::-1][:n_store], np.int8)
    return dist, ops, len(ops_rev), j_end


def align_batch_host(texts: np.ndarray, patterns: np.ndarray,
                     p_lens: np.ndarray, t_lens: np.ndarray, cap: int):
    """Vectorized-over-rows host DP; the pure_callback body."""
    b = len(p_lens)
    dist = np.full((b,), 0, np.int32)
    ops = np.full((b, cap), OP_PAD, np.int8)
    n_ops = np.zeros((b,), np.int32)
    t_used = np.zeros((b,), np.int32)
    for i in range(b):
        pl_, tl = int(p_lens[i]), int(t_lens[i])
        d, o, n, tc = align_one(np.asarray(patterns[i][:pl_]),
                                np.asarray(texts[i][:tl]), cap)
        dist[i], ops[i], n_ops[i], t_used[i] = d, o, n, tc
    failed = np.zeros((b,), bool)  # the oracle always finds an alignment
    return dist, ops, n_ops, t_used, failed
