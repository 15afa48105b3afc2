"""Host-side numpy oracles for the Bitap/GenASM family (test ground truth).

A copy of `repro.core.oracle` (the port imports nothing of the JAX
package, not even its numpy-only modules).  Small, obviously-correct
dynamic programming implementations, used by the parity tests and by
`chip_smoke.py`'s accuracy checks; never on the hot path.
"""
from __future__ import annotations

import numpy as np


def levenshtein_prefix(pattern: np.ndarray, text: np.ndarray) -> int:
    """min over text prefixes of the edit distance to the full pattern.

    Matches GenASM's anchored semi-global semantics: the alignment starts at
    ``text[0]`` (leading deletions cost) and trailing text is free.
    """
    m, n = len(pattern), len(text)
    prev = np.arange(n + 1)
    best = m  # j = 0 column: all insertions
    for i in range(1, m + 1):
        cur = np.empty(n + 1, np.int64)
        cur[0] = i
        cost = (pattern[i - 1] != text).astype(np.int64)
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost[j - 1])
        prev = cur
        if i == m:
            best = int(prev.min())
    return best


def levenshtein(a: np.ndarray, b: np.ndarray) -> int:
    """Plain (global, NW) unit-cost edit distance."""
    m, n = len(a), len(b)
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, np.int64)
        cur[0] = i
        cost = (a[i - 1] != b).astype(np.int64)
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost[j - 1])
        prev = cur
    return int(prev[n])


def check_cigar(ops: np.ndarray, n_ops: int, pattern: np.ndarray, text: np.ndarray,
                distance: int) -> str | None:
    """Validate a packed CIGAR against the pair.  Returns None or an error string.

    Invariants: M consumes one of each and chars match; X consumes one of
    each and chars differ; I consumes pattern only; D consumes text only;
    the full pattern is consumed; #X + #I + #D == distance.
    """
    pi = ti = edits = 0
    for s in range(int(n_ops)):
        op = int(ops[s])
        if op == 0:  # M
            if pi >= len(pattern) or ti >= len(text):
                return f"M out of range at step {s}"
            if pattern[pi] != text[ti]:
                return f"M mismatch at step {s}: p[{pi}]={pattern[pi]} t[{ti}]={text[ti]}"
            pi += 1
            ti += 1
        elif op == 1:  # X
            if pi >= len(pattern) or ti >= len(text):
                return f"X out of range at step {s}"
            if pattern[pi] == text[ti]:
                return f"X on equal chars at step {s}"
            pi += 1
            ti += 1
            edits += 1
        elif op == 2:  # I
            if pi >= len(pattern):
                return f"I out of range at step {s}"
            pi += 1
            edits += 1
        elif op == 3:  # D
            if ti >= len(text):
                return f"D out of range at step {s}"
            ti += 1
            edits += 1
        else:
            return f"bad op {op} at step {s}"
    if pi != len(pattern):
        return f"pattern not fully consumed: {pi} != {len(pattern)}"
    if edits != distance:
        return f"edit count {edits} != reported distance {distance}"
    return None


def graph_edit_distance_anchored(pattern: np.ndarray, nodes: np.ndarray,
                                 preds: list[list[int]],
                                 start: int = 0) -> int:
    """Anchored semi-global sequence-to-graph distance oracle.

    The first consumed node must be ``start`` (leading skipped graph
    would cost deletions, exactly the linear ``levenshtein_prefix``
    anchor), the pattern is fully consumed, trailing graph is free.
    Ground truth for the windowed graph backends' anchored semantics.
    """
    m = len(pattern)
    n = len(nodes)
    INF = 10 ** 9
    # A[j][i] = min edits: pattern[:j] consumed, node i consumed last,
    # node-consuming ops walking a path that began at `start`
    A = np.full((m + 1, n), INF, np.int64)
    for j in range(m + 1):
        for i in range(n):
            best = INF
            cost = 0 if j > 0 and pattern[j - 1] == nodes[i] else 1
            if i == start:
                best = j + 1  # j leading insertions, then delete `start`
                if j > 0:
                    best = min(best, (j - 1) + cost)  # … then match/subst
            if j > 0 and A[j - 1][i] < INF:
                best = min(best, A[j - 1][i] + 1)  # insertion at i
            for p in preds[i]:
                if j > 0 and A[j - 1][p] < INF:
                    best = min(best, A[j - 1][p] + cost)  # match/subst edge
                if A[j][p] < INF:
                    best = min(best, A[j][p] + 1)  # deletion of node i
            A[j][i] = best
    return int(min(A[m].min(), m))  # all-insertions consumes no node


def graph_edit_distance(pattern: np.ndarray, nodes: np.ndarray,
                        preds: list[list[int]]) -> int:
    """Sequence-to-graph semi-global distance oracle (PaSGAL semantics).

    ``nodes``: one base per linearized node (topological order);
    ``preds[i]``: predecessor node ids of node i.  The alignment may start
    at any node and end anywhere; pattern fully consumed.
    DP over (node, pattern position) with edges following predecessors.
    """
    m = len(pattern)
    n = len(nodes)
    INF = 10 ** 9
    # dist[i][j] = min edits aligning pattern[:j] ending at node i (node i consumed last)
    # We use the standard formulation: D[j][i] over pattern rows.
    D = np.full((m + 1, n), INF, np.int64)
    D[0, :] = 0  # start anywhere with empty pattern (leading text free = start anywhere)
    for j in range(1, m + 1):
        # insertion (consume pattern only): D[j][i] = D[j-1][i] + 1
        D[j, :] = D[j - 1, :] + 1
        # propagate along edges for match/subs/deletion, in topological order
        for i in range(n):
            best = D[j, i]
            cost = 0 if pattern[j - 1] == nodes[i] else 1
            if not preds[i]:
                cand = (0 if j == 1 or True else INF)
                # starting fresh at node i: pattern[:j-1] must be insertions
                best = min(best, (j - 1) + cost)
            for p in preds[i]:
                best = min(best, D[j - 1, p] + cost)  # match/subs over edge
                best = min(best, D[j, p] + 1)  # deletion of node p->i path char
            # Also allow starting at node i even when it has predecessors
            best = min(best, (j - 1) + cost)
            D[j, i] = best
        # deletion sweep needs a second pass for within-rank chains (topological
        # order makes one pass sufficient for DAGs as preds precede i)
    return int(D[m, :].min())
