"""Port parity: the DP baselines, `cigar_score` and the numpy oracles.

`repro_torch.core.dp_baseline` (batched over pairs) against the JAX
`repro.core.dp_baseline` run pair by pair, `genasm_tb.cigar_score`
against its JAX counterpart, and the port's copy of the oracles against
`repro.core.oracle` on the same pairs.  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp_baseline as jdp
from repro.core import genasm_tb as jtb
from repro.core import oracle as joracle
from repro.core.segram import graph as jgraph
from repro.genomics import simulate as jsim
from repro_torch.core import dp_baseline as tdp
from repro_torch.core import genasm_tb as ttb
from repro_torch.core import oracle as toracle

M_CAP, N_CAP = 24, 40


def dp_inputs(seed, b=6):
    """Pattern/text buffers whose text is a mutated pattern, with lengths
    covering 0, full buffers and everything between."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 4, size=(b, M_CAP)).astype(np.int8)
    texts = rng.integers(0, 4, size=(b, N_CAP)).astype(np.int8)
    texts[:, :M_CAP] = np.where(rng.random((b, M_CAP)) < 0.8, pats,
                                texts[:, :M_CAP])
    p_lens = rng.integers(1, M_CAP + 1, size=b).astype(np.int32)
    t_lens = rng.integers(1, N_CAP + 1, size=b).astype(np.int32)
    p_lens[:3] = [0, M_CAP, 5]
    t_lens[:3] = [N_CAP, N_CAP, 0]
    return texts, pats, p_lens, t_lens


def port(fn, texts, pats, p_lens, t_lens, **kw):
    return fn(*(torch.from_numpy(x) for x in (texts, pats, p_lens, t_lens)),
              **kw).numpy()


def test_nw_edit_distance():
    texts, pats, p_lens, t_lens = dp_inputs(1)
    want = [int(jdp.nw_edit_distance(jnp.asarray(t), jnp.asarray(p),
                                     jnp.int32(pl), jnp.int32(tl)))
            for t, p, pl, tl in zip(texts, pats, p_lens, t_lens)]
    np.testing.assert_array_equal(
        port(tdp.nw_edit_distance, texts, pats, p_lens, t_lens), want)


@pytest.mark.parametrize("local", [False, True])
def test_affine_align_score(local):
    texts, pats, p_lens, t_lens = dp_inputs(2)
    want = [int(jdp.affine_align_score(jnp.asarray(t), jnp.asarray(p),
                                       jnp.int32(pl), jnp.int32(tl),
                                       local=local))
            for t, p, pl, tl in zip(texts, pats, p_lens, t_lens)]
    np.testing.assert_array_equal(
        port(tdp.affine_align_score, texts, pats, p_lens, t_lens, local=local),
        want)


def test_affine_align_score_custom_penalties():
    texts, pats, p_lens, t_lens = dp_inputs(3)
    kw = dict(match=1, subs=-3, gap_open=-5, gap_extend=-1)
    want = [int(jdp.affine_align_score(jnp.asarray(t), jnp.asarray(p),
                                       jnp.int32(pl), jnp.int32(tl), **kw))
            for t, p, pl, tl in zip(texts, pats, p_lens, t_lens)]
    np.testing.assert_array_equal(
        port(tdp.affine_align_score, texts, pats, p_lens, t_lens, **kw), want)


def test_cigar_score():
    rng = np.random.default_rng(4)
    ops = rng.choice([0, 0, 0, 1, 2, 2, 3, 3], size=(16, 50)).astype(np.int8)
    n_ops = rng.integers(0, 51, size=16).astype(np.int32)
    ops[np.arange(50)[None, :] >= n_ops[:, None]] = -1
    want = np.asarray(jtb.cigar_score(jnp.asarray(ops), jnp.asarray(n_ops)))
    got = ttb.cigar_score(torch.from_numpy(ops), torch.from_numpy(n_ops))
    np.testing.assert_array_equal(got.numpy(), want)


def oracle_pairs(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.integers(0, 4, size=int(rng.integers(0, 30))).astype(np.int8)
        b = jsim.mutate(a, jsim.ErrorProfile("x", 0.15, 0.4, 0.3, 0.3), rng)
        out.append((a, np.concatenate([b, rng.integers(0, 4, 5).astype(np.int8)])))
    return out


def test_oracle_distances_match_reference():
    for a, b in oracle_pairs(5):
        assert toracle.levenshtein(a, b) == joracle.levenshtein(a, b)
        assert toracle.levenshtein_prefix(a, b) == joracle.levenshtein_prefix(a, b)


def test_oracle_check_cigar_matches_reference():
    rng = np.random.default_rng(6)
    for a, b in oracle_pairs(6):
        n_ops = int(rng.integers(0, len(a) + 3))
        ops = rng.integers(0, 5, size=n_ops).astype(np.int8)
        d = int(rng.integers(0, 4))
        assert toracle.check_cigar(ops, n_ops, a, b, d) == \
            joracle.check_cigar(ops, n_ops, a, b, d)
    # a valid CIGAR: all matches against the pattern itself
    a = np.arange(8, dtype=np.int8) % 4
    ops = np.zeros(8, np.int8)
    assert toracle.check_cigar(ops, 8, a, a, 0) is None
    assert joracle.check_cigar(ops, 8, a, a, 0) is None


def test_oracle_graph_distances_match_reference():
    rng = np.random.default_rng(7)
    ref = jsim.random_reference(60, seed=8)
    g = jgraph.build_graph(ref, jsim.simulate_variants(ref, n_snp=3, n_ins=2,
                                                       n_del=2, seed=9))
    preds = jgraph.predecessors(g)
    for _ in range(3):
        start = int(rng.integers(0, 30))
        pat = g.bases[start:start + int(rng.integers(5, 20))].copy()
        pat[rng.integers(0, len(pat))] = rng.integers(0, 4)
        assert toracle.graph_edit_distance(pat, g.bases, preds) == \
            joracle.graph_edit_distance(pat, g.bases, preds)
        assert toracle.graph_edit_distance_anchored(pat, g.bases, preds, start) == \
            joracle.graph_edit_distance_anchored(pat, g.bases, preds, start)
