"""Port parity: windowed BitAlign, the BitAlign kernel's plain version and
the two graph alignment backends against the JAX reference.

Subgraph windows are cut from seeded variation graphs (and hop-0
chains); the same numpy arrays go through `repro.graph.windowed`,
`repro.kernels.bitalign` (the Pallas kernel in interpret mode) and the
``graph_lax`` backend on one side, and through `repro_torch` on the
other.  Every comparison is exact: words are compared as uint32 bit
patterns.  The CUDA kernel itself runs only on a GPU:
tests/test_torch_kernels_cuda.py holds it against the plain version.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import align as jalign
from repro.core import bitvector as jbv
from repro.core.genasm import GenASMConfig as JConfig
from repro.core.segram import graph as jgraph
from repro.genomics import simulate as jsim
from repro.graph import windowed as jwin
from repro.kernels.bitalign import bitalign_dc_batch as j_bitalign
from repro_torch import align as talign
from repro_torch.core.genasm import GenASMConfig
from repro_torch.graph import windowed as twin
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bitalign import bitalign_dc_batch

W, O, K = 64, 24, 24
P_CAP, T_CAP = 128, 256
RESULT_FIELDS = ("distance", "ops", "n_ops", "text_consumed", "failed",
                 "nodes")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(x) -> torch.Tensor:
    """A reference uint32 array as the port's int32 bit patterns."""
    return torch.from_numpy(np.asarray(x).astype(np.uint32).view(np.int32))


@pytest.fixture(scope="module")
def graph():
    ref = jsim.random_reference(600, seed=21)
    variants = jsim.simulate_variants(ref, n_snp=10, n_ins=5, n_del=5, seed=22)
    return jgraph.build_graph(ref, variants)


def graph_windows(g, seed, b, n, *, chain=False):
    """``[b, n]`` subgraph windows at random starts (or hop-0 chains)."""
    rng = np.random.default_rng(seed)
    bases = np.full((b, n), 4, np.int8)
    succ = np.zeros((b, n), np.uint32)
    for i in range(b):
        start = int(rng.integers(0, g.n_nodes - n // 2))
        bases[i], succ[i] = jgraph.extract_subgraph(g, start, n)
    if chain:
        succ[:] = 1
    return bases, succ, rng


def spelled_patterns(g, rng, b, m, *, p_lens=None):
    pats = np.full((b, m), 4, np.int8)
    for i in range(b):
        ln = m if p_lens is None else int(p_lens[i])
        p = jsim.spell_graph_path(g, int(rng.integers(0, g.n_nodes - 2 * m)),
                                  ln, rng)
        p[rng.integers(0, len(p), size=3)] = rng.integers(0, 4, size=3)
        pats[i, :len(p)] = p
    return pats


@pytest.mark.parametrize("chain", [False, True])
def test_window_dc_graph(graph, chain):
    bases, succ, rng = graph_windows(graph, 1, 6, W, chain=chain)
    pats = spelled_patterns(graph, rng, 6, W)
    f = jax.vmap(partial(jwin.window_dc_graph, w=W, k=K))
    d_ref, s_ref = f(jnp.asarray(bases), jnp.asarray(succ), jnp.asarray(pats))
    d, s = twin.window_dc_graph(torch.from_numpy(bases), i32(succ),
                                torch.from_numpy(pats), w=W, k=K)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(u32(s), np.asarray(s_ref))


@pytest.mark.parametrize("m_bits,k", [(64, 24), (128, 11)])
def test_bitalign_search(graph, m_bits, k):
    bases, succ, rng = graph_windows(graph, 2, 5, 160)
    p_lens = rng.integers(m_bits // 2, m_bits + 1, size=5).astype(np.int32)
    pats = spelled_patterns(graph, rng, 5, m_bits, p_lens=p_lens)
    f = jax.vmap(partial(jwin.bitalign_search, m_bits=m_bits, k=k))
    ref = f(jnp.asarray(bases), jnp.asarray(succ), jnp.asarray(pats),
            jnp.asarray(p_lens))
    got = twin.bitalign_search(torch.from_numpy(bases), i32(succ),
                               torch.from_numpy(pats),
                               torch.from_numpy(p_lens), m_bits=m_bits, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() <= k).any()  # some anchors match


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("chain", [False, True])
def test_window_tb_graph(graph, affine, chain):
    b = 8
    bases, succ, rng = graph_windows(graph, 3, b, W, chain=chain)
    pats = spelled_patterns(graph, rng, b, W)
    cap_p = rng.integers(1, W - O + 1, size=b).astype(np.int32)
    jb, js, jp = jnp.asarray(bases), jnp.asarray(succ), jnp.asarray(pats)
    d, store = jax.vmap(partial(jwin.window_dc_graph, w=W, k=K))(jb, js, jp)
    pm = jax.vmap(lambda p: jbv.pattern_bitmasks(p, W))(jp)
    d_start = jnp.minimum(d, K)
    ref = jax.vmap(partial(jwin.window_tb_graph, w=W, o=O, k=K,
                           affine=affine))(store, js, jb, pm, d_start,
                                           jnp.asarray(cap_p))
    got = twin.window_tb_graph(
        i32(store), i32(succ), torch.from_numpy(bases), i32(pm),
        torch.from_numpy(np.asarray(d_start)), torch.from_numpy(cap_p),
        w=W, o=O, k=K, affine=affine)
    for g_, r_ in zip(got, ref):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))


JAX_BLOCK = 8


def jax_kernel(bases, succ, pats, p_lens, m_bits, k):
    """The Pallas kernel in interpret mode, batch padded to its block."""
    pad = (-bases.shape[0]) % JAX_BLOCK

    def padded(x, fill):
        return jnp.asarray(np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]))

    d, r = j_bitalign(padded(bases, 4), padded(succ, 0), padded(pats, 4),
                      padded(p_lens, m_bits), m_bits=m_bits, k=k,
                      block_bt=JAX_BLOCK, interpret=True)
    b = bases.shape[0]
    return np.asarray(d)[:b], np.asarray(r)[:b]


@pytest.mark.parametrize("store_r", [True, False])
@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("m_bits,k", [(64, 24), (128, 11)])
def test_bitalign_dc_batch_plain_matches_pallas(m_bits, k, b, store_r):
    """Random hopBits (hops past N included) and p_lens < m_bits; the
    wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(m_bits + k + b)
    (bases, succ, pats, p_lens), kw = tops.bitalign_inputs(
        rng, "cpu", b=b, n=64, m_bits=m_bits, k=k, store_r=store_r,
        short=True, hop_rate=0.1)
    assert (p_lens.numpy() < m_bits).all()
    assert (succ.numpy()[:, -8:] >> 1).any()  # hops that land past N
    d_ref, r_ref = jax_kernel(bases.numpy(), u32(succ), pats.numpy(),
                              p_lens.numpy(), m_bits, k)
    for fn in (tops.KERNELS[2].plain, bitalign_dc_batch):
        d, r = fn(bases, succ, pats, p_lens, **kw)
        np.testing.assert_array_equal(d.numpy(), d_ref)
        if store_r:
            np.testing.assert_array_equal(u32(r), r_ref)
        else:
            assert r is None
    assert bitalign_dc_batch.launches == 0  # CPU tensors launch nothing


def graph_batch(g, seed, n_pairs=6):
    """Spelled-path patterns with injected edits, packed graph windows."""
    bases, succ, rng = graph_windows(g, seed, n_pairs, T_CAP)
    pats = np.full((n_pairs, P_CAP), 4, np.int8)
    p_lens = np.zeros(n_pairs, np.int32)
    for i in range(n_pairs):
        start = int(rng.integers(0, T_CAP // 4))
        # spell along this window's own edges from node `start`
        cur, seq = start, []
        m = int(rng.integers(40, 110))
        while len(seq) < m and cur < T_CAP:
            seq.append(int(bases[i, cur]))
            bits = int(succ[i, cur])
            if not bits:
                break
            hops = [h for h in range(16) if (bits >> h) & 1]
            cur += 1 + int(rng.choice(hops))
        p = np.array(seq, np.int8)
        for _ in range(i % 4):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 4))
        if i % 3 == 1:
            p = np.delete(p, int(rng.integers(1, len(p) - 1)))
        if i % 3 == 2:
            p = np.insert(p, int(rng.integers(1, len(p) - 1)),
                          int(rng.integers(0, 4)))
        bases[i, :T_CAP - start] = bases[i, start:].copy()
        succ[i, :T_CAP - start] = succ[i, start:].copy()
        pats[i, :len(p)] = p
        p_lens[i] = len(p)
    t_lens = np.full(n_pairs, T_CAP - T_CAP // 4, np.int32)
    gtext = np.asarray(jwin.pack_graph_text(jnp.asarray(bases),
                                            jnp.asarray(succ)))
    return gtext, pats, p_lens, t_lens


@pytest.fixture(scope="module")
def graph_lax_reference(graph):
    """The reference ``graph_lax`` results, compiled once per input set."""
    out = {}
    for name, (gtext, pats, p_lens, t_lens) in (
            ("graph", graph_batch(graph, 4)),
            ("chain", _chain_batch())):
        res = jalign.align_batch(
            jnp.asarray(gtext), jnp.asarray(pats), jnp.asarray(p_lens),
            jnp.asarray(t_lens), cfg=JConfig(), backend="graph_lax",
            p_cap=P_CAP)
        out[name] = ((gtext, pats, p_lens, t_lens), res)
    return out


def _chain_batch():
    """Plain int8 linear texts (packed as hop-0 chains by both sides)."""
    rng = np.random.default_rng(9)
    texts = rng.integers(0, 4, size=(4, T_CAP)).astype(np.int8)
    pats = np.full((4, P_CAP), 4, np.int8)
    p_lens = rng.integers(30, 100, size=4).astype(np.int32)
    for i in range(4):
        pats[i, :p_lens[i]] = texts[i, :p_lens[i]]
        pats[i, 3] = (pats[i, 3] + 1) % 4
    t_lens = np.full(4, T_CAP, np.int32)
    return texts, pats, p_lens, t_lens


@pytest.mark.parametrize("backend", ["graph_torch", "graph_cuda"])
@pytest.mark.parametrize("inputs", ["graph", "chain"])
def test_graph_backends_match_graph_lax(graph_lax_reference, backend, inputs):
    (gtext, pats, p_lens, t_lens), ref = graph_lax_reference[inputs]
    texts = (i32(gtext) if gtext.dtype == np.uint32
             else torch.from_numpy(gtext))
    got = talign.align_batch(texts, torch.from_numpy(pats),
                             torch.from_numpy(p_lens),
                             torch.from_numpy(t_lens), cfg=GenASMConfig(),
                             backend=backend, p_cap=P_CAP)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert not got.failed.numpy().all()


def test_pack_unpack_round_trip(graph):
    bases, succ, _ = graph_windows(graph, 5, 4, 96)
    ref = np.asarray(jwin.pack_graph_text(jnp.asarray(bases),
                                          jnp.asarray(succ)))
    got = twin.pack_graph_text(torch.from_numpy(bases), i32(succ))
    np.testing.assert_array_equal(u32(got), ref)
    b2, s2 = twin.unpack_graph_text(got)
    np.testing.assert_array_equal(b2.numpy(), bases)
    np.testing.assert_array_equal(u32(s2), succ)
    lin = twin.pack_linear_text(torch.from_numpy(bases))
    np.testing.assert_array_equal(
        u32(lin), np.asarray(jwin.pack_linear_text(jnp.asarray(bases))))
