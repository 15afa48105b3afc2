"""Port parity: the one-read and one-pair entry points, `batched_graph_align`
and the public kernel wrappers of `repro_torch.kernels.ops`.

The same seeded numpy inputs go through `repro` and `repro_torch` on the
CPU (the Pallas kernels in interpret mode, the port's wrappers on their
plain versions); every comparison is exact, words as uint32 bit patterns.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edit_distance as jed
from repro.core import genasm as jgenasm
from repro.core import mapper as jmapper
from repro.core import minimizer_index as jindex
from repro.core import myers as jmyers
from repro.core.genasm import GenASMConfig as JConfig
from repro.core.segram import graph as jgraph
from repro.genomics import encode, simulate
from repro.graph import backends as jbackends
from repro.graph import windowed as jwin
from repro.kernels import ops as jops
from repro_torch.core import edit_distance as ted
from repro_torch.core import genasm as tgenasm
from repro_torch.core import mapper as tmapper
from repro_torch.core import minimizer_index as tindex
from repro_torch.core import myers as tmyers
from repro_torch.core.genasm import GenASMConfig
from repro_torch.graph import backends as tbackends
from repro_torch.kernels import ops as tops

MAP_KW = dict(p_cap=192, filter_bits=128, filter_k=16, minimizer_w=8,
              minimizer_k=12)
SF_KW = dict(p_cap=192, t_cap=192 + 128, filter_bits=128, filter_k=16,
             max_candidates=4, minimizer_w=8, minimizer_k=12)
ALIGN_FIELDS = ("distance", "ops", "n_ops", "text_consumed", "failed")
P_CAP, T_CAP = 128, 256


def i32(x) -> torch.Tensor:
    """A reference uint32 array as the port's int32 bit patterns."""
    return torch.from_numpy(np.asarray(x).astype(np.uint32).view(np.int32))


def assert_fields_equal(got, want, fields):
    for name in fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def linear():
    """A 4 kbp reference, 12 reads (N inside two), both packages' indexes."""
    ref = simulate.random_reference(4000, seed=11)
    rs = simulate.simulate_reads(ref, n_reads=12, read_len=120,
                                 profile=simulate.ILLUMINA, seed=3)
    reads, lens = encode.batch_reads(rs.reads, 128)
    reads[2, [7, 60, 100]] = 4
    reads[9, 40:45] = 4
    jidx = jindex.build_reference_index(ref, w=8, k=12)
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    return ref, reads, lens, jidx, tidx


@pytest.mark.parametrize("backend", ["torch", "cuda_dc"])
def test_map_read(linear, backend):
    _, reads, lens, jidx, tidx = linear
    batch = tmapper.map_batch(tidx, torch.from_numpy(reads),
                              torch.from_numpy(lens), backend=backend, **MAP_KW)
    for i in (0, 2, 9):
        want = jmapper.map_read(jidx, jnp.asarray(reads[i]), int(lens[i]),
                                backend="lax", **MAP_KW)
        got = tmapper.map_read(tidx, torch.from_numpy(reads[i]),
                               int(lens[i]), backend=backend, **MAP_KW)
        assert_fields_equal(got, want, want._fields)
        for name in got._fields:  # and the batch's row
            assert torch.equal(getattr(got, name), getattr(batch, name)[i])
    assert int(got.position) >= 0


@pytest.mark.parametrize("offset", [0, 1000])
def test_seed_filter_read(linear, offset):
    """The whole reference (offset 0), and a shard's haloed slice with the
    table's entries inside it (global positions)."""
    ref, reads, lens, jidx, tidx = linear
    hi = min(len(ref), offset + 2600)
    pos = np.asarray(jidx.positions)
    keep = (pos >= offset) & (pos < hi) if offset else np.ones_like(pos, bool)
    jfn = jax.jit(partial(jmapper.seed_filter_read, **SF_KW),
                  static_argnums=(2,))
    jbuf = jnp.asarray(ref[offset:hi])
    jh, jp = jnp.asarray(np.asarray(jidx.hashes)[keep]), jnp.asarray(pos[keep])
    tbuf = torch.from_numpy(ref[offset:hi].astype(np.int8))
    th, tp = tidx.hashes[torch.from_numpy(keep)], tidx.positions[
        torch.from_numpy(keep)]
    for i in (1, 2, 9):
        want = jfn(jbuf, offset, len(ref), jh, jp, jnp.asarray(reads[i]),
                   int(lens[i]))
        got = tmapper.seed_filter_read(tbuf, offset, len(ref), th, tp,
                                       torch.from_numpy(reads[i]), int(lens[i]),
                                       **SF_KW)
        assert_fields_equal(got, want, want._fields)


def pairs(seed: int, b: int = 5):
    """Texts, patterns copied from them with edits, lengths."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, 4, size=(b, T_CAP)).astype(np.int8)
    pats = np.full((b, P_CAP), 4, np.int8)
    p_lens = rng.integers(20, P_CAP, size=b).astype(np.int32)
    for i in range(b):
        pats[i, :p_lens[i]] = texts[i, :p_lens[i]]
        for j in rng.integers(0, p_lens[i], size=i % 4):
            pats[i, j] = (pats[i, j] + 1) % 4
    t_lens = rng.integers(P_CAP, T_CAP + 1, size=b).astype(np.int32)
    return texts, pats, p_lens, t_lens


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("emit_cigar", [True, False])
def test_align_batch(affine, emit_cigar):
    texts, pats, p_lens, t_lens = pairs(3 + affine)
    want = jgenasm.align_batch(*(jnp.asarray(x) for x in
                                 (texts, pats, p_lens, t_lens)),
                               cfg=JConfig(affine=affine),
                               emit_cigar=emit_cigar)
    got = tgenasm.align_batch(*(torch.from_numpy(x) for x in
                                (texts, pats, p_lens, t_lens)),
                              cfg=GenASMConfig(affine=affine),
                              emit_cigar=emit_cigar)
    assert_fields_equal(got, want, ALIGN_FIELDS)
    assert (got.distance.numpy() >= 0).all()


@pytest.mark.parametrize("p_cap", [None, 448])
def test_genasm_distance(p_cap):
    """Pairs as the edit-distance benchmark makes them (L = 300, 90%)."""
    rng = np.random.default_rng(17)
    prof = simulate.ErrorProfile("x", 0.10, 0.4, 0.3, 0.3)
    for i in range(3):
        s = rng.integers(0, 4, size=300).astype(np.int8)
        t = simulate.mutate(s, prof, rng)
        a = np.full(364, 4, np.int8)
        b = np.full(492, 4, np.int8)
        a[:300], b[:len(t)] = s, t[:492]
        args = (a, b, 300, min(len(t), 492))
        want = jed.genasm_distance(jnp.asarray(a), jnp.asarray(b), *args[2:],
                                   cfg=JConfig(), p_cap=p_cap)
        got = ted.genasm_distance(torch.from_numpy(a), torch.from_numpy(b),
                                  *args[2:], cfg=GenASMConfig(), p_cap=p_cap)
        assert got.shape == () and int(got) == int(want) >= 0


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
@pytest.mark.parametrize("m_bits", [64, 1024])
def test_myers_distance(mode, m_bits):
    """One pair at a time, m_len >= 1, against `repro.core.myers`."""
    rng = np.random.default_rng(m_bits + (mode == "global"))
    n = m_bits + 40
    for m_len in (1, 7, m_bits - 1, m_bits):
        pat = np.full(m_bits, 4, np.int8)
        pat[:m_len] = rng.integers(0, 4, size=m_len)
        text = rng.integers(0, 5, size=n).astype(np.int8)
        keep = min(m_len, n)
        text[:keep] = np.where(rng.random(keep) < 0.85, pat[:keep], text[:keep])
        want = jmyers.myers_distance(jnp.asarray(text), jnp.asarray(pat),
                                     jnp.int32(m_len), m_bits=m_bits, mode=mode)
        got = tmyers.myers_distance(torch.from_numpy(text),
                                    torch.from_numpy(pat), m_len,
                                    m_bits=m_bits, mode=mode)
        assert got.shape == () and got.dtype == torch.int32
        assert int(got) == int(want), (m_len, int(got), int(want))


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_myers_distance_empty_pattern_follows_the_pallas_kernel(mode):
    """At m_len = 0 the reference disagrees with itself: `repro.core.myers`
    reads a wrapped word, the Pallas kernel scores nothing and returns 0.
    The port follows the kernel."""
    rng = np.random.default_rng(2)
    text = rng.integers(0, 4, size=(1, 100)).astype(np.int8)
    pat = np.full((1, 64), 4, np.int8)
    want = np.asarray(jops.myers_distance(
        jnp.asarray(text), jnp.asarray(pat), jnp.zeros(1, jnp.int32),
        m_bits=64, mode=mode))
    got = tmyers.myers_distance(torch.from_numpy(text[0]),
                                torch.from_numpy(pat[0]), 0, m_bits=64,
                                mode=mode)
    assert int(got) == int(want[0]) == 0


def graph_inputs(b: int = 5):
    """``b`` subgraph windows of a seeded variation graph, each with a read
    spelled along a walk from its first node (a few substitutions)."""
    ref = simulate.random_reference(900, seed=21)
    variants = simulate.simulate_variants(ref, n_snp=12, n_ins=6, n_del=6,
                                          seed=22)
    g = jgraph.build_graph(ref, variants)
    rng = np.random.default_rng(23)
    bases = np.full((b, T_CAP), 4, np.int8)
    succ = np.zeros((b, T_CAP), np.uint32)
    pats = np.full((b, P_CAP), 4, np.int8)
    p_lens = np.zeros(b, np.int32)
    for i in range(b):
        start = int(rng.integers(0, g.n_nodes - T_CAP))
        bases[i], succ[i] = jgraph.extract_subgraph(g, start, T_CAP)
        p = simulate.spell_graph_path(g, start, int(rng.integers(40, P_CAP)),
                                      rng)
        p[rng.integers(0, len(p), size=2)] = rng.integers(0, 4, size=2)
        pats[i, :len(p)], p_lens[i] = p, len(p)
    t_lens = np.full(b, T_CAP - 32, np.int32)
    return bases, succ, pats, p_lens, t_lens


@pytest.mark.parametrize("text", ["packed", "int8"])
def test_batched_graph_align(text):
    bases, succ, pats, p_lens, t_lens = graph_inputs()
    if text == "packed":
        jtexts = jwin.pack_graph_text(jnp.asarray(bases), jnp.asarray(succ))
        ttexts = i32(jtexts)
    else:  # plain int8 text, chain-packed by both sides
        jtexts, ttexts = jnp.asarray(bases), torch.from_numpy(bases)
    want = jbackends.batched_graph_align(
        jtexts, jnp.asarray(pats), jnp.asarray(p_lens), jnp.asarray(t_lens),
        cfg=JConfig(), p_cap=P_CAP, interpret=True)
    before = tops.launch_counts()
    got = tbackends.batched_graph_align(
        ttexts, torch.from_numpy(pats), torch.from_numpy(p_lens),
        torch.from_numpy(t_lens), cfg=GenASMConfig(), p_cap=P_CAP)
    assert tops.launch_counts() == before  # CPU tensors never launch
    assert_fields_equal(got, want, ALIGN_FIELDS + ("nodes",))
    assert (got.distance.numpy() >= 0).sum() >= 3


def windows(seed: int, b: int, w: int = 64):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 5, size=(b, w)).astype(np.int8)
    p = t.copy()
    p[rng.random((b, w)) < 0.1] = rng.integers(0, 4)
    return t, p


@pytest.mark.parametrize("squeeze", [False, True])
@pytest.mark.parametrize("name", ["window_dc", "window_dc_v2"])
def test_ops_window_dc(name, squeeze):
    b = 1 if squeeze else 3  # 3: not a multiple of the reference's tile
    t, p = windows(31, b)
    want = getattr(jops, name)(jnp.asarray(t), jnp.asarray(p), w=64, k=12,
                               squeeze=squeeze)
    got = getattr(tops, name)(torch.from_numpy(t), torch.from_numpy(p), w=64,
                              k=12, squeeze=squeeze)
    assert len(got) == 2
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert tuple(g.shape) == w_.shape
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if w_.dtype == np.uint32 else g.numpy(),
            w_)


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_ops_myers_distance(mode):
    rng = np.random.default_rng(41)
    texts = rng.integers(0, 5, size=(3, 150)).astype(np.int8)
    pats = np.full((3, 96), 4, np.int8)
    m_lens = np.array([96, 50, 1], np.int32)
    for i, ln in enumerate(m_lens):
        pats[i, :ln] = texts[i, :ln] % 4
    want = jops.myers_distance(jnp.asarray(texts), jnp.asarray(pats),
                               jnp.asarray(m_lens), m_bits=96, mode=mode)
    got = tops.myers_distance(torch.from_numpy(texts), torch.from_numpy(pats),
                              torch.from_numpy(m_lens), m_bits=96, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_bitalign_dc():
    bases, succ, pats, p_lens, _ = graph_inputs(3)
    n, m_bits = 96, 64
    pats64 = np.where(np.arange(m_bits) < np.minimum(p_lens, m_bits)[:, None],
                      pats[:, :m_bits], 4).astype(np.int8)
    lens64 = np.minimum(p_lens, m_bits).astype(np.int32)
    want = jops.bitalign_dc(jnp.asarray(bases[:, :n]), jnp.asarray(succ[:, :n]),
                            jnp.asarray(pats64), jnp.asarray(lens64),
                            m_bits=m_bits, k=10)
    got = tops.bitalign_dc(torch.from_numpy(bases[:, :n]), i32(succ[:, :n]),
                           torch.from_numpy(pats64), torch.from_numpy(lens64),
                           m_bits=m_bits, k=10)
    assert got[1].shape == (3, n, 11, 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  np.asarray(want[1]))
