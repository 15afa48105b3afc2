"""Port parity: direct SeGraM mapping and its full-store BitAlign.

`repro_torch.core.segram.bitalign` (`bitalign_dc` with the (R, M, I, D)
store, `bitalign_tb`, `bitalign`) and `repro_torch.core.segram.segram`
against `repro.core.segram` on the same seeded graphs, windows and
reads.  The reference runs one subgraph per call under ``vmap``; the
port batches them over lanes.  Every comparison is exact: words as
uint32 bit patterns.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.segram import bitalign as jba
from repro.core.segram import graph as jgraph
from repro.core.segram import segram as jseg
from repro.genomics import encode as jenc
from repro.genomics import simulate as jsim
from repro_torch.core.segram import bitalign as tba
from repro_torch.core.segram import graph as tgraph
from repro_torch.core.segram import segram as tseg


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def graph():
    ref = jsim.random_reference(600, seed=31)
    variants = jsim.simulate_variants(ref, n_snp=12, n_ins=6, n_del=6, seed=32)
    return jgraph.build_graph(ref, variants)


def windows(g, seed, b, n, m_bits):
    """Subgraph windows at random starts and patterns spelled from graph
    paths with a few substitutions; real lengths below ``m_bits`` too."""
    rng = np.random.default_rng(seed)
    bases = np.full((b, n), 4, np.int8)
    succ = np.zeros((b, n), np.uint32)
    pats = np.full((b, m_bits), 4, np.int8)
    p_lens = rng.integers(m_bits // 2, m_bits + 1, size=b).astype(np.int32)
    for i in range(b):
        start = int(rng.integers(0, g.n_nodes - n))
        bases[i], succ[i] = jgraph.extract_subgraph(g, start, n)
        p = jsim.spell_graph_path(g, start + int(rng.integers(0, 8)),
                                  int(p_lens[i]), rng)
        p[rng.integers(0, len(p), size=2)] = rng.integers(0, 4, size=2)
        pats[i, :len(p)] = p
        p_lens[i] = len(p)
    return bases, succ, pats, p_lens


def port_args(bases, succ, pats, p_lens):
    return (torch.from_numpy(bases), torch.from_numpy(succ.view(np.int32)),
            torch.from_numpy(pats), torch.from_numpy(p_lens))


@pytest.mark.parametrize("m_bits,k", [(64, 10), (128, 16), (32, 0)])
def test_bitalign_dc_full_store(graph, m_bits, k):
    bases, succ, pats, p_lens = windows(graph, m_bits + k, 5, 96, m_bits)
    f = jax.vmap(partial(jba.bitalign_dc, m_bits=m_bits, k=k))
    d_ref, s_ref = f(*(jnp.asarray(x) for x in (bases, succ, pats, p_lens)))
    d, s = tba.bitalign_dc(*port_args(bases, succ, pats, p_lens),
                           m_bits=m_bits, k=k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(u32(s), np.asarray(s_ref))


def test_bitalign_tb(graph):
    m_bits, k, b = 64, 10, 6
    bases, succ, pats, p_lens = windows(graph, 3, b, 96, m_bits)
    jargs = [jnp.asarray(x) for x in (bases, succ, pats, p_lens)]
    d_ref, s_ref = jax.vmap(partial(jba.bitalign_dc, m_bits=m_bits, k=k))(*jargs)
    start = np.asarray(jnp.argmin(d_ref, axis=-1)).astype(np.int32)
    start[0] = 40  # a start whose walk may get stuck
    d_start = np.minimum(np.asarray(d_ref)[np.arange(b), start], k).astype(np.int32)
    ref = jax.vmap(partial(jba.bitalign_tb, m_bits=m_bits, k=k))(
        s_ref, jargs[1], jnp.asarray(start), jnp.asarray(d_start), jargs[3])
    _, store = tba.bitalign_dc(*port_args(bases, succ, pats, p_lens),
                               m_bits=m_bits, k=k)
    got = tba.bitalign_tb(store, torch.from_numpy(succ.view(np.int32)),
                          torch.from_numpy(start), torch.from_numpy(d_start),
                          torch.from_numpy(p_lens), m_bits=m_bits, k=k)
    for g, r in zip(got, ref):  # ops, n_ops, nodes, stuck
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not got[3][1:].all()  # some walks finish


def test_bitalign(graph):
    m_bits, k = 128, 16
    bases, succ, pats, p_lens = windows(graph, 4, 4, 160, m_bits)
    ref = jax.vmap(partial(jba.bitalign, m_bits=m_bits, k=k))(
        *(jnp.asarray(x) for x in (bases, succ, pats, p_lens)))
    got = tba.bitalign(*port_args(bases, succ, pats, p_lens), m_bits=m_bits, k=k)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert not got["failed"].all()


SEGRAM_KW = dict(m_bits=128, k=16, win_len=192, minimizer_w=8, minimizer_k=12)


@pytest.fixture(scope="module")
def segram_case():
    ref = jsim.random_reference(3000, seed=42)
    variants = jsim.simulate_variants(ref, n_snp=10, n_ins=4, n_del=4, seed=7)
    g = jgraph.build_graph(ref, variants)
    rs = jsim.simulate_reads(ref, n_reads=8, read_len=100,
                             profile=jsim.ILLUMINA, seed=8)
    reads, lens = jenc.batch_reads(rs.reads, 128)
    jidx = jseg.preprocess(ref, g, w=8, k=12)
    want = jseg.map_batch(jidx, jnp.asarray(reads), jnp.asarray(lens),
                          **SEGRAM_KW)
    return ref, variants, jidx, reads, lens, {k: np.asarray(v)
                                               for k, v in want.items()}


def check_mapping(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert (~got["failed"]).sum() >= 6  # most reads map


def test_segram_map_batch_preprocess(segram_case):
    ref, variants, _, reads, lens, want = segram_case
    g = tgraph.build_graph(ref, [tgraph.Variant(*v) for v in variants])
    idx = tseg.preprocess(ref, g, w=8, k=12, device="cpu")
    got = tseg.map_batch(idx, torch.from_numpy(reads), torch.from_numpy(lens),
                         **SEGRAM_KW)
    check_mapping(got, want)


def test_segram_map_batch_index_from_arrays(segram_case):
    _, _, jidx, reads, lens, want = segram_case
    idx = tseg.index_from_arrays(*(np.asarray(x) for x in jidx), device="cpu")
    got = tseg.map_batch(idx, torch.from_numpy(reads), torch.from_numpy(lens),
                         **SEGRAM_KW)
    check_mapping(got, want)
    one = tseg.map_read(idx, torch.from_numpy(reads[2]), int(lens[2]),
                        **SEGRAM_KW)
    for key in want:
        np.testing.assert_array_equal(one[key].numpy(), want[key][2], err_msg=key)


def test_preprocess_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device cuda is valid")
    ref = jsim.random_reference(500, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseg.preprocess(ref, tgraph.build_graph(ref, []), w=8, k=12)
