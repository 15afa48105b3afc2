"""Port parity: `repro_torch.align.inputs` against `repro.align.inputs`.

Every generator with the same seeds gives the reference's arrays, dtype
and value, so the port's tests and tools feed the reference's inputs.
"""
import numpy as np
import pytest

from repro.align import inputs as jin
from repro.genomics import simulate as jsim
from repro_torch.align import inputs as tin
from repro_torch.genomics import simulate as tsim


def assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch,w,seed,n_chars", [(8, 64, 13, 4), (3, 32, 1, 5)])
def test_random_windows(batch, w, seed, n_chars):
    assert_same(tin.random_windows(batch, w, seed=seed, n_chars=n_chars),
                jin.random_windows(batch, w, seed=seed, n_chars=n_chars))


@pytest.mark.parametrize("n_sub,n_ins,n_del", [(0, 0, 0), (3, 1, 2), (0, 4, 0)])
def test_mutate_and_mutated_pair(n_sub, n_ins, n_del):
    seq = np.random.default_rng(2).integers(0, 4, 50).astype(np.int8)
    assert_same(tin.mutate(seq, n_sub, n_ins, n_del, np.random.default_rng(3)),
                jin.mutate(seq, n_sub, n_ins, n_del, np.random.default_rng(3)))
    kw = dict(n_sub=n_sub, n_ins=n_ins, n_del=n_del, t_extra=16)
    assert_same(tin.mutated_pair(np.random.default_rng(4), 40, **kw),
                jin.mutated_pair(np.random.default_rng(4), 40, **kw))


def test_padded_batch():
    rng = np.random.default_rng(5)
    pairs = [jin.mutated_pair(rng, m, n_sub=1) for m in (10, 30, 70)]
    assert_same(tin.padded_batch(pairs, 64, 96), jin.padded_batch(pairs, 64, 96))


@pytest.mark.parametrize("kw", [dict(), dict(p_cap=160, n_sub=4, seed=3)])
def test_aligned_read_batch(kw):
    assert_same(tin.aligned_read_batch(6, 100, **kw),
                jin.aligned_read_batch(6, 100, **kw))


def test_variant_graph():
    g, ref = tin.variant_graph(300, seed=9, n_snp=4, n_ins=2, n_del=2)
    jg, jref = jin.variant_graph(300, seed=9, n_snp=4, n_ins=2, n_del=2)
    assert_same(ref, jref)
    for name in ("bases", "succ_bits"):
        assert_same(getattr(g, name), getattr(jg, name))
    assert g.n_nodes == jg.n_nodes


@pytest.mark.parametrize("variant_seed", [None, 21])
def test_graph_read_batch(variant_seed):
    kw = dict(k_read=8, seed=17, variant_seed=variant_seed)
    assert_same(tin.graph_read_batch(4, 256, 64, **kw),
                jin.graph_read_batch(4, 256, 64, **kw))


def test_profile_read_patterns():
    ref = np.random.default_rng(7).integers(0, 4, 2000).astype(np.int8)
    assert_same(tin.profile_read_patterns(ref, 5, 100, 128,
                                          profile=tsim.ILLUMINA, seed=8),
                jin.profile_read_patterns(ref, 5, 100, 128,
                                          profile=jsim.ILLUMINA, seed=8))


def test_every_generator_is_ported():
    public = {n for n in dir(jin) if callable(getattr(jin, n))
              and not n.startswith("_") and getattr(jin, n).__module__ == jin.__name__}
    assert public and public <= set(dir(tin))
