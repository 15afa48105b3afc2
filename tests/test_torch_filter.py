"""Port parity: use case 2, the exact pre-alignment filter.

`repro_torch.core.filter.filter_candidates` and the ``prepare_*``
helpers against `repro.core.filter` on the pairs
`benchmarks/prealign_filter.py` makes (similar and dissimilar pairs,
sentinel-padded regions, wildcard-padded reads), at smaller batches.
Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filter as jfilter
from repro.genomics import simulate as jsim
from repro_torch.core import filter as tfilter


def filter_pairs(read_len, k, batch, seed):
    """``(texts [batch, n], reads [batch, m_bits], m_bits)``: even lanes a
    read and its mutated copy, odd lanes unrelated sequences."""
    rng = np.random.default_rng(seed)
    m_bits = 128 if read_len <= 100 else 256
    n = m_bits + 2 * k + 16
    texts, reads = [], []
    for i in range(batch):
        r = rng.integers(0, 4, size=read_len).astype(np.int8)
        if i % 2 == 0:
            t = jsim.mutate(r, jsim.ErrorProfile("x", k / read_len / 2, .5, .25,
                                                 .25), rng)
        else:
            t = rng.integers(0, 4, size=read_len + 2 * k).astype(np.int8)
        texts.append(jfilter.prepare_region(t[:n], n))
        reads.append(jfilter.prepare_read(r, m_bits))
    return np.stack(texts), np.stack(reads), m_bits


@pytest.mark.parametrize("read_len,k", [(100, 5), (250, 15)])
def test_filter_candidates(read_len, k):
    texts, reads, m_bits = filter_pairs(read_len, k, 8, seed=read_len)
    acc_j, dist_j = jfilter.filter_candidates(jnp.asarray(texts),
                                              jnp.asarray(reads), None,
                                              m_bits=m_bits, k=k)
    acc, dist = tfilter.filter_candidates(torch.from_numpy(texts),
                                          torch.from_numpy(reads), None,
                                          m_bits=m_bits, k=k)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(dist_j))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert acc.numpy()[::2].any() and not acc.numpy()[1::2].any()


def test_prepare_helpers():
    rng = np.random.default_rng(3)
    for ln in (0, 1, 57, 128):
        seq = rng.integers(0, 4, size=ln).astype(np.int8)
        np.testing.assert_array_equal(tfilter.prepare_read(seq, 128),
                                      jfilter.prepare_read(seq, 128))
        np.testing.assert_array_equal(tfilter.prepare_region(seq, 150),
                                      jfilter.prepare_region(seq, 150))
