"""Port parity: use case 3, edit distance between two sequences.

`repro_torch.core.edit_distance` against `repro.core.edit_distance` on
the same seeded pairs, made as `benchmarks/edit_distance.py` makes them
(a random sequence and a mutated copy in fixed buffers).  Every
comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edit_distance as jed
from repro.core.genasm import GenASMConfig as JConfig
from repro.genomics import simulate as jsim
from repro_torch.core import edit_distance as ted
from repro_torch.core.genasm import GenASMConfig

CFG = dict(w=64, o=24, k=24)


def benchmark_pairs(length, similarity, batch, seed):
    """``(a, b, a_lens, b_lens)``: a pattern buffer ``[batch, length+64]``
    and a text buffer 128 wider, as the edit-distance benchmark pads."""
    rng = np.random.default_rng(seed)
    prof = jsim.ErrorProfile("x", 1 - similarity, 0.4, 0.3, 0.3)
    p_cap = length + 64
    a = np.full((batch, p_cap), 4, np.int8)
    b = np.full((batch, p_cap + 128), 4, np.int8)
    a_lens = np.zeros(batch, np.int32)
    b_lens = np.zeros(batch, np.int32)
    for i in range(batch):
        s = rng.integers(0, 4, size=length).astype(np.int8)
        t = jsim.mutate(s, prof, rng)
        a[i, :len(s)] = s
        b[i, :len(t)] = t[:b.shape[1]]
        a_lens[i], b_lens[i] = len(s), min(len(t), b.shape[1])
    return a, b, a_lens, b_lens


@pytest.mark.parametrize("backend", ["torch", "cuda_dc"])
@pytest.mark.parametrize("similarity", [0.95, 0.80])
def test_genasm_distance_batch(similarity, backend, monkeypatch):
    """The CPU default (``torch``) and, through the backend variable, the
    GenASM-DC kernel's window loop with its plain version."""
    monkeypatch.setenv("REPRO_ALIGN_BACKEND", backend)
    a, b, al, bl = benchmark_pairs(150, similarity, 4, seed=7)
    want = np.asarray(jed.genasm_distance_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(al), jnp.asarray(bl),
        cfg=JConfig(**CFG)))
    got = ted.genasm_distance_batch(
        *(torch.from_numpy(x) for x in (a, b, al, bl)), cfg=GenASMConfig(**CFG))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_myers_distance_batch(mode):
    a, b, al, _ = benchmark_pairs(200, 0.9, 4, seed=8)
    m_bits = 256
    pats = a[:, :m_bits]
    want = np.asarray(jed.myers_distance_batch(
        jnp.asarray(b), jnp.asarray(pats), jnp.asarray(al), m_bits=m_bits,
        mode=mode))
    got = ted.myers_distance_batch(torch.from_numpy(b), torch.from_numpy(pats),
                                   torch.from_numpy(al), m_bits=m_bits, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitap_distance():
    a, b, al, _ = benchmark_pairs(56, 0.9, 5, seed=9)
    m_bits, k = 64, 12
    pats = np.where(np.arange(m_bits) < al[:, None], a[:, :m_bits], 4)
    pats = pats.astype(np.int8)
    want = [int(jed.bitap_distance(jnp.asarray(p), jnp.asarray(t),
                                   m_bits=m_bits, k=k))
            for p, t in zip(pats, b)]
    got = ted.bitap_distance(torch.from_numpy(pats), torch.from_numpy(b),
                             m_bits=m_bits, k=k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_windowed_distance_within_the_demo_band_of_myers():
    """`examples/edit_distance_demo.py`'s band: ``dm <= d <= dm + max(5,
    dm // 20)`` for every pair the windowed path maps."""
    a, b, al, bl = benchmark_pairs(300, 0.9, 4, seed=10)
    d = ted.genasm_distance_batch(*(torch.from_numpy(x) for x in (a, b, al, bl)),
                                  cfg=GenASMConfig(**CFG)).numpy()
    m_bits = 320
    dm = ted.myers_distance_batch(torch.from_numpy(b),
                                  torch.from_numpy(a[:, :m_bits]),
                                  torch.from_numpy(al), m_bits=m_bits,
                                  mode="semiglobal").numpy()
    ok = d >= 0
    assert ok.any()
    assert ((dm[ok] <= d[ok]) & (d[ok] <= dm[ok] + np.maximum(5, dm[ok] // 20))).all()
