"""Port parity: Myers' bit-parallel edit distance, the plain version of the
Myers CUDA kernel, against the JAX reference.

The same seeded numpy pairs go through `repro.kernels.ops.myers_distance`
(the Pallas kernel, in interpret mode on the CPU) or
`repro.kernels.ref.myers_distance_batch` (the vmapped `repro.core.myers`)
and through `repro_torch`.  Every comparison is exact.  The CUDA kernel
itself runs only on a GPU: tests/test_torch_kernels_cuda.py holds it
against this plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import myers as tmyers
from repro_torch.kernels import myers as kmyers
from repro_torch.kernels import ops as tops


def pairs(rng, b, n, m_bits, m_lens):
    """ACGT patterns of the given real lengths (wildcard tail) and texts
    over A, C, G, T and the sentinel."""
    texts = rng.integers(0, 5, size=(b, n)).astype(np.int8)
    pats = np.full((b, m_bits), 4, np.int8)
    for i, ln in enumerate(m_lens):
        pats[i, :ln] = rng.integers(0, 4, size=ln)
        keep = min(ln, n)  # a text close to its pattern: small distances
        texts[i, :keep] = np.where(rng.random(keep) < 0.85, pats[i, :keep],
                                   texts[i, :keep])
    return texts, pats, np.asarray(m_lens, np.int32)


def run_port(texts, pats, lens, m_bits, mode):
    return tmyers.myers_distance_batch(
        torch.from_numpy(texts), torch.from_numpy(pats), torch.from_numpy(lens),
        m_bits=m_bits, mode=mode).numpy()


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
@pytest.mark.parametrize("m_bits", [32, 64, 96, 128])
def test_plain_matches_pallas_kernel(m_bits, mode):
    rng = np.random.default_rng(m_bits + (mode == "global"))
    b, n = 13, 90  # ragged: the Pallas wrapper pads 13 lanes to 16
    lens = [0, 1, m_bits - 1, m_bits] + list(rng.integers(0, m_bits + 1, b - 4))
    texts, pats, lens = pairs(rng, b, n, m_bits, lens)
    want = np.asarray(jops.myers_distance(
        jnp.asarray(texts), jnp.asarray(pats), jnp.asarray(lens), m_bits=m_bits,
        mode=mode, block_bt=8))
    got = run_port(texts, pats, lens, m_bits, mode)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0  # m_len = 0: the Pallas kernel's answer


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_plain_matches_core_reference_wide(mode):
    """m_bits = 1,024 (32 words: the benchmark's L = 1,000 width)."""
    rng = np.random.default_rng(5)
    m_bits = 1024
    texts, pats, lens = pairs(rng, 3, 1100, m_bits, [1000, 1024, 700])
    want = np.asarray(jref.myers_distance_batch(
        jnp.asarray(texts), jnp.asarray(pats), jnp.asarray(lens),
        m_bits=m_bits, mode=mode))
    np.testing.assert_array_equal(run_port(texts, pats, lens, m_bits, mode), want)


def test_add_with_carry_matches_big_integers():
    """Long carry chains (all-ones words) and random words, as 32·nw-bit
    integers."""
    rng = np.random.default_rng(3)
    b, nw = 64, 7
    a = rng.integers(0, 2 ** 32, size=(b, nw), dtype=np.uint64)
    c = rng.integers(0, 2 ** 32, size=(b, nw), dtype=np.uint64)
    a[: b // 2, 1:6] = 0xFFFFFFFF  # a propagate run fed by word 0
    c[: b // 4, 1:6] = 0
    got = tmyers.add_with_carry(
        torch.from_numpy(a.astype(np.uint32).view(np.int32)),
        torch.from_numpy(c.astype(np.uint32).view(np.int32)))
    got = got.numpy().view(np.uint32)

    def as_int(words):
        return sum(int(w) << (32 * i) for i, w in enumerate(words))

    for i in range(b):
        want = (as_int(a[i]) + as_int(c[i])) % (1 << (32 * nw))
        assert as_int(got[i]) == want, i


def test_wrapper_runs_plain_on_cpu_without_launching():
    args, kw = tops.myers_inputs(np.random.default_rng(0), "cpu", b=6, n=40,
                                 m_bits=64, short=True)
    before = kmyers.myers_distance_batch.launches
    got = kmyers.myers_distance_batch(*args, **kw)
    assert kmyers.myers_distance_batch.launches == before
    assert torch.equal(got, tmyers.myers_distance_batch(*args, **kw))
    texts, pats, lens = args
    empty = kmyers.myers_distance_batch(texts[:, :0], pats, lens, **kw)
    assert torch.equal(empty, lens)  # n = 0: the score never moves


def test_unknown_mode_raises():
    t = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        tmyers.myers_distance_batch(t, torch.zeros((2, 32), dtype=torch.int8),
                                    torch.ones(2, dtype=torch.int32),
                                    m_bits=32, mode="local")
