"""Port parity: GenASM-DC core and both DC kernels against the JAX reference.

The same seeded numpy inputs go through `repro` (the Pallas kernels in
interpret mode, as tests/test_kernels.py runs them) and `repro_torch`
(the kernels' plain versions, which the wrappers take for CPU tensors).
Every comparison is exact: words are compared as uint32 bit patterns.
The CUDA kernels themselves run only on a GPU:
tests/test_torch_kernels_cuda.py holds them against these plain versions.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as jbv
from repro.core import genasm_dc as jdc
from repro.kernels import ops as jops
from repro_torch.core import bitvector as tbv
from repro_torch.core import genasm_dc as tdc
from repro_torch.kernels import ops as tops
from repro_torch.kernels.genasm_dc import window_dc_batch
from repro_torch.kernels.genasm_dc_v2 import window_dc_batch_v2

SWEEP = [(64, 24), (64, 8), (96, 16), (128, 24)]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def windows(rng, b, w, hi=5):
    texts = rng.integers(0, hi, size=(b, w)).astype(np.int8)
    pats = rng.integers(0, hi, size=(b, w)).astype(np.int8)
    return texts, pats


@pytest.mark.parametrize("n_bits", [32, 64, 128])
def test_pattern_bitmasks(rng, n_bits):
    pats = rng.integers(0, 5, size=(6, n_bits)).astype(np.int8)
    ref = np.asarray(jbv.pattern_bitmasks(jnp.asarray(pats), n_bits))
    got = tbv.pattern_bitmasks(torch.from_numpy(pats), n_bits)
    np.testing.assert_array_equal(u32(got), ref)


@pytest.mark.parametrize("nw", [1, 2, 4])
def test_shl1_and_msb(rng, nw):
    x = words(rng, (16, nw))
    x[0] = 0xFFFFFFFF
    x[1] = 0x80000000  # every word's carry set
    xt = torch.from_numpy(x.view(np.int32))
    np.testing.assert_array_equal(u32(tbv.shl1(xt)),
                                  np.asarray(jbv.shl1(jnp.asarray(x))))
    np.testing.assert_array_equal(tbv.msb(xt).numpy(),
                                  np.asarray(jbv.msb(jnp.asarray(x))))


def test_get_bit_per_lane_positions(rng):
    x = words(rng, (32, 3))
    pos = rng.integers(0, 96, size=32)
    ref = np.asarray(jax.vmap(jbv.get_bit)(jnp.asarray(x), jnp.asarray(pos)))
    got = tbv.get_bit(torch.from_numpy(x.view(np.int32)), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w,k", SWEEP + [(32, 0)])
@pytest.mark.parametrize("store_r", [False, True])
def test_window_dc_core(rng, w, k, store_r):
    texts, pats = windows(rng, 6, w)
    jfn = jdc.window_dc_r if store_r else jdc.window_dc
    tfn = tdc.window_dc_r if store_r else tdc.window_dc
    d_ref, s_ref = jax.vmap(partial(jfn, w=w, k=k))(jnp.asarray(texts),
                                                    jnp.asarray(pats))
    d, s = tfn(torch.from_numpy(texts), torch.from_numpy(pats), w=w, k=k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(u32(s), np.asarray(s_ref))


@pytest.mark.parametrize("m_bits,k", [(64, 4), (128, 11)])
def test_bitap_search(rng, m_bits, k):
    n_lanes, n = 5, m_bits + 40
    text = rng.integers(0, 4, size=(n_lanes, n)).astype(np.int8)
    pat = np.full((n_lanes, m_bits), 4, np.int8)
    for i in range(n_lanes):  # a planted, mutated copy so distances vary
        m = int(rng.integers(m_bits // 2, m_bits))
        s = int(rng.integers(0, n - m))
        pat[i, :m] = text[i, s: s + m]
        flips = rng.integers(0, m, size=i)
        pat[i, flips] = (pat[i, flips] + 1) % 4
    ref = jax.vmap(partial(jdc.bitap_search, m_bits=m_bits, k=k))(
        jnp.asarray(text), jnp.asarray(pat))
    got = tdc.bitap_search(torch.from_numpy(text), torch.from_numpy(pat),
                           m_bits=m_bits, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("w,k", SWEEP)
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_plain_kernel_matches_pallas(rng, w, k, version):
    texts, pats = windows(rng, 16, w)
    jfn = jops.window_dc if version == "v1" else jops.window_dc_v2
    tfn = window_dc_batch if version == "v1" else window_dc_batch_v2
    d_ref, s_ref = jfn(jnp.asarray(texts), jnp.asarray(pats), w=w, k=k,
                       block_bt=8)
    before = tops.launch_counts()
    d, s = tfn(torch.from_numpy(texts), torch.from_numpy(pats), w=w, k=k)
    assert tops.launch_counts() == before  # CPU tensors never launch
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(u32(s), np.asarray(s_ref))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_plain_kernel_wildcards_and_sentinels(version):
    """All-sentinel texts against all-wildcard patterns match at d=0."""
    texts = np.full((8, 64), 4, np.int8)
    pats = np.full((8, 64), 4, np.int8)
    jfn = jops.window_dc if version == "v1" else jops.window_dc_v2
    tfn = window_dc_batch if version == "v1" else window_dc_batch_v2
    d_ref, s_ref = jfn(jnp.asarray(texts), jnp.asarray(pats), block_bt=8)
    d, s = tfn(torch.from_numpy(texts), torch.from_numpy(pats))
    np.testing.assert_array_equal(d.numpy(), 0)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(u32(s), np.asarray(s_ref))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_plain_kernel_ragged_batch_of_5(rng, version):
    texts, pats = windows(rng, 5, 64, hi=4)
    jfn = jops.window_dc if version == "v1" else jops.window_dc_v2
    tfn = window_dc_batch if version == "v1" else window_dc_batch_v2
    d_ref, s_ref = jfn(jnp.asarray(texts), jnp.asarray(pats), block_bt=4)
    d, s = tfn(torch.from_numpy(texts), torch.from_numpy(pats))
    assert d.shape == (5,) and s.shape[0] == 5
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(u32(s), np.asarray(s_ref))
