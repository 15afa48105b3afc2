"""Port parity: minimizer seeding, the linear mapper and index carry-across.

Seeded numpy references and reads go through `repro` and `repro_torch`;
k-mer codes, hashes, minimizers, the index tables, seed candidates and
every `MapResult` field must match exactly.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapper as jmapper
from repro.core import minimizer_index as jindex
from repro.core.segram import minimizer as jmin
from repro.genomics import encode, simulate
from repro_torch.core import mapper as tmapper
from repro_torch.core import minimizer_index as tindex
from repro_torch.core.segram import minimizer as tmin


def repetitive_reference(seed: int, n: int = 4000) -> np.ndarray:
    """Random sequence with tandem repeats, which the frequency filter cuts."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, size=37).astype(np.int8)
    ref = rng.integers(0, 4, size=n).astype(np.int8)
    ref[1000:1000 + 37 * 20] = np.tile(unit, 20)
    ref[2500:2500 + 37 * 10] = np.tile(unit, 10)
    return ref


def duplicated_reference(seed: int, n: int = 4000) -> np.ndarray:
    """Random sequence whose bases 500..800 recur at 2000..2300."""
    ref = simulate.random_reference(n, seed=seed)
    ref[2000:2300] = ref[500:800]
    return ref


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("k", [12, 15])
def test_kmer_codes(rng, k):
    seq = rng.integers(0, 4, size=300).astype(np.int8)
    seq[rng.integers(0, 300, size=6)] = 4  # non-ACGT k-mers -> 0xFFFFFFFF
    ref = np.asarray(jmin.kmer_codes(jnp.asarray(seq), k))
    got = tmin.kmer_codes(torch.from_numpy(seq), k)
    np.testing.assert_array_equal(as_u32(got), ref)


def test_hash32_wraps_mod_2_32(rng):
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF],
                 np.uint32),
        rng.integers(0, 2 ** 32, size=500, dtype=np.uint64).astype(np.uint32)])
    ref = np.asarray(jmin.hash32(jnp.asarray(x)))
    got = tmin.hash32(torch.from_numpy(x.astype(np.int64)))
    assert (ref >= 2 ** 31).any()
    np.testing.assert_array_equal(as_u32(got), ref)


@pytest.mark.parametrize("w,k", [(8, 12), (10, 15)])
def test_minimizers(rng, w, k):
    seq = rng.integers(0, 4, size=400).astype(np.int8)
    seq[rng.integers(0, 400, size=5)] = 4
    seq[100:160] = np.tile(seq[100:106], 10)  # equal hashes inside windows
    is_min, h = jax.jit(partial(jmin.minimizers, w=w, k=k))(jnp.asarray(seq))
    t_min, t_h = tmin.minimizers(torch.from_numpy(seq), w=w, k=k)
    np.testing.assert_array_equal(t_min.numpy(), np.asarray(is_min))
    np.testing.assert_array_equal(as_u32(t_h), np.asarray(h))


@pytest.mark.parametrize("ref_fn", [
    lambda: simulate.random_reference(4000, seed=11),
    lambda: repetitive_reference(5),
])
def test_build_index(ref_fn):
    ref = ref_fn()
    want = jmin.build_index(ref, w=8, k=12, freq_frac=0.01)
    got = tmin.build_index(ref, w=8, k=12, freq_frac=0.01, device="cpu")
    np.testing.assert_array_equal(got.hashes, want.hashes)
    np.testing.assert_array_equal(got.positions, want.positions)
    assert got.freq_cap == want.freq_cap


def test_seed_candidates_with_ties():
    ref = duplicated_reference(6)
    jidx = jindex.build_reference_index(ref, w=8, k=12)
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    rs = simulate.simulate_reads(ref, n_reads=10, read_len=120,
                                 profile=simulate.ILLUMINA, seed=4)
    reads, _ = encode.batch_reads(rs.reads, 128)
    reads[0, :120] = ref[550:670]  # two equally supported diagonals
    f = jax.vmap(partial(jmin.seed_candidates, w=8, k=12, max_candidates=4),
                 in_axes=(0, None, None))
    starts, votes = f(jnp.asarray(reads), jidx.hashes, jidx.positions)
    t_starts, t_votes = tmin.seed_candidates(
        torch.from_numpy(reads), tidx.hashes, tidx.positions, w=8, k=12,
        max_candidates=4)
    votes = np.asarray(votes)
    assert votes[0, 0] == votes[0, 1] > 0  # the tie case is exercised
    np.testing.assert_array_equal(t_starts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(t_votes.numpy(), votes)


def mapper_inputs():
    """The inputs of tests/test_mapper_and_filter.py::test_mapper_end_to_end,
    with N (id 4) inside two reads: three scattered, and a run of five."""
    ref = simulate.random_reference(4000, seed=11)
    rs = simulate.simulate_reads(ref, n_reads=12, read_len=120,
                                 profile=simulate.ILLUMINA, seed=3)
    reads, lens = encode.batch_reads(rs.reads, 128)
    reads[2, [7, 60, 100]] = 4
    reads[9, 40:45] = 4
    return ref, reads, lens


MAP_KW = dict(p_cap=192, filter_bits=128, filter_k=16, minimizer_w=8,
              minimizer_k=12)


def assert_map_equal(got, want):
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_seed_and_filter_batch():
    ref, reads, lens = mapper_inputs()
    jidx = jindex.build_reference_index(ref, w=8, k=12)
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    kw = dict(p_cap=192, t_cap=192 + 128, filter_bits=128, filter_k=16,
              max_candidates=4, minimizer_w=8, minimizer_k=12)
    want = jmapper.seed_and_filter_batch(jidx, jnp.asarray(reads),
                                         jnp.asarray(lens), **kw)
    got = tmapper.seed_and_filter_batch(tidx, torch.from_numpy(reads),
                                        torch.from_numpy(lens), **kw)
    assert_map_equal(got, want)


@pytest.mark.parametrize("backend", ["torch", "cuda_dc_v2"])
def test_map_batch(backend):
    ref, reads, lens = mapper_inputs()
    jidx = jindex.build_reference_index(ref, w=8, k=12)
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    want = jmapper.map_batch(jidx, jnp.asarray(reads), jnp.asarray(lens),
                             backend="lax", **MAP_KW)
    got = tmapper.map_batch(tidx, torch.from_numpy(reads),
                            torch.from_numpy(lens), backend=backend, **MAP_KW)
    assert_map_equal(got, want)
    assert (got.position.numpy() >= 0).sum() >= 10


def test_index_carry_across():
    """A JAX-built index carried into the port is the port's own index,
    and serving from it gives the reference's MapResults."""
    ref, reads, lens = mapper_inputs()
    jidx = jindex.build_reference_index(ref, w=8, k=12)
    carried = tindex.index_from_arrays(np.asarray(jidx.ref),
                                       np.asarray(jidx.hashes),
                                       np.asarray(jidx.positions), device="cpu")
    own = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    for name in own._fields:
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    np.testing.assert_array_equal(as_u32(carried.hashes), np.asarray(jidx.hashes))
    want = jmapper.map_batch(jidx, jnp.asarray(reads), jnp.asarray(lens),
                             backend="lax", **MAP_KW)
    got = tmapper.map_batch(carried, reads, lens, backend="torch", **MAP_KW)
    assert_map_equal(got, want)


def test_linear_map_executor_matches_map_batch():
    ref, reads, lens = mapper_inputs()
    tidx = tindex.build_reference_index(ref, w=8, k=12, device="cpu")
    ex = tmapper.LinearMapExecutor(backend="torch", max_candidates=4, **MAP_KW)
    got = ex(tidx, reads, lens)
    want = tmapper.map_batch(tidx, reads, lens, backend="torch", **MAP_KW)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert [name for name, *_ in ex.last_times] == ["seed_filter", "align"]
    assert all(t1 >= t0 for _, t0, t1, _ in ex.last_times)


def test_epoched_index_refresh_bumps_epoch():
    epi = tindex.build_epoched_index(simulate.random_reference(600, seed=1),
                                     w=8, k=12, device="cpu")
    old, epoch = epi.current()
    new_ref = simulate.random_reference(700, seed=2)
    assert epi.refresh(new_ref) == epoch + 1
    idx, _ = epi.current()
    assert idx.ref.shape[0] == 700 and idx is not old
    np.testing.assert_array_equal(
        as_u32(idx.hashes), tmin.build_index(new_ref, w=8, k=12, device="cpu").hashes)
