"""Port parity: variation graphs, the q-gram screen and the tiled graph index.

Seeded references and variant lists go through `repro` and
`repro_torch`; graph arrays, boundary masks, q-gram codes, Bloom words,
hit counts and every field of the tiled index must match exactly
(uint32 words compared as bit patterns).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filter as jfilter
from repro.core.segram import graph as jgraph
from repro.genomics import io as jio
from repro.genomics import simulate as jsim
from repro.graph import index as jindex
from repro_torch.core import filter as tfilter
from repro_torch.core.segram import graph as tgraph
from repro_torch.genomics import io as tio
from repro_torch.genomics import simulate as tsim
from repro_torch.graph import index as tindex

INDEX_KW = dict(w=8, k=12, window=192, tile_stride=64, margin=64)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def as_np(x) -> np.ndarray:
    """A port tensor as the reference's dtype of the same values."""
    x = x.numpy()
    return x.view(np.uint32) if x.dtype == np.int32 else x


@pytest.fixture(scope="module")
def ref_and_variants():
    ref = jsim.random_reference(3000, seed=31)
    return ref, jsim.simulate_variants(ref, n_snp=14, n_ins=8, n_del=8,
                                       seed=32)


def test_simulate_variants_and_spelled_paths(ref_and_variants):
    ref, want = ref_and_variants
    got = tsim.simulate_variants(ref, n_snp=14, n_ins=8, n_del=8, seed=32)
    assert [tuple(v) for v in got] == [tuple(v) for v in want]
    g = jgraph.build_graph(ref, want)
    for seed in range(3):
        a = jsim.spell_graph_path(g, 100 * seed, 90,
                                  np.random.default_rng(seed))
        b = tsim.spell_graph_path(g, 100 * seed, 90,
                                  np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)


def test_build_graph_matches_reference(ref_and_variants):
    ref, variants = ref_and_variants
    variants = variants + [jgraph.Variant(50, "snp", (1, 2, 3)),
                           jgraph.Variant(61, "ins", (0, 0, 1))]
    want = jgraph.build_graph(ref, variants)
    got = tgraph.build_graph(ref, [tgraph.Variant(*v) for v in variants])
    for name in ("bases", "succ_bits", "backbone", "node_of_backbone"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tgraph.predecessors(got) == jgraph.predecessors(want)


@pytest.mark.parametrize("pos,kind,alt,span", [
    (10, "snp", (), 1),  # empty snp alt
    (2995, "del", (), 5),  # deletion lands past the reference end
    (100, "ins", (1,) * 20, 1),  # hop beyond HOP_LIMIT
    (5, "dup", (), 1),  # unknown kind
])
def test_bad_variants_raise_the_same_errors(pos, kind, alt, span):
    ref = jsim.random_reference(3000, seed=1)
    with pytest.raises(ValueError) as want:
        jgraph.build_graph(ref, [jgraph.Variant(pos, kind, alt, span)])
    with pytest.raises(ValueError) as got:
        tgraph.build_graph(ref, [tgraph.Variant(pos, kind, alt, span)])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("length", [16, 64, 100])
def test_hop_boundary_mask_and_extract_subgraph(ref_and_variants, length):
    ref, variants = ref_and_variants
    g = jgraph.build_graph(ref, variants)
    for valid in (0, 1, 5, length - 3, length, length + 40):
        np.testing.assert_array_equal(
            u32(tgraph.hop_boundary_mask(length, valid)),
            np.asarray(jgraph.hop_boundary_mask(length, valid)))
    valid = torch.tensor([0, 7, length, 3 * length])  # a batch of window ends
    got = tgraph.hop_boundary_mask(length, valid)
    for i, v in enumerate(valid.tolist()):
        np.testing.assert_array_equal(
            u32(got[i]), np.asarray(jgraph.hop_boundary_mask(length, v)))
    for start in (0, 1234, g.n_nodes - length // 2, g.n_nodes + 5):
        for a, b in zip(tgraph.extract_subgraph(g, start, length),
                        jgraph.extract_subgraph(g, start, length)):
            np.testing.assert_array_equal(a, b)


def test_qgram_primitives(rng):
    tiles = rng.integers(0, 4, size=(6, 300)).astype(np.int8)
    tiles[1, 40:45] = 4  # sentinel chars: windows touching them are skipped
    valid = np.array([300, 250, 8, 7, 0, 300])
    want = np.stack([np.asarray(jfilter.qgram_bloom(jnp.asarray(t), v))
                     for t, v in zip(tiles, valid)])
    got = tfilter.qgram_bloom(torch.from_numpy(tiles), torch.from_numpy(valid))
    np.testing.assert_array_equal(u32(got), want)

    reads = rng.integers(0, 4, size=(6, 128)).astype(np.int8)
    reads[:3, :60] = tiles[:3, 100:160]  # reads that hit their tile
    reads[4, 10:20] = 4
    codes_j = np.stack([np.asarray(jfilter.qgram_codes(jnp.asarray(r)))
                        for r in reads])
    codes_t = tfilter.qgram_codes(torch.from_numpy(reads))
    np.testing.assert_array_equal(codes_t.numpy().astype(np.uint32), codes_j)
    pos_ok = np.arange(codes_j.shape[1])[None, :] < rng.integers(
        40, 121, size=(6, 1))
    hits_j = np.asarray(jfilter.qgram_hits(
        jnp.asarray(codes_j), jnp.asarray(pos_ok), jnp.asarray(want)))
    hits_t = tfilter.qgram_hits(codes_t, torch.from_numpy(pos_ok), got)
    np.testing.assert_array_equal(hits_t.numpy(), hits_j)
    assert hits_j[:2].min() > 40  # the planted reads are confirmed
    n_pos, slack = np.array([121, 60, 0]), np.array([0, 7, 14])
    np.testing.assert_array_equal(
        tfilter.qgram_min_hits(torch.from_numpy(n_pos), 5,
                               torch.from_numpy(slack)).numpy(),
        np.asarray(jfilter.qgram_min_hits(jnp.asarray(n_pos), 5,
                                          jnp.asarray(slack))))


def test_popcount32(rng):
    x = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64).astype(np.uint32)
    x[:3] = (0, 0xFFFFFFFF, 0x80000001)
    want = np.array([bin(int(v)).count("1") for v in x])
    got = tindex.popcount32(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def indexes(ref_and_variants):
    ref, variants = ref_and_variants
    want = jindex.build_graph_index(ref, variants, **INDEX_KW)
    got = tindex.build_graph_index(ref, variants, **INDEX_KW, device="cpu")
    return want, got


def assert_index_equal(got, want):
    for name in jindex.GraphArrays._fields:
        np.testing.assert_array_equal(
            as_np(getattr(got.arrays, name)),
            np.asarray(getattr(want.arrays, name)), err_msg=name)
    for name in ("tile_len", "tile_stride", "minimizer_w", "minimizer_k",
                 "window", "margin"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.ref, want.ref)


def test_build_graph_index_matches_reference(indexes):
    want, got = indexes
    assert_index_equal(got, want)
    assert got.n_tiles == want.n_tiles and got.n_nodes == want.n_nodes
    assert int(got.arrays.tile_slack.max()) > 0  # hop>1 edges were counted


def test_tiles_built_in_chunks_are_identical(ref_and_variants, indexes):
    _, got = indexes
    a = got.arrays
    again = tindex._build_tiles(a.bases, a.succ_bits, tile_len=got.tile_len,
                                tile_stride=got.tile_stride, chunk=5)
    for x, y in zip(again, (a.tile_gtext, a.tile_valid, a.tile_bloom,
                            a.tile_slack)):
        assert torch.equal(x, y)


def test_index_carried_across_and_npz(tmp_path, indexes):
    want, got = indexes
    carried = tindex.graph_index_from_arrays(
        want.ref, jindex.GraphArrays(*(np.asarray(x) for x in want.arrays)),
        tile_len=want.tile_len, tile_stride=want.tile_stride,
        minimizer_w=want.minimizer_w, minimizer_k=want.minimizer_k,
        window=want.window, margin=want.margin, device="cpu")
    assert_index_equal(carried, want)
    jpath, tpath = tmp_path / "j.npz", tmp_path / "t.npz"
    jindex.save_graph_index(jpath, want)
    assert_index_equal(tindex.load_graph_index(jpath, device="cpu"), want)
    tindex.save_graph_index(tpath, got)
    assert_index_equal(tindex.load_graph_index(tpath, device="cpu"), want)
    back = jindex.load_graph_index(tpath)  # the reference reads the port's
    for name in jindex.GraphArrays._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back.arrays, name)),
                                      np.asarray(getattr(want.arrays, name)),
                                      err_msg=name)


def test_epoched_graph_index_refresh(ref_and_variants):
    ref, variants = ref_and_variants
    epi = tindex.build_epoched_graph_index(ref[:1000], variants[:3],
                                           **INDEX_KW, device="cpu")
    old, epoch = epi.current()
    assert epi.refresh(ref) == epoch + 1
    new, _ = epi.current()
    assert new is not old and new.ref_len == 3000
    assert new.n_nodes == len(ref) + 3 - 0  # three variants kept
    assert epi._build_kw["tile_stride"] == 64


def test_gaf_path_and_writer(tmp_path):
    for nodes in ([], [-1, -1], [5, 6, 7, 9, 10, -1, 11, 30],
                  list(range(40, 60))):
        assert tio.gaf_path(nodes) == jio.gaf_path(nodes)
    rows = [{"qname": "read0", "qlen": 10, "qstart": 0, "qend": 10,
             "strand": "+", "path": ">s1-10", "plen": 10, "pstart": 0,
             "pend": 10, "nmatch": 9, "alnlen": 10, "mapq": 60,
             "tstart": 0, "cigar": "9M1X"}]
    tio.write_gaf(tmp_path / "t.gaf", rows)
    jio.write_gaf(tmp_path / "j.gaf", rows)
    assert (tmp_path / "t.gaf").read_bytes() == (tmp_path / "j.gaf").read_bytes()
