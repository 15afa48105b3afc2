"""The CUDA kernels against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so these cases skip without a card (the
CPU suite holds the plain versions against the JAX reference in
tests/test_torch_dc.py, tests/test_torch_graph_align.py and
tests/test_torch_myers.py, and the linear filter's against its
definition in tests/test_torch_bitap_filter.py).  The file
imports no JAX, so it also runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Comparisons are exact (integer bit patterns).
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

# the main-path shape, narrow and wide windows, k from 0 to 32, and ragged
# batches; v2 writes four windows a block (three at w = 128, k >= 28) as
# one region whose end is not 16-byte aligned where a window's (w+1)(k+1)
# nw words are odd (w = 32, k = 0: b = 5 leaves a last block of one window)
WINDOW_SHAPES = [dict(b=b, w=w, k=k) for b, w, k in (
    (256, 64, 24), (16, 64, 8), (16, 96, 16), (16, 128, 24), (5, 64, 24),
    (16, 32, 0), (130, 64, 32), (37, 96, 31), (5, 32, 0), (7, 128, 32))]
# the graph main path's two call sites (filter: R off; align: R on), a
# ragged batch with short patterns and dense hops (hops past N included),
# the kernel's widest rows, and the edges of the wavefront's packing: two
# graph lanes a warp up to k = 15, one from k = 16, every lane at k = 31
# (b = 37 at k = 15 leaves the last block 5 of its 8 graph lanes)
BITALIGN_SHAPES = [
    dict(b=1024, n=1536, m_bits=128, k=11, store_r=False),
    dict(b=256, n=64, m_bits=64, k=24, store_r=True),
    dict(b=37, n=200, m_bits=128, k=11, store_r=True, short=True,
         hop_rate=0.2),
    dict(b=5, n=64, m_bits=96, k=16, store_r=False, short=True, hop_rate=0.5),
    dict(b=40, n=100, m_bits=128, k=32, store_r=True, short=True,
         hop_rate=0.05),
    dict(b=8, n=70, m_bits=32, k=0, store_r=True),
    dict(b=37, n=120, m_bits=128, k=15, store_r=True, short=True,
         hop_rate=0.2),
    dict(b=37, n=120, m_bits=128, k=15, store_r=False, short=True,
         hop_rate=0.2),
    dict(b=13, n=90, m_bits=64, k=16, store_r=True, short=True, hop_rate=0.3),
    dict(b=6, n=150, m_bits=96, k=31, store_r=True, short=True,
         hop_rate=0.3),
    dict(b=6, n=150, m_bits=96, k=31, store_r=False, short=True,
         hop_rate=0.3),
]
# the edit-distance main path's three sites (benchmark buffers at L = 1,000
# and 5,000, the pattern cut to m_bits), narrow widths with the edge m_lens
# 0, 1 and m_bits in both modes, ragged batches (several pairs a warp up
# to 16 words), widths whose last lane holds fewer words than the others,
# the two widths on either side of the edge between one warp a pair (up to
# 10,240 bits) and a pipeline of warps a pair, the widest pattern of the
# first design (265,632 bits: 26 warps, the last lane part-filled) and the
# widest this one takes on the H100 (327,680 bits: 32 warps, 1,024 threads)
MYERS_SHAPES = [
    dict(b=1024, n=1192, m_bits=1024, mode="semiglobal"),
    dict(b=256, n=5192, m_bits=5056, mode="semiglobal"),
    dict(b=1024, n=1192, m_bits=1024, mode="global"),
    *(dict(b=37, n=150, m_bits=m_bits, mode=mode, short=True)
      for m_bits in (32, 64, 96, 128) for mode in ("global", "semiglobal")),
    dict(b=5, n=300, m_bits=64, mode="semiglobal", short=True),
    dict(b=130, n=200, m_bits=1056, mode="global", short=True),
    dict(b=3, n=40, m_bits=2080, mode="semiglobal", short=True),
    dict(b=3, n=64, m_bits=10240, mode="semiglobal", short=True),
    dict(b=3, n=64, m_bits=10272, mode="global", short=True),
    dict(b=3, n=400, m_bits=265_632, mode="global", short=True),
    dict(b=3, n=400, m_bits=327_680, mode="semiglobal", short=True),
]
# the linear mapper's filter: its main-path widths and budget (16,384 lanes
# of 216 bases), nw 1..4, k = 0, the edges of the 8-, 16- and 32-row
# instantiations (k = 7, 8, 15, 16) and the kernel's maximum, regions before
# the buffer's start and past its end (SENTINEL) from a buffer that starts
# off a 16-byte boundary, reads shorter than filter_bits (WILDCARD), planted
# ties, ragged lane counts (one and three candidates, a part-filled last
# block) and regions of one and 17 bases
FILTER_SHAPES = [
    dict(b=4096, c=4, filter_bits=128, k=12, ref_len=1 << 20),
    dict(b=300, filter_bits=32, k=3),
    dict(b=300, filter_bits=64, k=5),
    dict(b=300, filter_bits=96, k=9, offset=5),
    dict(b=300, filter_bits=128, k=0),
    *(dict(b=130, filter_bits=128, k=k) for k in (7, 8, 15, 16)),
    dict(b=130, filter_bits=128, k=31),
    dict(b=37, c=3, filter_bits=32, k=31),
    dict(b=500, filter_bits=128, k=12, ref_len=3000, edge=True, offset=7),
    dict(b=500, filter_bits=64, k=6, region_len=150, ref_len=700, edge=True,
         offset=13),
    dict(b=500, filter_bits=128, k=12, short=True, offset=1),
    dict(b=500, filter_bits=128, k=12, ties=True),
    dict(b=500, filter_bits=96, k=12, ties=True, short=True, edge=True,
         ref_len=1000),
    dict(b=77, c=1, filter_bits=128, k=12, region_len=17),
    dict(b=77, c=4, filter_bits=64, k=4, region_len=1),
]
SHAPES = {"window_dc_batch": WINDOW_SHAPES, "window_dc_batch_v2": WINDOW_SHAPES,
          "bitalign_dc_batch": BITALIGN_SHAPES,
          "myers_distance_batch": MYERS_SHAPES,
          "bitap_filter_batch": FILTER_SHAPES}
CASES = [(kern, shape) for kern in ops.KERNELS for shape in SHAPES[kern.name]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _outputs_equal(got, want) -> bool:
    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kern,shape", CASES,
    ids=[f"{kern.name}-" + "-".join(f"{k}{v}" for k, v in shape.items())
         for kern, shape in CASES])
def test_cuda_kernel_matches_plain(cuda_device, kern, shape):
    rng = np.random.default_rng(zlib.crc32(repr(sorted(shape.items())).encode()))
    args, kw = kern.make_inputs(rng, cuda_device, **shape)
    launches = kern.wrapper.launches
    got = kern.wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert kern.wrapper.launches == launches + 1
    assert _outputs_equal(got, kern.plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kern", ops.KERNELS[:2], ids=lambda kern: kern.name)
def test_cuda_kernel_rejects_bad_input(cuda_device, kern):
    t = torch.zeros((4, 64), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        kern.wrapper(t, t, w=64, k=33)  # beyond the kernel's register rows
    with pytest.raises(TypeError):
        kern.wrapper(t.int(), t.int(), w=64, k=8)


@pytest.mark.cuda
def test_bitalign_rejects_bad_input(cuda_device):
    (bases, succ, pats, p_lens), _ = ops.bitalign_inputs(
        np.random.default_rng(0), cuda_device, b=4, n=32, m_bits=64, k=8)
    kern = ops.KERNELS[2].wrapper
    with pytest.raises(ValueError):
        kern(bases, succ, pats, p_lens, m_bits=64, k=33)
    with pytest.raises(ValueError):
        kern(bases, succ, pats, p_lens, m_bits=160, k=8)
    with pytest.raises(TypeError):
        kern(bases, succ.long(), pats, p_lens, m_bits=64, k=8)


@pytest.mark.cuda
def test_myers_rejects_bad_input(cuda_device):
    (texts, pats, m_lens), _ = ops.myers_inputs(
        np.random.default_rng(0), cuda_device, b=4, n=32, m_bits=64)
    kern = ops.KERNELS[3].wrapper
    with pytest.raises(ValueError):
        kern(texts, pats, m_lens, m_bits=96)  # pattern width differs
    with pytest.raises(ValueError):
        kern(texts, pats, m_lens, m_bits=64, mode="local")
    with pytest.raises(ValueError):
        kern(texts, pats, m_lens.cpu(), m_bits=64)
    with pytest.raises(TypeError):
        kern(texts.int(), pats, m_lens, m_bits=64)
    from repro_torch.kernels import _build

    max_bits = _build.library("myers").myers_max_m_bits(0)
    assert max_bits >= 265_632  # the first design's widest on a 227 KB card
    wide = torch.full((4, max_bits + 32), 4, dtype=torch.int8,
                      device=cuda_device)
    with pytest.raises(ValueError):
        kern(texts, wide, m_lens, m_bits=max_bits + 32)


@pytest.mark.cuda
def test_myers_empty_inputs_launch_nothing(cuda_device):
    (texts, pats, m_lens), kw = ops.myers_inputs(
        np.random.default_rng(1), cuda_device, b=4, n=32, m_bits=64, short=True)
    kern = ops.KERNELS[3].wrapper
    launches = kern.launches
    assert torch.equal(kern(texts[:, :0], pats, m_lens, **kw), m_lens)
    assert kern(texts[:0], pats[:0], m_lens[:0], **kw).shape == (0,)
    assert kern.launches == launches


@pytest.mark.cuda
def test_bitap_filter_rejects_bad_input(cuda_device):
    from repro_torch.kernels import _build, bitap_filter

    args, kw = ops.filter_inputs(np.random.default_rng(0), cuda_device, b=4)
    kern = bitap_filter.bitap_filter_batch
    max_k = _build.library("bitap_filter").bitap_filter_max_k()
    assert max_k == 31
    with pytest.raises(ValueError):
        kern(*args, **{**kw, "k": max_k + 1})  # beyond the register rows
    with pytest.raises(ValueError):
        kern(*args, **{**kw, "filter_bits": 160})
    with pytest.raises(ValueError):
        kern(args[0], args[1], args[2].cpu(), args[3], **kw)
    with pytest.raises(TypeError):
        kern(args[0], args[1].int(), args[2], args[3], **kw)
    with pytest.raises(TypeError):
        kern(args[0].long(), *args[1:], **kw)


def filter_rows_inputs(device, rng):
    """`core.mapper._filter_rows`' arguments for a shard-like buffer: the
    global reference's bases ``[1000, 31000)`` of 50,000, its offset a 0-d
    tensor on ``device``, candidates before, inside and past the buffer,
    some without votes."""
    (ref, starts, reads, lens), _ = ops.filter_inputs(
        rng, "cpu", b=2048, edge=True, short=True, ref_len=50_000)
    votes = torch.from_numpy(rng.integers(0, 3, size=tuple(starts.shape)))
    return dict(ref_buf=ref[1000:31_000].to(device),
                ref_offset=torch.tensor(1000, device=device), ref_len=50_000,
                starts=(starts + 44).to(device), votes=votes.to(device),
                reads=reads.to(device), lens=lens.to(device))


@pytest.mark.cuda
def test_filter_rows_on_the_card_equal_the_cpu(cuda_device):
    """The linear mapper's filter stage on the card: one kernel launch, no
    host synchronisation, and every field the CPU's plain path gives."""
    from repro_torch.core import mapper
    from repro_torch.kernels import bitap_filter

    kw = dict(p_cap=160, t_cap=288, filter_bits=128, filter_k=12)
    args = filter_rows_inputs(cuda_device, np.random.default_rng(3))
    mapper._filter_rows(**args, **kw)  # the library built and loaded
    torch.cuda.synchronize()
    launches = bitap_filter.bitap_filter_batch.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mapper._filter_rows(**args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bitap_filter.bitap_filter_batch.launches == launches + 1
    want = mapper._filter_rows(**{n: x.cpu() if torch.is_tensor(x) else x
                                  for n, x in args.items()}, **kw)
    for name, g, w in zip(mapper.SeedFilterResult._fields, got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w), name
    ok = want.prefilter_ok
    assert ok.any() and not ok.all()


@pytest.mark.cuda
def test_sharded_linear_mapping_on_the_card(cuda_device):
    """`map_batch_sharded` at 1 and 2 shards on one card (each shard's
    filter takes its slice's offset as a 0-d device tensor) equal each
    other and the CPU's 1-shard rows."""
    from repro_torch import shard
    from repro_torch.genomics import encode, simulate
    from repro_torch.kernels import bitap_filter

    ref = simulate.random_reference(40_000, seed=7)
    rs = simulate.simulate_reads(ref, n_reads=256, read_len=150, seed=8)
    reads, lens = encode.batch_reads(rs.reads, 256)
    runs = {}
    for name, n, dev in (("card1", 1, cuda_device), ("card2", 2, cuda_device),
                         ("cpu1", 1, torch.device("cpu"))):
        index = shard.build_sharded_index(ref, n, devices=(dev,))
        before = bitap_filter.bitap_filter_batch.launches
        runs[name] = shard.map_batch_sharded(index, reads, lens, backend="torch")
        launched = bitap_filter.bitap_filter_batch.launches - before
        assert launched == (n if dev.type == "cuda" else 0), name
    for f in runs["cpu1"]._fields:
        want = torch.as_tensor(getattr(runs["cpu1"], f)).cpu()
        for name in ("card1", "card2"):
            got = torch.as_tensor(getattr(runs[name], f)).cpu()
            assert torch.equal(got, want), (name, f)
    assert int((torch.as_tensor(runs["cpu1"].position) >= 0).sum()) >= 200


@pytest.mark.cuda
def test_wavefront_launch_geometry(cuda_device):
    """One warp per window, one window a block (v1), four a block (v2;
    three at w = 128 from k = 28); BitAlign packs two graph lanes a warp up to
    k = 15, four warps a block, with a hop ring of 16 slots without R and
    32 or 64 with it; Myers one warp a pair at L = 1 and 5 kbp, 10
    warps a pair at 100 kbp and up to 32 for the widest patterns, whose
    PEq and ring sit in shared memory."""
    from repro_torch.kernels import bitalign, genasm_dc, genasm_dc_v2, myers

    assert genasm_dc.launch_geometry(256, 64, 24) == dict(
        warps=256, blocks=256, smem_bytes=38_400 + 64)
    assert genasm_dc_v2.launch_geometry(256, 64, 24) == dict(
        warps=256, blocks=64, smem_bytes=4 * (13_000 + 64) + 12)
    assert genasm_dc_v2.launch_geometry(7, 128, 32) == dict(
        warps=7, blocks=3, smem_bytes=3 * (68_112 + 128) + 12)
    assert myers.launch_geometry(1024, 1024, cuda_device) == dict(
        warps=1024, blocks=256, smem_bytes=0, words_per_lane=1,
        lanes_per_pair=32, warps_per_pair=1)
    assert myers.launch_geometry(256, 5056, cuda_device) == dict(
        warps=256, blocks=64, smem_bytes=0, words_per_lane=5,
        lanes_per_pair=32, warps_per_pair=1)
    assert myers.launch_geometry(8, 100_032, cuda_device) == dict(
        warps=80, blocks=8, smem_bytes=(10 * 5 * 10 * 32 + 2 * 10) * 4,
        words_per_lane=10, lanes_per_pair=32, warps_per_pair=10)
    for m_bits, g in ((265_632, 26), (327_680, 32)):  # the widest two
        assert myers.launch_geometry(3, m_bits, cuda_device) == dict(
            warps=3 * g, blocks=3, smem_bytes=(g * 5 * 10 * 32 + 2 * g) * 4,
            words_per_lane=10, lanes_per_pair=32, warps_per_pair=g)
    assert bitalign.launch_geometry(1024, 128, 11, False, cuda_device) == dict(
        warps=512, blocks=128, smem_bytes=4 * (16 * 4 * 32 + 2 * 16) * 4)
    assert bitalign.launch_geometry(256, 64, 24, True, cuda_device) == dict(
        warps=256, blocks=64, smem_bytes=4 * (64 * 2 * 32 + 16) * 4)
    assert bitalign.launch_geometry(37, 128, 15, True, cuda_device) == dict(
        warps=20, blocks=5, smem_bytes=4 * (32 * 4 * 32 + 2 * 16) * 4)
    from repro_torch.kernels import bitap_filter

    # the filter: one thread a lane, 128 lanes a block, 6 masks of nw words
    # a lane in shared memory
    assert bitap_filter.launch_geometry(1_048_576, 128, 12) == dict(
        warps=32_768, blocks=8_192, smem_bytes=6 * 4 * 128 * 4)
    assert bitap_filter.launch_geometry(111, 32, 31) == dict(
        warps=4, blocks=1, smem_bytes=6 * 1 * 128 * 4)


def tied_stage(s: int, b: int, rng, *, graph: bool):
    """[S, B] shard winners with ties at every level of the merge key
    (full-key ties too, which the lowest shard must win) and dead
    candidates (sentinel position, or sentinel origin and tile); graph
    distances fall on both sides of 2048."""
    from repro_torch.core.mapper import POS_SENTINEL

    if graph:
        d = rng.choice(np.array([0, 3, 2047, 2048, 4094]), size=(s, b))
    else:
        d = rng.integers(0, 14, size=(s, b))
    pos = rng.integers(0, 5000, size=(s, b))
    tile = rng.integers(0, 2000, size=(s, b))
    for frac, cols in ((0.4, (d,)), (0.3, (d, pos)), (0.2, (d, pos, tile))):
        tie = rng.random(b) < frac
        for a in cols:
            a[:, tie] = a[0, tie]
    dead = rng.random((s, b)) < 0.3
    dead[:, 0] = True  # an all-dead column: shard 0 must win it
    d[dead] = 4094 if graph else 13
    pos[dead] = POS_SENTINEL
    tile[dead] = POS_SENTINEL
    return [torch.from_numpy(a.astype(np.int32)) for a in (d, pos, tile)]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3, 4])
def test_shard_merges_on_the_card(cuda_device, s):
    """The sharded mappers' device merges on the card equal their host
    oracles (`merge_host`), ties to the lowest shard included, for the
    linear ``(distance, position)`` and the graph ``(distance, origin,
    tile)`` keys."""
    from repro_torch.graph.mapper import CandidateStageResult
    from repro_torch.shard.graph_mapper import ShardedGraphMapExecutor
    from repro_torch.shard.mapper import ShardedMapExecutor, ShardStageResult

    rng = np.random.default_rng(90 + s)
    d, pos, _ = tied_stage(s, 64, rng, graph=False)
    text = torch.from_numpy(rng.integers(0, 4, size=(s, 64, 16)).astype(np.int8))
    st = ShardStageResult(d, pos, text, d.abs() % 17)
    host = ShardedMapExecutor.merge_host(st)
    dev = ShardedMapExecutor.merge_device(
        ShardStageResult(*(x.to(cuda_device) for x in st)))
    for h, g in zip(host, dev):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), h)
    tied = ((d == d[0]) & (pos == pos[0])).all(0)
    assert tied.any() and (dev[4].cpu()[tied] == 0).all()

    d, origin, tile = tied_stage(s, 64, rng, graph=True)
    gst = CandidateStageResult(
        distance=d, origin=origin, tile=tile,
        gwin=torch.from_numpy(rng.integers(0, 2 ** 31, size=(s, 64, 8))
                              .astype(np.int32)),
        bwin=origin[..., None].long() + torch.arange(8),
        t_len=d.abs() % 9, prefilter_ok=d < 2048)
    ghost = ShardedGraphMapExecutor.merge_host(gst)
    gdev = ShardedGraphMapExecutor.merge_device(
        CandidateStageResult(*(x.to(cuda_device) for x in gst)))
    for f in CandidateStageResult._fields:
        np.testing.assert_array_equal(getattr(gdev, f).cpu().numpy(),
                                      getattr(ghost, f), err_msg=f)
