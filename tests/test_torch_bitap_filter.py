"""The linear mapper's filter (`repro_torch.kernels.bitap_filter`) on the CPU.

The plain version is held against the filter's definition, written here
lane by lane with Python integers as the bitvectors: the region clamped
into the buffer and padded with SENTINEL, the read's first ``filter_bits``
bases with WILDCARD past its length, the Bitap recurrence from the
region's end, and the least distance with the first position that
reaches it.  The CUDA kernel is held against the plain version on a card
(tests/test_torch_kernels_cuda.py).  The wrapper's input checks raise
before the kernel's library is loaded, so they are tested here on
``meta`` tensors.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, bitap_filter, ops


def lane_distances(ref, start, read, read_len, *, filter_bits, k, region_len):
    """One lane's distance at every region position, from the definition."""
    n = len(ref)
    s = min(max(start, 0), n)
    text = [int(ref[s + i]) if s + i < n else 4 for i in range(region_len)]
    plen = min(max(read_len, 0), filter_bits)
    pat = [int(read[j]) if j < plen else 4 for j in range(filter_bits)]
    full = (1 << filter_bits) - 1
    # PM[c] bit (filter_bits-1-j) is 1 iff pattern char j mismatches c
    pm = [sum(1 << (filter_bits - 1 - j) for j, p in enumerate(pat)
              if not (p == c or p == 4)) for c in range(5)]
    rows = [full] * (k + 1)
    dists = [0] * region_len
    for i in reversed(range(region_len)):
        new = []
        for d in range(k + 1):
            m = ((rows[d] << 1) & full) | pm[text[i]]
            if d:
                m &= rows[d - 1] & ((rows[d - 1] << 1) & full) & \
                    ((new[d - 1] << 1) & full)
            new.append(m)
        rows = new
        dists[i] = next((d for d in range(k + 1)
                         if not rows[d] >> (filter_bits - 1) & 1), k + 1)
    return dists


def definition(ref, start, read, read_len, **kw):
    """``(distance, offset)`` of one lane: the least distance and the
    first position that reaches it."""
    dists = lane_distances(ref, start, read, read_len, **kw)
    return min(dists), dists.index(min(dists))


def by_definition(args, kw):
    ref, starts, reads, lens = (x.numpy() for x in args)
    out = [[definition(ref, int(starts[b, c]), reads[b], int(lens[b]), **kw)
            for c in range(starts.shape[1])] for b in range(starts.shape[0])]
    arr = np.array(out, dtype=np.int32).reshape(starts.shape + (2,))
    return arr[..., 0], arr[..., 1]


# (name, filter_inputs shape): the main path's widths and budget; nw 1..3;
# k = 0 and the kernel's maximum; regions before the buffer's start and past
# its end; short reads; planted ties
CASES = [
    ("main", dict(b=6, filter_bits=128, k=12)),
    ("nw1", dict(b=6, filter_bits=32, k=3)),
    ("nw2", dict(b=6, filter_bits=64, k=5, region_len=100)),
    ("nw3", dict(b=5, filter_bits=96, k=8, offset=3)),
    ("k0", dict(b=6, filter_bits=64, k=0, region_len=80)),
    ("k_max", dict(b=3, c=2, filter_bits=128, k=31, region_len=100)),
    ("edge", dict(b=8, filter_bits=64, k=6, region_len=120, ref_len=400,
                  edge=True)),
    ("short", dict(b=8, filter_bits=96, k=10, region_len=150, short=True)),
    ("ties", dict(b=8, filter_bits=64, k=8, region_len=120, ties=True)),
]


@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
def test_plain_version_is_the_definition(name, shape):
    args, kw = ops.filter_inputs(np.random.default_rng(len(name)), "cpu", **shape)
    dist, off = bitap_filter.bitap_filter_batch_plain(*args, **kw)
    assert dist.dtype == off.dtype == torch.int32
    want_d, want_o = by_definition(args, kw)
    np.testing.assert_array_equal(dist.numpy(), want_d)
    np.testing.assert_array_equal(off.numpy(), want_o)
    # the lanes with no match within k report k+1 at offset 0
    miss = want_d == kw["k"] + 1
    assert miss.any() and (want_o[miss] == 0).all()
    assert (want_d <= kw["k"]).any()


def test_the_cases_reach_their_edges():
    """Each case exercises what its name says."""
    cases = dict(CASES)
    args, kw = ops.filter_inputs(np.random.default_rng(4), "cpu", **cases["edge"])
    ref, starts = args[0], args[1]
    assert (starts < 0).any() and (starts + kw["region_len"] > len(ref)).any()
    assert (starts >= len(ref)).any()
    args, kw = ops.filter_inputs(np.random.default_rng(5), "cpu", **cases["short"])
    assert args[3][:2].tolist() == [0, 1] and (args[3] < kw["filter_bits"]).all()
    args, kw = ops.filter_inputs(np.random.default_rng(4), "cpu", **cases["ties"])
    ref, starts, reads, lens = (x.numpy() for x in args)
    tied = 0
    for b in range(starts.shape[0]):
        for c in range(starts.shape[1]):
            dists = lane_distances(ref, int(starts[b, c]), reads[b], int(lens[b]),
                                   **kw)
            tied += min(dists) <= kw["k"] and dists.count(min(dists)) > 1
    assert tied  # a lane whose least distance is reached at several positions


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args, kw = ops.filter_inputs(np.random.default_rng(9), "cpu", b=16, edge=True,
                                 short=True, ref_len=2000)
    before = ops.launch_counts()
    got = bitap_filter.bitap_filter_batch(*args, **kw)
    want = bitap_filter.bitap_filter_batch_plain(*args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == before  # CPU tensors never launch
    empty = [args[0], args[1][:0], args[2][:0], args[3][:0]]
    d, o = bitap_filter.bitap_filter_batch(*empty, **kw)
    assert d.shape == o.shape == (0, 4)


def _meta_inputs(b=4, c=4, cap=160, n=1000):
    return dict(ref_buf=torch.empty(n, dtype=torch.int8, device="meta"),
                starts=torch.empty((b, c), dtype=torch.int64, device="meta"),
                reads=torch.empty((b, cap), dtype=torch.int8, device="meta"),
                read_lens=torch.empty(b, dtype=torch.int64, device="meta"))


BAD = [
    ("ref_int32", TypeError, dict(ref_buf=torch.empty(1000, dtype=torch.int32,
                                                      device="meta")), {}),
    ("reads_int64", TypeError, dict(reads=torch.empty((4, 160), dtype=torch.int64,
                                                      device="meta")), {}),
    ("starts_int32", TypeError, dict(starts=torch.empty((4, 4), dtype=torch.int32,
                                                        device="meta")), {}),
    ("lens_int32", TypeError, dict(read_lens=torch.empty(4, dtype=torch.int32,
                                                         device="meta")), {}),
    ("ref_2d", ValueError, dict(ref_buf=torch.empty((2, 500), dtype=torch.int8,
                                                    device="meta")), {}),
    ("starts_1d", ValueError, dict(starts=torch.empty(16, dtype=torch.int64,
                                                      device="meta")), {}),
    ("lens_rows", ValueError, dict(read_lens=torch.empty(5, dtype=torch.int64,
                                                         device="meta")), {}),
    ("reads_rows", ValueError, dict(reads=torch.empty((3, 160), dtype=torch.int8,
                                                      device="meta")), {}),
    ("reads_narrow", ValueError, dict(reads=torch.empty((4, 100), dtype=torch.int8,
                                                        device="meta")), {}),
    ("devices", ValueError, dict(read_lens=torch.empty(4, dtype=torch.int64)), {}),
    ("bits_160", ValueError, {}, dict(filter_bits=160)),
    ("bits_48", ValueError, {}, dict(filter_bits=48)),
    ("region_0", ValueError, {}, dict(region_len=0)),
    ("k_negative", ValueError, {}, dict(k=-1)),
]


@pytest.mark.parametrize("name,err,tensors,kwargs", BAD, ids=[b[0] for b in BAD])
def test_bad_input_raises_before_the_library_loads(monkeypatch, name, err, tensors,
                                                   kwargs):
    def no_library(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(_build, "library", no_library)
    args = {**_meta_inputs(), **tensors}
    kw = {**dict(filter_bits=128, k=12, region_len=216), **kwargs}
    with pytest.raises(err):
        bitap_filter.bitap_filter_batch(**args, **kw)
    # good input on a device that is not the CPU goes on to the library
    with pytest.raises(AssertionError, match="bitap_filter"):
        bitap_filter.bitap_filter_batch(**_meta_inputs(), filter_bits=128, k=12,
                                        region_len=216)
