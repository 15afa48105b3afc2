"""A CPU model of the warp schedule of the two wavefront CUDA kernels.

`csrc/bitalign.cu` (``bitalign_dc``) and `csrc/genasm_dc.cu`
(``genasm_dc_v1``) run their DC recurrence as a per-row wavefront on a
warp: lane d owns row d and at step s works on node (char) i = N-1-(s-d).
A CUDA kernel has no CPU mode, so this file steps the same schedule in
numpy, warp by warp and lane by lane: at each step a lane sees another
lane's values only as they stood at the end of the previous step (a
shuffle), and it touches shared memory, registers and device memory in
the order the kernel does -- the hop ring of Q slots with the lane
innermost, the node-input chunks, the 16-node write-outs of dists and R,
two graph lanes per warp at k+1 <= 16, row 32 on lane 0 fed from lane 31,
the dists / d_min carried along the rows, and v1's window store in shared
memory.  The model is held bitwise against the plain versions
(`bitalign_rows`, `window_dc_batch_plain`), which the other tests hold
against the JAX package.  Nothing of the package depends on it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.segram.bitalign import bitalign_rows
from repro_torch.kernels import ops
from repro_torch.kernels.genasm_dc import window_dc_batch_plain

LANES = 32
HOPS = 16  # HOP_LIMIT
FLUSH = 16  # kFlush: completed nodes per write-out
MAX_K = 32
ONES = np.uint32(0xFFFFFFFF)
SENTINEL = 0x5A5A5A5A  # what device memory holds before the kernel writes it


def shl1(x: np.ndarray) -> np.ndarray:
    """``[..., nw]`` uint32: shift left by one across words."""
    y = x << np.uint32(1)
    y[..., 1:] |= x[..., :-1] >> np.uint32(31)
    return y


def shfl_up(v: np.ndarray, width: int) -> np.ndarray:
    """``__shfl_up_sync(v, 1, width)`` over axis 1 (the lanes): a segment's
    first lane keeps its own value."""
    lane = np.arange(LANES)
    return v[:, np.where(lane % width == 0, lane, lane - 1)]


def shfl(v: np.ndarray, src: int, width: int) -> np.ndarray:
    """``__shfl_sync(v, src, width)`` over axis 1."""
    lane = np.arange(LANES)
    return v[:, (lane // width) * width + src]


def ballot(pred: np.ndarray) -> np.ndarray:
    """``__ballot_sync`` of ``[warps, 32]`` predicates -> ``[warps]`` uint32."""
    return (pred.astype(np.uint64) << np.arange(LANES, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def first_set(mask: np.ndarray) -> np.ndarray:
    """``__ffs(mask) - 1`` per entry (-1 where the mask is 0)."""
    bits = (mask[:, None] >> np.arange(LANES, dtype=np.uint32)) & 1
    return np.where(mask != 0, bits.argmax(-1), -1)


def select_pm(pm: np.ndarray, c: np.ndarray) -> np.ndarray:
    """PM[c] from ``pm [..., 5, nw]`` for chars ``c [...]``; 0 outside 0..4."""
    ok = (c >= 0) & (c <= 4)
    got = np.take_along_axis(pm, np.where(ok, c, 0)[..., None, None], -2)[..., 0, :]
    return np.where(ok[..., None], got, np.uint32(0))


def lane_masks(pats: np.ndarray, lane_row: np.ndarray, nw: int) -> np.ndarray:
    """The ballots that build PM: ``pats [rows, M]``, ``lane_row [warps]``
    -> ``[warps, 5, nw]``, lane t supplying bit t of each word."""
    m = nw * 32
    out = np.zeros((len(lane_row), 5, nw), np.uint32)
    for j in range(nw):
        p = pats[lane_row][:, m - 1 - (32 * j + np.arange(LANES))]
        for c in range(5):
            out[:, c, j] = ballot(~((p == c) | (p == 4)))
    return out


# --------------------------------------------------------------- BitAlign ----
def bitalign_geometry(k: int, store_r: bool):
    """(group width G, ring depth Q, ring columns) as `geometry()` picks them."""
    group = 16 if k + 1 <= 16 else 32
    ring = HOPS if not store_r else (32 if k + FLUSH <= 32 else 64)
    return group, ring, LANES + (k == MAX_K)


def bitalign_wavefront(bases, succ, pats, p_lens, *, m_bits: int, k: int,
                       store_r: bool):
    """``bitalign_wave`` step by step: returns ``(dists [B, N] int32, R [B,
    N, k+1, nw] int32 or None)`` as the kernel writes them."""
    b_rows, n = bases.shape
    nw, rows = m_bits // 32, k + 1
    G, Q, cols = bitalign_geometry(k, store_r)
    groups, qmask, extra = LANES // G, Q - 1, k == MAX_K
    n_warps = -(-b_rows // groups)
    lane = np.arange(LANES)
    g, d = lane // G, lane % G
    b = np.arange(n_warps)[:, None] * groups + g  # [W, 32]
    bl = np.minimum(b, b_rows - 1)  # a dead group runs a live row
    warps = np.arange(n_warps)

    pad = m_bits - p_lens.astype(np.int64)[bl]
    below = np.clip(pad[..., None] - 32 * np.arange(nw), 0, 32)
    tail = np.where(below >= 32, 0, 0xFFFFFFFF ^ ((1 << below) - 1)).astype(np.uint32)
    pm = np.zeros((n_warps, LANES, 5, nw), np.uint32)
    for gg in range(groups):
        masks = lane_masks(pats, np.minimum(warps * groups + gg, b_rows - 1), nw)
        pm[:, g == gg] = masks[:, None]

    ring = np.empty((n_warps, Q, nw, cols), np.uint32)  # [slot][word][column]
    ring[..., :LANES] = tail.transpose(0, 2, 1)[:, None]
    if extra:
        ring[..., LANES] = tail[:, None, 0, :]
    dstage = np.zeros((n_warps, groups, FLUSH), np.int64)

    packed = ((succ.astype(np.int64) & 0xFFFF)
              | (bases.astype(np.int64).astype(np.uint8).astype(np.int64) << 16))

    def load_node(step):  # [32] steps -> [W, 32] packed node inputs
        i = n - 1 - step
        return np.where(i >= 0, packed[bl, np.maximum(i, 0)], 0)

    def row_step(col, i, node, first, in_comb, in_r, in_dm, drow):
        """Lanes ``col``: ``i``, ``first``, ``drow`` ``[L]``; the rest
        ``[W, L, ...]``.  Writes R to the ring; returns ``(comb, R, dm)``."""
        owner = np.where(col == LANES, 0, col)  # row 32's column is lane 0's
        tl = tail[:, owner]
        comb = tl.copy()
        for h in range(HOPS):  # the __ffs walk; AND is order-free
            use = ((node >> h) & 1).astype(bool)
            src = ring[:, (i + 1 + h) & qmask, :, col].transpose(1, 0, 2)
            comb = np.where(use[..., None], comb & src, comb)
        c = ((node >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
        m = shl1(comb) | select_pm(pm[:, owner], c)
        r = np.where(first[None, :, None], m & tl,
                     in_comb & shl1(in_comb) & shl1(in_r) & m & tl)
        ring[:, i & qmask, :, col] = r.transpose(1, 0, 2)
        msb0 = (r[..., -1] >> 31) == 0
        dm = np.where(first, np.where(msb0, 0, k + 1),
                      np.where(in_dm <= k, in_dm, np.where(msb0, drow, k + 1)))
        return comb, r, dm

    dists = np.full((b_rows, n), SENTINEL, np.int64)
    r_out = np.full((b_rows, n, rows, nw), SENTINEL, np.uint32) if store_r else None
    o_comb = np.zeros((n_warps, LANES, nw), np.uint32)
    o_r = np.zeros_like(o_comb)
    o_dm = np.zeros((n_warps, LANES), np.int64)
    o_node = np.zeros((n_warps, LANES), np.int64)
    nxt, cur = load_node(d), None
    for s in range(n + k):
        if s % G == 0:
            cur, nxt = nxt, load_node(s + G + d)
        # every shuffle reads the values of the end of step s-1
        in_comb, in_r = shfl_up(o_comb, G), shfl_up(o_r, G)
        in_dm, up_node = shfl_up(o_dm, G), shfl_up(o_node, G)
        node = np.where(d == 0, shfl(cur, s % G, G), up_node)
        x_comb, x_r = o_comb[:, 31:32].copy(), o_r[:, 31:32].copy()
        x_dm, x_node = o_dm[:, 31:32].copy(), o_node[:, 31:32].copy()

        i = n - 1 - s + d
        act = (d <= k) & (i >= 0) & (i < n)
        if act.any():
            col = lane[act]
            comb, r, dm = row_step(col, i[act], node[:, act], d[act] == 0,
                                   in_comb[:, act], in_r[:, act], in_dm[:, act],
                                   d[act])
            o_comb[:, act], o_r[:, act], o_dm[:, act] = comb, r, dm
            o_node[:, act] = node[:, act]
            last = act & (d == k)
            for L in lane[last]:
                dstage[:, g[L], i[L] % FLUSH] = o_dm[:, L]
        i32 = n - 1 - s + MAX_K
        if extra and 0 <= i32 < n:
            _, _, dm32 = row_step(np.array([LANES]), np.array([i32]), x_node,
                                  np.array([False]), x_comb, x_r, x_dm,
                                  np.array([MAX_K]))
            dstage[:, 0, i32 % FLUSH] = dm32[:, 0]

        ic = n - 1 - s + k  # the node the last row finished this step
        if 0 <= ic < n and ic % FLUSH == 0:
            cnt = min(FLUSH, n - ic)
            for gg in range(groups):
                bb = warps * groups + gg
                live = bb < b_rows
                dists[bb[live], ic:ic + cnt] = dstage[live, gg, :cnt]
                if store_r:
                    slots = (ic + np.arange(cnt)) & qmask
                    rr = np.arange(rows)
                    colsel = np.where(rr < LANES, gg * G + rr, LANES)
                    vals = ring[:, slots[:, None], :, colsel[None, :]]
                    r_out[bb[live], ic:ic + cnt] = vals.transpose(2, 0, 1, 3)[live]
    return (dists.astype(np.int32),
            None if r_out is None else r_out.view(np.int32))


KS = (0, 11, 15, 16, 24, 31, 32)


@pytest.mark.parametrize("nw", (1, 2, 3, 4))
@pytest.mark.parametrize("k", KS)
def test_bitalign_wavefront_matches_plain(k, nw):
    """Ragged B, short p_lens, dense hops (hops past N included), bases
    outside 0..4, N past the deepest ring: with R and without."""
    rng = np.random.default_rng(1000 * k + nw)
    m_bits = 32 * nw
    args, _ = ops.bitalign_inputs(rng, "cpu", b=5, n=90, m_bits=m_bits, k=k,
                                  short=True, hop_rate=0.3)
    bases = args[0].numpy().copy()
    bases[rng.random(bases.shape) < 0.05] = 7
    bases[rng.random(bases.shape) < 0.05] = -3
    args = (torch.from_numpy(bases),) + args[1:]
    np_args = [a.numpy() for a in args]
    want_d, want_r = bitalign_rows(*args, m_bits=m_bits, k=k, store_r=True)
    got_d, got_r = bitalign_wavefront(*np_args, m_bits=m_bits, k=k, store_r=True)
    np.testing.assert_array_equal(got_d, want_d.numpy())
    np.testing.assert_array_equal(got_r, want_r.numpy())
    got_d, got_r = bitalign_wavefront(*np_args, m_bits=m_bits, k=k, store_r=False)
    assert got_r is None
    np.testing.assert_array_equal(got_d, want_d.numpy())


@pytest.mark.parametrize("b,n,k,store_r", [(37, 200, 11, False),
                                           (9, 40, 24, True), (3, 1, 32, True)])
def test_bitalign_wavefront_served_density(b, n, k, store_r):
    """The filter's k at the served graph's hop density over many write-outs;
    a partial first write-out; a one-node graph at k = 32."""
    rng = np.random.default_rng(b + n + k)
    args, _ = ops.bitalign_inputs(rng, "cpu", b=b, n=n, m_bits=128, k=k)
    want_d, want_r = bitalign_rows(*args, m_bits=128, k=k, store_r=store_r)
    got_d, got_r = bitalign_wavefront(*(a.numpy() for a in args), m_bits=128,
                                      k=k, store_r=store_r)
    np.testing.assert_array_equal(got_d, want_d.numpy())
    if store_r:
        np.testing.assert_array_equal(got_r, want_r.numpy())


# ------------------------------------------------------------ GenASM-DC v1 ----
def dc_v1_wavefront(texts, pats, *, w: int, k: int):
    """``dc_wave_v1`` step by step, one window per warp: returns ``(d_min
    [B] int32, tb [B, w, k+1, 3, nw] int32)`` as the kernel writes them."""
    b_rows = texts.shape[0]
    nw, rows, extra = w // 32, k + 1, k == MAX_K
    lane = np.arange(LANES)
    warps = np.arange(b_rows)
    pm = lane_masks(pats, warps, nw)  # [W, 5, nw], the same in every lane
    st = np.full((b_rows, w, rows, 3, nw), SENTINEL, np.uint32)  # shared memory
    own = np.full((b_rows, LANES, nw), ONES)  # R_old[d], then R_new[d]
    held = own.copy()  # R_old[d-1]
    own32, held32 = own[:, :1].copy(), own[:, :1].copy()  # row 32 on lane 0

    def v1_row(i, drow, first, own_, held_, in_):
        """Lanes ``[L]`` at chars ``i [L]``; state ``[W, L, nw]`` updated in
        place; (M, I, D) into the window store."""
        c = texts[:, i].astype(np.int64)
        m = shl1(own_) | select_pm(np.broadcast_to(pm[:, None], own_.shape[:2] + pm.shape[1:]), c)
        f = first[None, :, None]
        ins = np.where(f, ONES, shl1(in_))
        dd = np.where(f, ONES, held_)
        st[:, i, drow] = np.stack([m, ins, dd], axis=-2)
        new = np.where(f, m, held_ & shl1(held_) & ins & m)
        return new, np.where(f, held_, in_)

    for s in range(w + k):
        inn = shfl_up(own, LANES)
        in32 = own[:, 31:32].copy()
        i = w - 1 - s + lane
        act = (lane <= k) & (i >= 0) & (i < w)
        if act.any():
            own[:, act], held[:, act] = v1_row(i[act], lane[act], lane[act] == 0,
                                               own[:, act], held[:, act],
                                               inn[:, act])
        i32 = w - 1 - s + MAX_K
        if extra and 0 <= i32 < w:
            own32, held32 = v1_row(np.array([i32]), np.array([MAX_K]),
                                   np.array([False]), own32, held32, in32)

    zero = ballot((lane <= k) & ((own[..., -1] >> 31) == 0))
    zero32 = extra & ((own32[:, 0, -1] >> 31) == 0)
    d_min = np.where(zero != 0, first_set(zero), np.where(zero32, MAX_K, k + 1))
    return d_min.astype(np.int32), st.view(np.int32)


@pytest.mark.parametrize("nw", (1, 2, 3, 4))
@pytest.mark.parametrize("k", KS)
def test_dc_v1_wavefront_matches_plain(k, nw):
    rng = np.random.default_rng(2000 * k + nw)
    w = 32 * nw
    (texts, pats), _ = ops.window_inputs(rng, "cpu", b=5, w=w, k=k)
    want_d, want_tb = window_dc_batch_plain(texts, pats, w=w, k=k)
    got_d, got_tb = dc_v1_wavefront(texts.numpy(), pats.numpy(), w=w, k=k)
    np.testing.assert_array_equal(got_d, want_d.numpy())
    np.testing.assert_array_equal(got_tb, want_tb.numpy())
