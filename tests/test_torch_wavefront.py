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

from repro_torch.core.myers import myers_distance_batch as myers_plain
from repro_torch.core.segram.bitalign import bitalign_rows
from repro_torch.kernels import ops
from repro_torch.kernels.genasm_dc import window_dc_batch_plain
from repro_torch.kernels.genasm_dc_v2 import window_dc_batch_v2_plain

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


# ------------------------------------------------------------- GenASM-DC ----
SMEM_OPTIN = 232_448  # kSmemOptin: dynamic shared memory a block


def dc_window_words(r_only: bool, w: int, k: int) -> int:
    """`window_words`: v1 (M, I, D) [w][k+1][3][nw], v2 R [w+1][k+1][nw]."""
    nw = w // 32
    return (w + 1) * (k + 1) * nw if r_only else w * (k + 1) * 3 * nw


def dc_windows_a_block(r_only: bool, w: int, k: int) -> int:
    """`geometry()`'s windows a block: 1 for v1, up to 4 for v2."""
    words = dc_window_words(r_only, w, k)
    p = 4 if r_only else 1
    while p > 1 and p * (w + 4 * words) + (12 if r_only else 0) > SMEM_OPTIN:
        p -= 1
    return p


def dc_wavefront(texts, pats, *, w: int, k: int, r_only: bool):
    """``dc_wave`` step by step, one window per warp: returns ``(d_min [B]
    int32, st [B, ...] uint32)``, each window's store as the warp leaves
    it in shared memory -- (M, I, D) ``[w, k+1, 3, nw]`` for v1, R ``[w+1,
    k+1, nw]`` with the all-ones row i = w for v2."""
    b_rows = texts.shape[0]
    nw, rows, extra = w // 32, k + 1, k == MAX_K
    lane = np.arange(LANES)
    warps = np.arange(b_rows)
    pm = lane_masks(pats, warps, nw)  # [W, 5, nw], the same in every lane
    shape = (w + 1, rows, nw) if r_only else (w, rows, 3, nw)
    st = np.full((b_rows,) + shape, SENTINEL, np.uint32)  # shared memory
    if r_only:
        st[:, w] = ONES  # the boundary row
    own = np.full((b_rows, LANES, nw), ONES)  # R_old[d], then R_new[d]
    held = own.copy()  # R_old[d-1]
    own32, held32 = own[:, :1].copy(), own[:, :1].copy()  # row 32 on lane 0

    def dc_row(i, drow, first, own_, held_, in_):
        """Lanes ``[L]`` at chars ``i [L]``; state ``[W, L, nw]`` updated in
        place; the row's part of the window store."""
        c = texts[:, i].astype(np.int64)
        m = shl1(own_) | select_pm(np.broadcast_to(pm[:, None], own_.shape[:2] + pm.shape[1:]), c)
        f = first[None, :, None]
        ins = np.where(f, ONES, shl1(in_))
        dd = np.where(f, ONES, held_)
        new = np.where(f, m, held_ & shl1(held_) & ins & m)
        st[:, i, drow] = new if r_only else np.stack([m, ins, dd], axis=-2)
        return new, np.where(f, held_, in_)

    for s in range(w + k):
        inn = shfl_up(own, LANES)
        in32 = own[:, 31:32].copy()
        i = w - 1 - s + lane
        act = (lane <= k) & (i >= 0) & (i < w)
        if act.any():
            own[:, act], held[:, act] = dc_row(i[act], lane[act], lane[act] == 0,
                                               own[:, act], held[:, act],
                                               inn[:, act])
        i32 = w - 1 - s + MAX_K
        if extra and 0 <= i32 < w:
            own32, held32 = dc_row(np.array([i32]), np.array([MAX_K]),
                                   np.array([False]), own32, held32, in32)

    zero = ballot((lane <= k) & ((own[..., -1] >> 31) == 0))
    zero32 = extra & ((own32[:, 0, -1] >> 31) == 0)
    d_min = np.where(zero != 0, first_set(zero), np.where(zero32, MAX_K, k + 1))
    return d_min.astype(np.int32), st


def dc_write_out(st, *, windows: int, r_only: bool) -> np.ndarray:
    """The blocks' write-out of the window stores ``st [B, ...]``, P =
    ``windows`` a block, into device memory: each block lays its P stores
    in shared memory at the word offset (region start) mod 4, then writes a
    head of up to 3 words, a body of 16-byte stores -- asserted aligned on
    both sides -- and a tail.  Returns device memory, ``st``'s shape."""
    b_rows = st.shape[0]
    words = st[0].size
    flat = np.full(b_rows * words, SENTINEL, np.uint32)
    for blk in range(-(-b_rows // windows)):
        s0 = blk * windows * words
        nwin = min(windows, b_rows - blk * windows)
        total = nwin * words
        pad = s0 % 4 if r_only else 0
        smem = np.full(pad + windows * words, SENTINEL, np.uint32)
        smem[pad:pad + total] = st[blk * windows:blk * windows + nwin].ravel()
        head = min((4 - pad) % 4, total)
        body = (total - head) // 4
        flat[s0:s0 + head] = smem[pad:pad + head]
        if body:
            assert (s0 + head) % 4 == 0 and (pad + head) % 4 == 0
        for x in range(body):  # one uint4 each
            g, sm = s0 + head + 4 * x, pad + head + 4 * x
            flat[g:g + 4] = smem[sm:sm + 4]
        rest = head + 4 * body
        flat[s0 + rest:s0 + total] = smem[pad + rest:pad + total]
    return flat.reshape(st.shape)


def dc_v1_wavefront(texts, pats, *, w: int, k: int):
    """``dc_wave_v1``: ``(d_min [B] int32, tb [B, w, k+1, 3, nw] int32)``
    as the kernel writes them."""
    d_min, st = dc_wavefront(texts, pats, w=w, k=k, r_only=False)
    return d_min, dc_write_out(st, windows=1, r_only=False).view(np.int32)


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


@pytest.mark.parametrize("nw", (1, 2, 3, 4))
@pytest.mark.parametrize("k", (0, 11, 24, 31, 32))
def test_dc_v2_wavefront_matches_plain(k, nw):
    """v2's schedule with its R store and boundary row, written out by
    blocks of the geometry's windows (4, or 3 at w = 128 from k = 28) and of 1
    and 3 windows, whose regions start at odd words where (w+1)(k+1)nw is
    odd; b = 7 leaves a ragged last block."""
    rng = np.random.default_rng(3000 * k + nw)
    w = 32 * nw
    (texts, pats), _ = ops.window_inputs(rng, "cpu", b=7, w=w, k=k)
    want_d, want_r = window_dc_batch_v2_plain(texts, pats, w=w, k=k)
    got_d, st = dc_wavefront(texts.numpy(), pats.numpy(), w=w, k=k, r_only=True)
    np.testing.assert_array_equal(got_d, want_d.numpy())
    assert dc_windows_a_block(True, w, k) == (3 if w == 128 and k >= 28 else 4)
    for windows in (dc_windows_a_block(True, w, k), 1, 3):
        got_r = dc_write_out(st, windows=windows, r_only=True)
        np.testing.assert_array_equal(got_r.view(np.int32), want_r.numpy())


# ------------------------------------------------------------------ Myers ----
M32 = 0xFFFFFFFF
SINGLE_MAX_S, PIPE_S, MAX_WARPS = 10, 10, 32


def myers_launch(nw: int, single_max_s: int = SINGLE_MAX_S,
                 pipe_s: int = PIPE_S):
    """(words a lane S, lanes a pair, warps a pair G) as `pick` chooses
    them; smaller limits force the pipeline at small nw."""
    if nw <= 32 * single_max_s:
        s = -(-nw // 32)
        width = 1
        while width < -(-nw // s):
            width *= 2
        return s, width, 1
    return pipe_s, LANES, -(-nw // (32 * pipe_s))


def myers_schedule(texts, pats, m_lens, *, m_bits: int, mode: str, s: int,
                   width: int, g: int, slots: int = 2):
    """``myers_lanes`` (g = 1: one pair per ``width`` lanes) or
    ``myers_pipe`` (g warps a pair) step by step: lane l of a pair holds
    words [l s, l s + s) (warp gg: lanes 32 gg + l), a single ballot pair
    resolves the lanes' carries, one shuffle shifts the (Ph, Mh) top bits,
    and in the pipeline warp gg works on char st - gg at step st, handing
    its carry out and top bits to warp gg + 1 through a ring of ``slots``
    slots; within a step the warps run in order 0 .. g-1.  Returns ``[B]``
    int32 as the kernel writes it."""
    b_rows, n = texts.shape
    nw = m_bits // 32
    lane = np.arange(LANES)
    texts = texts.astype(np.int64)
    if g == 1:
        per = LANES // width
        units = -(-b_rows // per)
        pair = np.arange(units)[:, None] * per + lane // width  # [U, 32]
    else:
        units = b_rows
        pair = np.repeat(np.arange(units)[:, None], LANES, 1)
    row = np.minimum(pair, b_rows - 1)
    ls = lane % width  # lane in its pair's segment (one segment a warp: 32)
    span = width * s if g == 1 else LANES * s  # words a warp (segment)
    # the top lane of a pair that shares its warp: its carry out is dropped
    top_lane = (ls == width - 1) & (width < LANES)

    # PEq[row][c][word], zero at and above nw
    padded = np.full((b_rows, g * span * 32), -1, np.int64)
    padded[:, :m_bits] = pats
    bits = padded.reshape(b_rows, -1, 32)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    peq = np.stack([(((bits == c) | (bits == 4)).astype(np.uint64) * weights)
                    .sum(-1) for c in range(5)], 1)  # [B, 5, words]

    m_len = m_lens.astype(np.int64)[row]  # [U, 32]
    has = (m_len >= 1) & (m_len <= m_bits)
    sw = np.where(has, (m_len - 1) // 32, -1)
    off = np.where(has, (m_len - 1) % 32, 0)
    t0 = np.where(has, sw % s, 0)
    score = np.repeat(m_len[:, None], g, 1)  # [U, G, 32]: each lane's own
    best = score.copy()
    out = np.full(b_rows, SENTINEL, np.int64)

    pv = np.full((units, g, LANES, s), M32, np.uint64)
    mv = np.zeros_like(pv)
    chunk = np.zeros((units, g, LANES), np.int64)  # TextStream, per warp
    nxt = np.zeros_like(chunk)

    def load(j):  # [U, 32]: lane's text char j + ls (past the end: the last)
        return texts[row, np.minimum(j + ls, n - 1)]

    for gg in range(g):
        chunk[:, gg], nxt[:, gg] = load(0), load(width)

    def text_at(gg, j):  # `TextStream::at`, for j = 0, 1, ... in order
        q = j & (width - 1)
        if q == 0 and j > 0:
            chunk[:, gg] = nxt[:, gg]
            nxt[:, gg] = load(j + width)
        return shfl(chunk[:, gg], q, width)

    def warp_char(gg, j, cin, in_bits):
        """Warp gg on char j; cin [U], in_bits [U]: into the warp's lane 0
        (g > 1) or every segment's first lane (g = 1).  Returns the top
        lane's (carry | Ph top << 1 | Mh top << 2) [U]."""
        c = text_at(gg, j)
        word = (gg * LANES + lane)[None, :, None] * s + np.arange(s) if g > 1 \
            else (ls[:, None] * s + np.arange(s))[None]
        word = np.broadcast_to(word, (units, LANES, s))
        known = (c >= 0) & (c <= 4)
        eq = np.where(known[..., None],
                      peq[row[..., None], np.where(known, c, 0)[..., None], word],
                      np.uint64(0))
        P, Mv = pv[:, gg], mv[:, gg]
        carry = np.zeros((units, LANES), np.uint64)
        sum0 = np.empty_like(P)
        for t in range(s):  # the add.cc / addc chain
            tot = (eq[..., t] & P[..., t]) + P[..., t] + carry
            sum0[..., t], carry = tot & M32, tot >> np.uint64(32)
        live = (word[..., 0] < nw) & ~top_lane
        gen = ballot(live & (carry == 1)).astype(np.uint64)
        prop = ballot(live & (np.bitwise_and.reduce(sum0, -1) == M32)
                      ).astype(np.uint64)
        x = gen | prop
        cmask = ((x + gen + cin) & M32) ^ x ^ gen
        cout = ((gen >> 31) | ((prop >> 31) & (cmask >> 31))) & 1
        carry = (cmask[:, None] >> lane.astype(np.uint64)) & 1
        sm = np.empty_like(P)
        for t in range(s):  # add the lane's carry in
            tot = sum0[..., t] + carry
            sm[..., t], carry = tot & M32, tot >> np.uint64(32)
        xh = (sm ^ P) | eq
        ph = Mv | (~(xh | P) & M32)
        mh = P & xh
        top = (ph[..., -1] >> 31) | ((mh[..., -1] >> 31) << 1)
        up = shfl_up(top, width)
        up = np.where(ls == 0, in_bits[:, None], up)
        ph_in = np.concatenate([(up & 1)[..., None], ph[..., :-1] >> 31], -1)
        mh_in = np.concatenate([(up >> 1)[..., None], mh[..., :-1] >> 31], -1)
        phs = ((ph << 1) & M32) | ph_in
        mhs = ((mh << 1) & M32) | mh_in
        xv = eq | Mv
        pv[:, gg] = mhs | (~(xv | phs) & M32)
        mv[:, gg] = phs & xv
        # the score, kept by the lane that owns word sw
        owner = has & (word[..., 0] // s * s == sw - t0) & (
            (sw // span == gg) if g > 1 else True)
        pick = np.take_along_axis(ph, t0[..., None].astype(np.int64), -1)[..., 0]
        mpick = np.take_along_axis(mh, t0[..., None].astype(np.int64), -1)[..., 0]
        step = ((pick >> off.astype(np.uint64)) & 1).astype(np.int64) \
            - ((mpick >> off.astype(np.uint64)) & 1).astype(np.int64)
        score[:, gg] += np.where(owner, step, 0)
        best[:, gg] = np.minimum(best[:, gg], score[:, gg])
        return cout | (top[:, LANES - 1] << 1)

    in0 = np.full(units, 1 if mode == "global" else 0, np.uint64)
    zero = np.zeros(units, np.uint64)
    if g == 1:
        for j in range(n):
            warp_char(0, j, zero, in0)
    else:
        ring = np.zeros((units, slots, g), np.uint64)
        for st in range(n + g - 1):
            for gg in range(g):
                j = st - gg
                if not 0 <= j < n:
                    continue
                if gg == 0:
                    packed = in0 << 1
                else:
                    packed = ring[:, (st - 1) % slots, gg - 1]
                handed = warp_char(gg, j, packed & 1, packed >> 1)
                if gg + 1 < g:
                    ring[:, st % slots, gg] = handed

    word0 = (np.arange(g)[:, None] * LANES + lane) * s if g > 1 else ls * s
    for u in range(units):
        for gg in range(g):
            for ll in range(LANES):
                p = pair[u, ll]
                w0 = word0[gg, ll] if g > 1 else word0[ll]
                mine = (sw[u, ll] >= 0 and w0 <= sw[u, ll] < w0 + s) or (
                    sw[u, ll] < 0 and w0 == 0)
                if mine and p < b_rows:
                    assert out[p] == SENTINEL, "two lanes write one pair"
                    out[p] = score[u, gg, ll] if mode == "global" \
                        else best[u, gg, ll]
    assert (out != SENTINEL).all()
    return out.astype(np.int32)


def myers_pairs(rng, m_bits: int, n: int, m_lens):
    """ACGT patterns of the given lengths (wildcard tail) and texts that
    copy them with 10% substitutions, over A, C, G, T and the sentinel."""
    b = len(m_lens)
    pats = rng.integers(0, 4, size=(b, m_bits)).astype(np.int8)
    pats[np.arange(m_bits)[None] >= np.asarray(m_lens)[:, None]] = 4
    texts = rng.integers(0, 5, size=(b, n)).astype(np.int8)
    keep = min(n, m_bits)
    texts[:, :keep] = np.where(rng.random((b, keep)) < 0.9,
                               np.minimum(pats[:, :keep], 3), texts[:, :keep])
    return texts, pats, np.asarray(m_lens, np.int32)


def edge_lens(m_bits: int, s: int, span: int):
    """m_len 0, 1 and m_bits, and the first and last bit of the words on
    either side of a lane edge (s-1, s) and a warp edge (span-1, span)."""
    nw = m_bits // 32
    words = [w for w in (s - 1, s, span - 1, span, nw - 1) if 0 <= w < nw]
    return [0, 1, m_bits] + [32 * w + d for w in words for d in (1, 32)]


def check_myers(m_bits, n, mode, launch, seed, slots=2):
    """The schedule against the plain version.  Only a text longer than
    a lane or warp edge's bit position moves the bits that cross that
    edge, so the callers run texts past the pattern's end."""
    s, width, g = launch
    lens = edge_lens(m_bits, s, (width if g == 1 else LANES) * s)
    rng = np.random.default_rng(seed)
    lens = lens + list(rng.integers(0, m_bits + 1, size=5))  # ragged B
    texts, pats, m_lens = myers_pairs(rng, m_bits, n, lens)
    want = myers_plain(torch.from_numpy(texts), torch.from_numpy(pats),
                       torch.from_numpy(m_lens), m_bits=m_bits, mode=mode)
    got = myers_schedule(texts, pats, m_lens, m_bits=m_bits, mode=mode,
                         s=s, width=width, g=g, slots=slots)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("mode", ("global", "semiglobal"))
@pytest.mark.parametrize("m_bits", (32, 64, 96, 160, 1024, 1056, 2080))
def test_myers_lanes_schedule_matches_plain(m_bits, mode):
    """The launch `pick` makes up to 10,240 bits: several pairs a warp up
    to 16 words (m_bits 32-160), one a warp beyond, partial last lanes."""
    launch = myers_launch(m_bits // 32)
    assert launch[2] == 1
    check_myers(m_bits, m_bits + 40, mode, launch, m_bits)


@pytest.mark.parametrize("mode", ("global", "semiglobal"))
@pytest.mark.parametrize("m_bits,limit,n", [
    (1056, 1, 1096), (2048, 1, 2088), (2080, 1, 2120), (2112, 2, 2152),
    (3104, 1, 3144), (4160, 2, 4200), (10272, 10, 40)])
def test_myers_pipeline_schedule_matches_plain(m_bits, limit, n, mode):
    """The warp pipeline, forced at small nw by a small words-a-lane limit
    (2, 3 and 4 warps of 1 word a lane, 2 and 3 of 2, the last warp with
    one live lane), texts past the warp edges;
    and `pick`'s own first pipeline (10,272 bits: 2 warps of 10 words a
    lane) on a short text, whose edge bits stay still.  The score word
    on lane and warp edges."""
    launch = myers_launch(m_bits // 32, single_max_s=limit, pipe_s=limit)
    assert launch[2] > 1
    check_myers(m_bits, n, mode, launch, m_bits + limit)
