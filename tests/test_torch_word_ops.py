"""The word-op rate kernel (`csrc/word_ops.cu`) and its plain version.

The kernel measures the card's ``peak_word_ops``, so what it runs must
be the work the operations bounds count.  On the CPU: the plain version
equals a scalar model that runs each 64-bit window as one Python int
(``shl1`` a 64-bit shift, the Myers add one 64-bit add), and its ops a
char equal what `chip_smoke.py` counts for the same work.  On a card
(skipped without one): the kernel equals the plain version bit for bit.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import word_ops

ROOT = Path(__file__).resolve().parents[1]
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
W_BITS = 32 * word_ops.NW


def _mix32(t: int, slot: int) -> int:
    x = (t * 0x9E3779B1 + slot * 0x85EBCA77 + 0x165667B1) & M32
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 12)


def _window(t: int, slot0: int) -> int:
    """A 64-bit window of seeded words: word j holds bits 32 j .. 32 j + 31."""
    return sum(_mix32(t, slot0 + j) << (32 * j) for j in range(word_ops.NW))


def _words(x: int) -> list[int]:
    return [(x >> (32 * j)) & M32 for j in range(word_ops.NW)]


def _scalar(mix: str, n: int, t: int) -> int:
    """Thread ``t``'s final state, each window one integer."""
    ones, acc = (1 << W_BITS) - 1, 0
    for w in range(word_ops.WINDOWS):
        masks = [_window(t, (w * 2 + p) * word_ops.NW) for p in range(2)]
        if mix == "dc":
            r = [ones] * (word_ops.ROWS + 1)
            for i in range(n):
                pm, old = masks[i % 2], list(r)
                r[0] = ((old[0] << 1) & ones) | pm
                for d in range(1, word_ops.ROWS + 1):
                    r[d] = (old[d - 1] & ((old[d - 1] << 1) & ones)
                            & ((r[d - 1] << 1) & ones)
                            & (((old[d] << 1) & ones) | pm))
            words = [x for row in r for x in _words(row)]
        else:
            pv, mv = ones, 0
            score = best = W_BITS
            top = W_BITS - 32 + word_ops.OFF
            for i in range(n):
                eq = masks[i % 2]
                xv = eq | mv
                xh = ((((eq & pv) + pv) & ones) ^ pv) | eq
                ph = mv | (~(xh | pv) & ones)
                mh = pv & xh
                score += ((ph >> top) & 1) - ((mh >> top) & 1)
                best = min(best, score)
                ph = ((ph << 1) | word_ops.CIN) & ones
                mh = (mh << 1) & ones
                pv = mh | (~(xv | ph) & ones)
                mv = ph & xv
            words = _words(pv) + _words(mv) + [score & M32, best & M32]
        for x in words:
            acc ^= x
    return acc


@pytest.mark.parametrize("n", [0, 2, 16, 40])
@pytest.mark.parametrize("mix", word_ops.MIXES)
def test_plain_chain_matches_scalar_windows(mix, n):
    threads = 37
    got = word_ops.word_ops_chain(mix, n, threads, device="cpu").tolist()
    assert got == [_scalar(mix, n, t) for t in range(threads)]


def test_ops_per_char_are_chip_smokes_counts():
    """The rate's ops a char are what `chip_smoke.py`'s bound counts for
    one char of the same windows: dc_work at k = ROWS, myers_work at
    m_bits = 64."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    one = SimpleNamespace(shape=(1, 1))
    w = W_BITS
    _, dc_ops = chip_smoke.dc_work(
        "window_dc_batch_v2", (SimpleNamespace(shape=(1, w)),),
        {"w": w, "k": word_ops.ROWS})
    _, myers_ops = chip_smoke.myers_work((one, None, None), {"m_bits": w})
    assert word_ops.OPS_PER_CHAR == {
        "dc": word_ops.WINDOWS * dc_ops // w,
        "myers": word_ops.WINDOWS * myers_ops}


@pytest.mark.parametrize("mix,n,threads", [("dc", 3, 4), ("myers", -2, 4),
                                           ("dc", 2, 0), ("lop3", 2, 4)])
def test_bad_arguments_raise(mix, n, threads):
    with pytest.raises(ValueError):
        word_ops.word_ops_chain(mix, n, threads, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", word_ops.MIXES)
def test_kernel_matches_plain_on_card(cuda_device, mix):
    assert word_ops.shape() == {"nw": word_ops.NW, "rows": word_ops.ROWS,
                                "windows": word_ops.WINDOWS, "threads": 256}
    for n, threads in ((16, 1000), (64, 256)):
        got = word_ops.word_ops_chain(mix, n, threads, device=cuda_device)
        want = word_ops.word_ops_chain(mix, n, threads, device="cpu")
        assert torch.equal(got.cpu(), want)
