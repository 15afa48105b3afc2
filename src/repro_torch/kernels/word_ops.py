"""The card's rate of the GenASM kernels' 32-bit word operations.

The operations bounds (``chip_smoke.py``'s ``*_work`` functions) and the
roofline's ``peak_word_ops`` count operations as the sources write them:
``shl1`` is three, the add with carry five, ``Mv | ~(Xh | Pv)`` three.
The card runs several of them as one instruction, so its instruction
rate is not their rate.  `csrc/word_ops.cu` measures their rate: each
thread runs the DC row recurrence (``"dc"``) or the Myers step
(``"myers"``) on two independent 64-bit windows in registers, with no
memory traffic; its source note says what it counts.  `rate` times one
mix with CUDA events; the larger rate of the two is the card's
``peak_word_ops`` (`repro_torch/obs/device_specs/h100_sxm.json`).

`word_ops_chain` returns each thread's final state, the XOR of its
windows' words as ``[threads]`` int64 in ``[0, 2**32)``: from the kernel
on a CUDA device, from the plain version below on the CPU, so a short run
can be held against the plain version on the card.
"""
from __future__ import annotations

import statistics

import torch

from . import _build

MIXES = ("dc", "myers")
# must equal csrc/word_ops.cu's kNW, kRows, kWindows (`shape` checks)
NW, ROWS, WINDOWS = 2, 4, 2
# ops a thread does a text char, counted as chip_smoke.py's dc_work
# ((4 + 13 k) nw at k = ROWS) and myers_work (23 nw + 7) count them
OPS_PER_CHAR = {"dc": WINDOWS * (4 + 13 * ROWS) * NW,
                "myers": WINDOWS * (23 * NW + 7)}
CIN, OFF = 0, 31  # semiglobal: no bit into Ph's word 0; score bit 63
_M32 = 0xFFFFFFFF


def shape() -> dict:
    """The kernel's compiled constants (builds it on first use)."""
    return _build.geometry(_build.library("word_ops").word_ops_shape,
                           keys=("nw", "rows", "windows", "threads"))


def word_ops_chain(mix: str, n: int, threads: int, *,
                   device="cuda") -> torch.Tensor:
    """Each of ``threads`` threads' final state after ``n`` chars (even):
    the kernel on a CUDA ``device`` (which must be visible), the plain
    version on the CPU."""
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    if n < 0 or n % 2 or threads <= 0:
        raise ValueError(f"need an even n >= 0 and threads > 0, got {n}, "
                         f"{threads}")
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return _plain(mix, n, threads, dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    lib = _build.library("word_ops")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mix == "dc":
        rc = lib.word_ops_dc(out.data_ptr(), threads, n, dev.index, stream)
    else:
        rc = lib.word_ops_myers(out.data_ptr(), threads, n, CIN, OFF,
                                dev.index, stream)
    _build.check(rc, f"word_ops_{mix}")
    return out.long() & _M32


def rate(mix: str, *, device, n: int = 8192, trials: int = 5) -> dict:
    """The ``mix``'s counted ops a second on a CUDA ``device``: the median
    CUDA-event time of ``trials`` launches (after a warm-up) of 2,048
    threads an SM over ``n`` chars."""
    dev = torch.device(device)
    threads = 2048 * torch.cuda.get_device_properties(dev).multi_processor_count
    word_ops_chain(mix, n, threads, device=dev)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        word_ops_chain(mix, n, threads, device=dev)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    ops = threads * n * OPS_PER_CHAR[mix]
    s = statistics.median(times)
    return {"mix": mix, "threads": threads, "chars": n, "ops": ops,
            "ms": s * 1e3, "ops_per_s": ops / s}


# -------------------------------------------------------- plain version ----
def _mix32(t: torch.Tensor, slot: int) -> torch.Tensor:
    x = (t * 0x9E3779B1 + slot * 0x85EBCA77 + 0x165667B1) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 12)


def _shl1(x: list) -> list:
    return [((x[j] << 1) | (x[j - 1] >> 31 if j else 0)) & _M32
            for j in range(len(x))]


def _dc_char(r: list, pm: list) -> None:
    held = r[0]
    r[0] = [s | p for s, p in zip(_shl1(r[0]), pm)]
    for d in range(1, ROWS + 1):
        own = r[d]
        sd, si, sm = _shl1(held), _shl1(r[d - 1]), _shl1(own)
        r[d] = [h & a & b & (c | p)
                for h, a, b, c, p in zip(held, sd, si, sm, pm)]
        held = own


def _myers_char(st: dict, eq: list) -> None:
    carry, phin, mhin = 0, CIN, 0
    pv, mv = st["pv"], st["mv"]
    for j in range(NW):
        xv = eq[j] | mv[j]
        a = eq[j] & pv[j]
        s = (a + pv[j]) & _M32
        c1 = (s < a).long()
        s2 = (s + carry) & _M32
        c2 = (s2 < s).long()
        carry = c1 | c2
        xh = (s2 ^ pv[j]) | eq[j]
        ph = mv[j] | (~(xh | pv[j]) & _M32)
        mh = pv[j] & xh
        if j == NW - 1:
            pb, mb = (ph >> OFF) & 1, (mh >> OFF) & 1
        phs = ((ph << 1) | phin) & _M32
        phin = ph >> 31
        mhs = ((mh << 1) | mhin) & _M32
        mhin = mh >> 31
        pv[j] = mhs | (~(xv | phs) & _M32)
        mv[j] = phs & xv
    st["score"] = st["score"] + pb - mb
    st["best"] = torch.minimum(st["best"], st["score"])


def _plain(mix: str, n: int, threads: int, dev: torch.device) -> torch.Tensor:
    t = torch.arange(threads, dtype=torch.int64, device=dev)
    acc = torch.zeros_like(t)
    for w in range(WINDOWS):
        masks = [[_mix32(t, (w * 2 + p) * NW + j) for j in range(NW)]
                 for p in range(2)]
        if mix == "dc":
            r = [[torch.full_like(t, _M32)] * NW for _ in range(ROWS + 1)]
            for i in range(n):
                _dc_char(r, masks[i % 2])
            words = [x for row in r for x in row]
        else:
            st = {"pv": [torch.full_like(t, _M32)] * NW,
                  "mv": [torch.zeros_like(t)] * NW,
                  "score": torch.full_like(t, NW * 32),
                  "best": torch.full_like(t, NW * 32)}
            for i in range(n):
                _myers_char(st, masks[i % 2])
            words = st["pv"] + st["mv"] + [st["score"] & _M32,
                                           st["best"] & _M32]
        for x in words:
            acc = acc ^ x
    return acc
