"""The work a kernel's algorithm must do, and the card's least time for it.

Counts come from the algorithm's shapes alone, for the windows and rows
a batch launched: each input byte read once, each output byte written
once, and the 32-bit word operations of the recurrence.  They do not
depend on the kernel that implements the work, its launch geometry or
how many launches it takes, so a faster implementation raises its share
of the roofline and never its count.

Word operations are counted as the peak in ``peaks.json`` was measured:
a ``shl1`` of a word is three (shift, carry shift, OR), an AND or OR one.
"""
from __future__ import annotations

import json
from pathlib import Path

WORD_BITS = 32
PEAKS = Path(__file__).with_name("peaks.json")


def peaks(card: str) -> dict:
    """The frozen peaks of ``card`` (``torch.cuda.get_device_name``)."""
    table = json.loads(PEAKS.read_text())
    if card not in table:
        raise KeyError(f"no peaks for {card!r} in {PEAKS.name}")
    return table[card]


def genasm_dc(windows: int, w: int, k: int) -> tuple[float, float]:
    """(bytes, word ops) of GenASM-DC over ``windows`` windows of ``w``.

    A window reads its ``w`` text and ``w`` pattern bases (one byte each)
    and writes its least distance (4 bytes) and the status rows the
    traceback needs: ``w`` text positions × ``k+1`` rows × ``nw`` words.
    Per text character and word, row 0 is a shl1 and an OR (4 ops) and
    each row ``d >= 1`` three shl1, three ANDs and an OR (13 ops).
    """
    nw = w // WORD_BITS
    per = 2 * w + 4 + w * (k + 1) * nw * 4
    return float(windows) * per, float(windows) * w * nw * (4 + 13 * k)


def least_seconds(records: list, card: str, kernel: str, count) -> float:
    """The card's least time for ``kernel``'s work records ``(kernel,
    shape)``, each counted by ``count(**shape) -> (bytes, word ops)``: the
    larger of bytes over the memory rate and word ops over the peak rate,
    summed over the records.  A kernel's counting function lives beside
    its reader or here; records of other kernels are passed over."""
    pk = peaks(card)
    total = 0.0
    for name, shape in records:
        if name != kernel:
            continue
        n_bytes, n_ops = count(**shape)
        total += max(n_bytes / pk["hbm_bytes_per_s"], n_ops / pk["word_ops_per_s"])
    return total
