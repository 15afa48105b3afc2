"""The port's kernels in one place: wrappers, plain versions, launch counts.

Each entry of `KERNELS` names a wrapper (CUDA kernel on a CUDA tensor,
plain PyTorch on a CPU tensor), its plain version, the Pallas TPU kernel
it replaces (for the linear mapper's filter, which the reference runs as
plain XLA, that path), and ``make_inputs(rng, device, **shape) -> (args, kwargs)``,
which draws seeded inputs at a shape so that ``wrapper(*args, **kwargs)``
and ``plain(*args, **kwargs)`` can be held against each other.
`reset_launch_counts` / `launch_counts` read the wrappers' ``launches``
counters, which only a kernel launch increments.

This module plays the role of the reference's `repro.kernels.ref` (the
pure-jnp oracle of every Pallas kernel): each entry's ``plain`` is its
kernel's oracle, and on a CPU tensor the wrapper runs it.  The port has
no ``kernels/ref.py`` of its own.

`window_dc`, `window_dc_v2`, `myers_distance` and `bitalign_dc` are the
reference's public wrappers (`repro.kernels.ops`), with its arguments
and shapes less the Pallas batch tile (``block_bt``): each is one call
to the wrapper that `KERNELS` names, which needs no padding to a tile.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.segram.bitalign import bitalign_rows
from repro_torch.core.segram.graph import HOP_LIMIT

from repro_torch.core.myers import myers_distance_batch as myers_plain

from .bitalign import bitalign_dc_batch
from .bitap_filter import bitap_filter_batch, bitap_filter_batch_plain
from .genasm_dc import window_dc_batch, window_dc_batch_plain
from .genasm_dc_v2 import window_dc_batch_v2, window_dc_batch_v2_plain
from .myers import myers_distance_batch


class Kernel(NamedTuple):
    """One port kernel: its wrapper, plain version, sources and inputs."""

    name: str
    wrapper: Callable
    plain: Callable
    source: str  # CUDA source, repository path
    replaces: str  # the Pallas kernel function (or plain XLA path), file:line
    make_inputs: Callable  # (rng, device, **shape) -> (args, kwargs)


def window_inputs(rng: np.random.Generator, device, *, b: int, w: int, k: int):
    """Random ``[b, w]`` texts and patterns over A, C, G, T and id 4."""
    t = torch.from_numpy(rng.integers(0, 5, size=(b, w)).astype(np.int8))
    p = torch.from_numpy(rng.integers(0, 5, size=(b, w)).astype(np.int8))
    return (t.to(device), p.to(device)), dict(w=w, k=k)


# longer-edge probability per hop bit in the served variation graph
# (`serve_genomics --mode graph`, one variant per 200 bp): 0.75% of its
# nodes have a hop > 0 edge, spread here over the 15 longer hops
GRAPH_HOP_RATE = 0.0075 / 15


def bitalign_inputs(rng: np.random.Generator, device, *, b: int, n: int,
                    m_bits: int, k: int, store_r: bool = True,
                    short: bool = False, hop_rate: float = GRAPH_HOP_RATE):
    """Random subgraph rows and patterns for `bitalign_dc_batch`.

    Every node chains to its neighbour (hop 0) unless it is a tile's last
    node; with probability ``hop_rate`` per hop it also has a longer edge
    (hops past ``n`` included).  Patterns are ACGT with a wildcard tail;
    with ``short`` the real lengths are drawn below ``m_bits``.
    """
    bases = rng.integers(0, 5, size=(b, n)).astype(np.int8)
    succ = (rng.random((b, n, HOP_LIMIT)) < hop_rate).astype(np.int64)
    succ[:, :-1, 0] = 1
    succ_bits = (succ << np.arange(HOP_LIMIT)).sum(-1).astype(np.int32)
    p_lens = (rng.integers(m_bits // 2, m_bits, size=b) if short
              else np.full(b, m_bits)).astype(np.int32)
    pats = rng.integers(0, 4, size=(b, m_bits)).astype(np.int8)
    pats[np.arange(m_bits)[None, :] >= p_lens[:, None]] = 4
    args = tuple(torch.from_numpy(x).to(device)
                 for x in (bases, succ_bits, pats, p_lens))
    return args, dict(m_bits=m_bits, k=k, store_r=store_r)


def myers_inputs(rng: np.random.Generator, device, *, b: int, n: int,
                 m_bits: int, mode: str = "semiglobal", short: bool = False):
    """Random pairs for `myers_distance_batch`: ACGT patterns and texts
    that copy them with 10% substitutions (texts past the pattern are
    random), 1% sentinels (id 4) in the text.  Patterns fill ``m_bits``
    unless ``short``: then ``m_lens`` are drawn from ``[0, m_bits]``, the
    first three lanes being 0, 1 and ``m_bits``, and the tail past each is
    the wildcard."""
    pats = rng.integers(0, 4, size=(b, m_bits)).astype(np.int8)
    texts = rng.integers(0, 4, size=(b, n)).astype(np.int8)
    keep = min(n, m_bits)
    same = rng.random((b, keep)) >= 0.1
    texts[:, :keep] = np.where(same, pats[:, :keep], texts[:, :keep])
    texts[rng.random((b, n)) < 0.01] = 4
    m_lens = np.full(b, m_bits, np.int32)
    if short:
        m_lens = rng.integers(0, m_bits + 1, size=b).astype(np.int32)
        m_lens[:3] = [0, 1, m_bits][:b]
        pats[np.arange(m_bits)[None, :] >= m_lens[:, None]] = 4
    args = tuple(torch.from_numpy(x).to(device) for x in (texts, pats, m_lens))
    return args, dict(m_bits=m_bits, mode=mode)


def filter_inputs(rng: np.random.Generator, device, *, b: int, c: int = 4,
                  filter_bits: int = 128, k: int = 12, region_len: int | None = None,
                  ref_len: int = 1 << 16, offset: int = 0, short: bool = False,
                  edge: bool = False, ties: bool = False):
    """Random inputs for `bitap_filter_batch`, laid out as the linear
    mapper's filter lays them out.

    A reference of ``ref_len`` bases (ACGT, 0.2% id 4), a view ``offset``
    bytes into its buffer; reads of ``filter_bits + 32`` bases copied from
    it with 4% substitutions.  Candidate 0 of each read holds the read's
    place, the others lie at random (with ``edge``, before the buffer's
    start and past its end too).  ``region_len`` defaults to the mapper's
    ``filter_bits + 2 (k + 32)``.  With ``short`` the read lengths are
    drawn in ``[0, filter_bits]``, the first two being 0 and 1; with
    ``ties`` the reference starts with a period-4 stretch from which half
    the reads are copied, so a read ties with itself every 4 positions.
    """
    region_len = region_len or filter_bits + 2 * (k + 32)
    cap = filter_bits + 32
    buf = rng.integers(0, 4, size=offset + ref_len).astype(np.int8)
    buf[rng.random(buf.size) < 0.002] = 4
    ref = buf[offset:]
    hi = max(ref_len - cap, 1)
    true = rng.integers(0, hi, size=b)
    if ties:
        stretch = min(ref_len, 4 * region_len + cap)
        ref[:stretch] = np.resize(np.arange(4, dtype=np.int8), stretch)
        true[: b // 2] = rng.integers(0, max(stretch - cap, 1), size=b // 2)
    reads = ref[np.minimum(true[:, None] + np.arange(cap), ref_len - 1)]
    subs = rng.random((b, cap)) < 0.04
    reads[subs] = rng.integers(0, 4, size=int(subs.sum()))
    if edge:
        starts = rng.integers(-region_len, ref_len + region_len, size=(b, c))
    else:
        starts = rng.integers(0, hi, size=(b, c))
    if c:
        starts[:, 0] = true - rng.integers(0, max(region_len - filter_bits, 0) + 1,
                                           size=b)
    lens = np.full(b, cap)
    if short:
        lens = rng.integers(0, filter_bits + 1, size=b)
        lens[:2] = [0, 1][:b]
    dev_buf = torch.from_numpy(buf).to(device)
    args = (dev_buf[offset:],
            *(torch.from_numpy(x).to(device)
              for x in (starts.astype(np.int64), reads.astype(np.int8),
                        lens.astype(np.int64))))
    return args, dict(filter_bits=filter_bits, k=k, region_len=region_len)


KERNELS = (
    Kernel("window_dc_batch", window_dc_batch, window_dc_batch_plain,
           "src/repro_torch/kernels/csrc/genasm_dc.cu",
           "src/repro/kernels/genasm_dc.py:94", window_inputs),
    Kernel("window_dc_batch_v2", window_dc_batch_v2, window_dc_batch_v2_plain,
           "src/repro_torch/kernels/csrc/genasm_dc.cu",
           "src/repro/kernels/genasm_dc_v2.py:66", window_inputs),
    Kernel("bitalign_dc_batch", bitalign_dc_batch, bitalign_rows,
           "src/repro_torch/kernels/csrc/bitalign.cu",
           "src/repro/kernels/bitalign.py:86", bitalign_inputs),
    Kernel("myers_distance_batch", myers_distance_batch, myers_plain,
           "src/repro_torch/kernels/csrc/myers.cu",
           "src/repro/kernels/myers.py:96", myers_inputs),
    # no Pallas kernel: the reference's filter is plain XLA (lax.scan)
    Kernel("bitap_filter_batch", bitap_filter_batch, bitap_filter_batch_plain,
           "src/repro_torch/kernels/csrc/bitap_filter.cu",
           "src/repro/core/genasm_dc.py:124", filter_inputs),
)


def window_dc(sub_texts, sub_patterns, *, w: int = 64, k: int = 24,
              squeeze: bool = False):
    """GenASM-DC over a batch of windows (`window_dc_batch`).

    ``sub_texts``/``sub_patterns``: ``[B, w]`` int8.  Returns ``(d_min
    [B], tb [B, w, k+1, 3, nw])``; ``squeeze=True`` drops a leading
    singleton batch.
    """
    d, tb = window_dc_batch(sub_texts, sub_patterns, w=w, k=k)
    return (d[0], tb[0]) if squeeze else (d, tb)


def myers_distance(texts, patterns, m_lens, *, m_bits: int,
                   mode: str = "global"):
    """Batched Myers edit distance (`myers_distance_batch`): ``[B]`` int32."""
    return myers_distance_batch(texts, patterns, m_lens, m_bits=m_bits,
                                mode=mode)


def window_dc_v2(sub_texts, sub_patterns, *, w: int = 64, k: int = 24,
                 squeeze: bool = False):
    """The v2 kernel, R-only TB store (`window_dc_batch_v2`): ``(d_min
    [B], R [B, w+1, k+1, nw])``, ``squeeze`` as `window_dc`."""
    d, r = window_dc_batch_v2(sub_texts, sub_patterns, w=w, k=k)
    return (d[0], r[0]) if squeeze else (d, r)


def bitalign_dc(bases, succ_bits, patterns, p_lens, *, m_bits: int, k: int):
    """Batched BitAlign DC with its R store (`bitalign_dc_batch`):
    ``(dists [B, N], R [B, N, k+1, nw])``."""
    return bitalign_dc_batch(bases, succ_bits, patterns, p_lens,
                             m_bits=m_bits, k=k, store_r=True)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count (and BitAlign's by store) to 0."""
    for kern in KERNELS:
        kern.wrapper.launches = 0
    for key in bitalign_dc_batch.launches_by_store:
        bitalign_dc_batch.launches_by_store[key] = 0


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since `reset_launch_counts`, by name."""
    return {kern.name: kern.wrapper.launches for kern in KERNELS}
