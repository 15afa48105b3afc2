"""The benchmark's data, made from ``--seed``: references, variants, reads.

One general generator serves every cell.  A configuration names the
deployment (a linear reference, or a variation graph over one) and its
sizes; a traffic file names the reads (length, error profile, the share
drawn from the deployment, batch size and pool).  Data is drawn from
generators keyed by ``(seed, purpose)``, so one seed gives the same
data, and the program and the plain reference are handed the
same inputs.  The reference and its variants are numpy on the host;
reads are made in bulk on the card with `torch.Generator` streams (the
same seed gives the same reads on the same card and torch): sources are
gathered from the reference (or spelled along random successor walks of
the graph), then every read is mutated by the traffic's error profile in
one vectorised pass.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

SENTINEL = 4  # the pattern wildcard and text sentinel of the base alphabet

_STREAMS = {"reference": 1, "variants": 2, "reads": 3, "foreign": 4,
            "order": 5, "sample": 6}


def rng(seed: int, purpose: str) -> np.random.Generator:
    """The generator of one purpose under ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 64, _STREAMS[purpose]])


def reference(length: int, seed: int) -> np.ndarray:
    """A random reference of ``length`` bases (int8 ids 0..3)."""
    return rng(seed, "reference").integers(0, 4, size=length, dtype=np.int8)


class Variants(NamedTuple):
    """Simulated variants: one row each, positions ascending."""

    pos: np.ndarray  # [V] int64 backbone position
    kind: np.ndarray  # [V] int8: 0 SNP, 1 insertion, 2 deletion
    alt: np.ndarray  # [V, 2] int8 alt bases (SNP: column 0; insertion: both)

    @property
    def counts(self) -> dict:
        return {name: int((self.kind == code).sum())
                for code, name in enumerate(("snp", "ins", "del"))}


DEL_SPAN = 2  # backbone bases a deletion skips
SPACING = 6  # least distance between two variant positions


def variants(ref: np.ndarray, *, per_bp: int, ratio: tuple, seed: int) -> Variants:
    """One variant per ``per_bp`` backbone bases, kinds in ``ratio``
    (SNP : insertion : deletion), at distinct positions ``SPACING`` apart:
    SNPs change the base, insertions add two random bases after it,
    deletions skip ``DEL_SPAN`` bases."""
    g = rng(seed, "variants")
    n = len(ref) // per_bp
    slots = np.arange(4, len(ref) - 8, SPACING)
    pos = np.sort(g.choice(slots, size=min(n, len(slots)), replace=False))
    weights = np.asarray(ratio, np.float64)
    counts = np.floor(len(pos) * weights / weights.sum()).astype(np.int64)
    counts[0] += len(pos) - counts.sum()
    kind = np.repeat(np.arange(3, dtype=np.int8), counts)
    g.shuffle(kind)
    alt = g.integers(0, 4, size=(len(pos), 2), dtype=np.int8)
    alt[kind == 0, 0] = (ref[pos[kind == 0]] + 1) % 4
    return Variants(pos=pos.astype(np.int64), kind=kind, alt=alt)


def torch_rng(seed: int, purpose: str, device):
    """A `torch.Generator` on ``device`` for one purpose under ``seed``."""
    import torch

    state = np.random.SeedSequence([int(seed) % 2 ** 64, _STREAMS[purpose]])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def mutate(src, profile: dict, g):
    """Apply an error profile to ``[N, L]`` int8 source reads (a tensor).

    Each base is an error with probability ``error_rate``; an error is a
    substitution, an insertion of a random base before it, or its
    deletion, in the profile's shares.  Returns ``(out [N, 2L] int8,
    lens [N] int64)`` on the sources' device, ``out`` padded with the
    wildcard.
    """
    import torch

    n, length = src.shape
    dev = src.device
    u = torch.rand((n, length), generator=g, device=dev)
    p = profile["error_rate"]
    kind = u / p  # uniform in [0, 1) where u < p
    fs, fi = profile["frac_sub"], profile["frac_ins"]
    err = u < p
    sub = err & (kind < fs)
    ins = err & (kind >= fs) & (kind < fs + fi)
    dele = err & (kind >= fs + fi)
    shift = torch.randint(1, 4, (n, length), generator=g, device=dev, dtype=torch.int8)
    extra = torch.randint(0, 4, (n, length), generator=g, device=dev, dtype=torch.int8)
    base = torch.where(sub, (src + shift) % 4, src).to(torch.int8)
    # base j lands at j + (insertions at or before j) - (deletions before j)
    at = (torch.arange(length, device=dev)
          + torch.cumsum(ins.to(torch.int32) - dele.to(torch.int32), dim=1)
          + dele.to(torch.int32)).long()
    drop = 2 * length  # a column that takes what is not written, then cut
    out = torch.full((n, 2 * length + 1), SENTINEL, dtype=torch.int8, device=dev)
    out.scatter_(1, torch.where(dele, drop, at), base)
    out.scatter_(1, torch.where(ins, at - 1, drop), extra)
    lens = length + ins.sum(1) - dele.sum(1)
    return out[:, :2 * length], lens


def linear_sources(ref, n: int, read_len: int, g):
    """``[n, read_len]`` error-free reads at uniform positions of ``ref``
    (an int8 tensor)."""
    import torch

    pos = torch.randint(0, ref.shape[0] - read_len, (n,), generator=g,
                        device=ref.device)
    return ref[pos[:, None] + torch.arange(read_len, device=ref.device)]


def graph_sources(bases, succ, node_of_backbone, n: int, read_len: int, g):
    """``[n, read_len]`` error-free reads spelled along random successor
    walks of a graph (tensors), each from a uniform backbone position,
    taking each successor of a branching node with equal chance."""
    import torch

    dev = bases.device
    start = torch.randint(0, node_of_backbone.shape[0] - 2 * read_len, (n,),
                          generator=g, device=dev)
    cur = node_of_backbone[start]
    out = torch.empty((n, read_len), dtype=torch.int8, device=dev)
    hops = torch.arange(16, device=dev)
    for j in range(read_len):
        out[:, j] = bases[cur]
        set_bits = (succ[cur].unsqueeze(1) >> hops) & 1
        count = set_bits.sum(1).clamp(min=1)
        pick = (torch.rand(n, generator=g, device=dev) * count).long().clamp(max=count - 1)
        nth = torch.cumsum(set_bits, 1) - 1
        cur = cur + 1 + ((nth == pick.unsqueeze(1)) & (set_bits == 1)).to(torch.int8).argmax(1)
    return out


class ReadPool(NamedTuple):
    """The pool the window cycles through: ``batches`` × ``batch`` reads."""

    reads: list  # [batches · batch] int8 arrays, the program's input form
    arr: np.ndarray  # [batches · batch, 2 · read_len] int8, wildcard-padded
    lens: np.ndarray  # [batches · batch] int64
    from_deployment: np.ndarray  # [batches · batch] bool
    batch: int
    batches: int


def read_pool(traffic: dict, seed: int, source, device="cpu") -> ReadPool:
    """The traffic's read pool, made on ``device``: per batch exactly
    ``round(batch · deployment_share)`` reads from the deployment
    (``source(n, read_len, g)`` makes their error-free sources), the rest
    from an independent random sequence, in a seeded order; every read
    mutated by the traffic's error profile."""
    import torch

    b, nb, read_len = traffic["batch"], traffic["pool_batches"], traffic["read_len"]
    n_dep = int(round(b * traffic["deployment_share"]))
    g_reads = torch_rng(seed, "reads", device)
    g_order = torch_rng(seed, "order", device)
    own = source(n_dep * nb, read_len, g_reads)
    alien = torch.randint(0, 4, ((b - n_dep) * nb, read_len), dtype=torch.int8,
                          generator=torch_rng(seed, "foreign", device), device=device)
    order = torch.cat([torch.randperm(b, generator=g_order, device=device) + i * b
                       for i in range(nb)]).reshape(nb, b)
    dep_rows = order[:, :n_dep].reshape(-1)
    src = torch.empty((b * nb, read_len), dtype=torch.int8, device=device)
    src[dep_rows] = own
    src[order[:, n_dep:].reshape(-1)] = alien
    out, lens = mutate(src, traffic["profile"], g_reads)
    arr, lens = out.cpu().numpy(), lens.cpu().numpy()
    dep = np.zeros(b * nb, bool)
    dep[dep_rows.cpu().numpy()] = True
    reads = [arr[i, :lens[i]] for i in range(arr.shape[0])]
    return ReadPool(reads=reads, arr=arr, lens=lens, from_deployment=dep,
                    batch=b, batches=nb)


def check_sample(pool: ReadPool, per_batch: int, seed: int) -> np.ndarray:
    """``[batches, k]`` rows of each pool batch whose answers the plain
    reference checks, drawn from the seed: ``per_batch`` of the reads from
    the deployment and as many of the foreign reads (all of a kind where
    the batch holds fewer), so a mix of mostly foreign reads still has
    ``per_batch`` reads a batch that map."""
    g = rng(seed, "sample")
    dep = pool.from_deployment.reshape(pool.batches, pool.batch)
    rows = []
    for i in range(pool.batches):
        pick = [g.choice(idx, size=min(per_batch, idx.size), replace=False)
                for idx in (np.nonzero(dep[i])[0], np.nonzero(~dep[i])[0])]
        rows.append(np.sort(np.concatenate(pick)))
    return np.stack(rows)
