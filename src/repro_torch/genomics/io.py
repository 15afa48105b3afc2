"""FASTA/FASTQ parsing and PAF/GAF writing (host side, numpy).

Copied from `repro.genomics.io`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np

from .encode import decode, encode


class Record(NamedTuple):
    name: str
    seq: np.ndarray  # int8 base ids
    qual: str | None = None


def read_fasta(path: str | Path) -> Iterator[Record]:
    name, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield Record(name, encode("".join(chunks)))
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
    if name is not None:
        yield Record(name, encode("".join(chunks)))


def write_fasta(path: str | Path, records: list[Record], width: int = 80) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f">{r.name}\n")
            s = decode(r.seq)
            for i in range(0, len(s), width):
                f.write(s[i: i + width] + "\n")


def read_fastq(path: str | Path) -> Iterator[Record]:
    with open(path) as f:
        while True:
            header = f.readline().strip()
            if not header:
                return
            seq = f.readline().strip()
            f.readline()
            qual = f.readline().strip()
            yield Record(header[1:].split()[0], encode(seq), qual)


def write_fastq(path: str | Path, records: list[Record]) -> None:
    with open(path, "w") as f:
        for r in records:
            q = r.qual or "I" * len(r.seq)
            f.write(f"@{r.name}\n{decode(r.seq)}\n+\n{q}\n")


CIGAR_CHARS = "MXID"


def cigar_string(ops: np.ndarray, n_ops: int) -> str:
    """Packed ops -> run-length CIGAR text (M/X/I/D)."""
    out = []
    run_op, run_len = None, 0
    for s in range(int(n_ops)):
        op = int(ops[s])
        if op == run_op:
            run_len += 1
        else:
            if run_op is not None:
                out.append(f"{run_len}{CIGAR_CHARS[run_op]}")
            run_op, run_len = op, 1
    if run_op is not None:
        out.append(f"{run_len}{CIGAR_CHARS[run_op]}")
    return "".join(out)


def _write_rows(path: str | Path, rows: list[dict],
                columns: tuple[str, ...]) -> None:
    """Shared PAF/GAF row formatter: tab columns, ``*`` defaults, cg tag."""
    with open(path, "w") as f:
        for r in rows:
            f.write(
                "\t".join(str(r.get(k, "*")) for k in columns)
                + (f"\tcg:Z:{r['cigar']}" if "cigar" in r else "")
                + "\n"
            )


def write_paf(path: str | Path, rows: list[dict]) -> None:
    """Minimal PAF writer (the paper's Minimap output format)."""
    _write_rows(path, rows, ("qname", "qlen", "qstart", "qend", "strand",
                             "tname", "tlen", "tstart", "tend", "nmatch",
                             "alnlen", "mapq"))


def gaf_path(nodes) -> tuple[str, int]:
    """Node-id walk -> (GAF path string, path length in nodes).

    The one-base-per-node graphs name a maximal run of consecutive node
    ids as one forward-oriented segment ``s<first>-<last>`` (a hop edge
    starts a new segment), so ``>s5-40>s44-61`` reads as "nodes 5..40,
    hop, nodes 44..61".  Unmapped/empty paths return ``("*", 0)``.
    """
    ids = [int(x) for x in nodes if int(x) >= 0]
    if not ids:
        return "*", 0
    segs = []
    run_start = prev = ids[0]
    for x in ids[1:]:
        if x != prev + 1:
            segs.append((run_start, prev))
            run_start = x
        prev = x
    segs.append((run_start, prev))
    return "".join(f">s{a}-{b}" for a, b in segs), len(ids)


def write_gaf(path: str | Path, rows: list[dict]) -> None:
    """Minimal GAF writer (graph alignment format, the SeGraM output).

    Columns: qname qlen qstart qend strand path plen pstart pend nmatch
    alnlen mapq, plus a ``cg:Z:`` CIGAR tag when present.  Keys outside
    the column list are ignored, mirroring `write_paf`.
    """
    _write_rows(path, rows, ("qname", "qlen", "qstart", "qend", "strand",
                             "path", "plen", "pstart", "pend", "nmatch",
                             "alnlen", "mapq"))
