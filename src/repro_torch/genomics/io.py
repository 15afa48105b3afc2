"""FASTA/FASTQ parsing and PAF writing (host side, numpy).

Copied from `repro.genomics.io` (the linear-workload part).
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
