"""Streaming FASTA/FASTQ parsing (host side).

Mirrors the observable behavior of the reference's kseq-based readers:
name = first whitespace-delimited token, comment = remainder of the header
line, sequence concatenated across wrapped lines.

Copy of `ibwa_tpu/io/fasta.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator


@dataclasses.dataclass
class SeqRecord:
    name: str
    comment: str
    seq: str
    qual: str | None = None


def _open(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path: str) -> Iterator[SeqRecord]:
    name = comment = None
    chunks: list[str] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if name is not None:
                    yield SeqRecord(name, comment, "".join(chunks))
                header = line[1:]
                parts = header.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield SeqRecord(name, comment, "".join(chunks))


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """FASTA or FASTQ, sniffed from the first character."""
    with _open(path) as f:
        first = f.read(1)
    if first == "@":
        yield from read_fastq(path)
    else:
        yield from read_fasta(path)


def read_fastq(path: str) -> Iterator[SeqRecord]:
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            seq = f.readline().rstrip("\n")
            f.readline()  # '+'
            qual = f.readline().rstrip("\n")
            parts = header[1:].split(None, 1)
            name = parts[0] if parts else ""
            comment = parts[1] if len(parts) > 1 else ""
            yield SeqRecord(name, comment, seq, qual)
