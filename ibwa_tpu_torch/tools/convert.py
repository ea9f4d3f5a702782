"""Input converters matching the reference's helper scripts:
qualfa2fq.pl (FASTA+qual -> FASTQ) and solid2fastq.pl (SOLiD
csfasta+qual -> color FASTQ pairs).

Copy of `ibwa_tpu/tools/convert.py`: the port keeps its own host code and
imports nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import gzip
import os
import re
import sys
from typing import TextIO


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _fasta_records(f):
    name, lines = None, []
    for line in f:
        line = line.rstrip("\n")
        if line.startswith(">") or line.startswith("#"):
            if line.startswith("#"):
                continue
            if name is not None:
                yield name, lines
            name = line[1:]
            lines = []
        else:
            lines.append(line)
    if name is not None:
        yield name, lines


def qualfa2fq(fa_path: str, qual_path: str, out: TextIO = sys.stdout
              ) -> None:
    """qualfa2fq.pl: merge a FASTA and its numeric .qual into FASTQ.

    The Perl prints each sequence record VERBATIM (qualfa2fq.pl:20), so a
    multi-line FASTA keeps its line breaks in the FASTQ; only the quality
    string is re-wrapped at 60 columns."""
    with _open(fa_path) as fs, _open(qual_path) as fq:
        for (name, seq_lines), (_, q_lines) in zip(_fasta_records(fs),
                                                   _fasta_records(fq)):
            quals = " ".join(q_lines).split()
            q = "".join(chr(int(v) + 33) for v in quals)
            out.write(f"@{name}\n")
            for line in seq_lines:
                out.write(line + "\n")
            out.write("+\n")
            for i in range(0, len(q), 60):
                out.write(q[i:i + 60] + "\n")


_CS2LETTER = str.maketrans("0123.", "ACGTN")


_SOLID_NAME = re.compile(r"^>(\d+)_(\d+)_(\d+)_[FR]3")


def _open_maybe_gz(path: str):
    if os.path.isfile(path):
        return open(path)
    if os.path.isfile(path + ".gz"):
        return gzip.open(path + ".gz", "rt")
    raise FileNotFoundError(f"** Fail to open '{path}'.")


class _SolidReader:
    """solid2fastq.pl's read1() (lines 88-112): pull the next
    ``panel_x_y`` record from a paired csfasta/qual stream.

    Yields (key, fastq_record) where key is the zero-padded
    ``%.4d_%.4d_%.4d`` sort key used by the merge, and the record is
    ``@<pre>:x_y_z/<i>`` + the primer-stripped color read (0123. →
    ACGTN) + the quality string with -1 → 0, the FIRST value dropped,
    and the rest offset by 33."""

    def __init__(self, title: str, tag: str, i: int, pre: str):
        self.fs = _open_maybe_gz(f"{title}{tag}.csfasta")
        self.fq = _open_maybe_gz(f"{title}{tag}_QV.qual")
        self.i = i
        self.pre = pre

    def read1(self):
        for line in self.fs:
            tline = self.fq.readline()
            m = _SOLID_NAME.match(line)
            if not m:
                continue
            key = "_".join(f"{int(g):04d}" for g in m.groups())
            if line != tline:
                raise ValueError(f"** unmatched read name: {line!r}")
            name = (f"{self.pre}:{m.group(1)}_{m.group(2)}_{m.group(3)}"
                    f"/{self.i}")
            seq = self.fs.readline()[2:].translate(_CS2LETTER)
            quals = self.fq.readline().split()
            q = "".join(chr(max(int(v), 0) + 33) for v in quals[1:])
            return key, f"@{name}\n{seq}+\n{q}\n"
        return None

    def close(self):
        self.fs.close()
        self.fq.close()


def solid2fastq(title: str, pre: str) -> None:
    """solid2fastq.pl: SOLiD F3[/R3] csfasta+qual -> gzipped FASTQ.

    Paired mode (``<title>R3.csfasta`` present): a SORTED MERGE on the
    panel_x_y key pairs F3 with R3 reads; F3 records (named ``/1``) land
    in ``<pre>.read2.fastq.gz`` and R3 (``/2``) in ``.read1`` — the
    reference's deliberate swap (solid2fastq.pl:41-42, "this is NOT a
    typo") — with unpaired keys streamed to ``.single``.  Single-end
    mode writes only ``.single.fastq.gz``."""
    paired = (os.path.isfile(f"{title}R3.csfasta")
              or os.path.isfile(f"{title}R3.csfasta.gz"))
    if not paired:
        rd = _SolidReader(title, "F3", 1, pre)
        with gzip.open(f"{pre}.single.fastq.gz", "wt") as single:
            while (df := rd.read1()) is not None:
                single.write(df[1])
        rd.close()
        return
    rf = _SolidReader(title, "F3", 1, pre)
    rr = _SolidReader(title, "R3", 2, pre)
    out2 = gzip.open(f"{pre}.read2.fastq.gz", "wt")
    out1 = gzip.open(f"{pre}.read1.fastq.gz", "wt")
    single = gzip.open(f"{pre}.single.fastq.gz", "wt")
    df, dr = rf.read1(), rr.read1()
    while df is not None and dr is not None:
        if df[0] == dr[0]:
            out2.write(df[1])
            out1.write(dr[1])
            df, dr = rf.read1(), rr.read1()
        elif df[0] <= dr[0]:
            single.write(df[1])
            df = rf.read1()
        else:
            single.write(dr[1])
            dr = rr.read1()
    while df is not None:
        single.write(df[1])
        df = rf.read1()
    while dr is not None:
        single.write(dr[1])
        dr = rr.read1()
    for f in (rf, rr):
        f.close()
    for f in (out2, out1, single):
        f.close()
