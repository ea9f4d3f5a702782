"""`stdsw`: standalone SW/NW alignment of short sequences against one
long sequence with alignment text output (the reference's simple_dp.c).

Copy of `ibwa_tpu/tools/stdsw.py`: the port keeps its own host code and
imports nothing of `ibwa_tpu`; it runs over the port's `native`
and `io/fasta.py`.
"""

from __future__ import annotations

import sys
from typing import TextIO

import numpy as np

from .. import native
from ..io.fasta import read_fastx

# aln_param_blast = {5, 2, 2, aln_sm_blast, 5, 50} with gap_end forced 0
SM_BLAST = np.array([1, -3, -3, -3, -2,
                     -3, 1, -3, -3, -2,
                     -3, -3, 1, -3, -2,
                     -3, -3, -3, 1, -2,
                     -2, -2, -2, -2, -2], dtype=np.int32)

# IUPAC complement preserving case (aln_rev_table, simple_dp.c:24-41)
_REV = {}
for a, b in zip("ACGTMRWSYKVHDBN", "TGCAKYWSRMBDHVN"):
    _REV[a] = b
    _REV[a.lower()] = b.lower()


def revseq(s: str) -> str:
    return "".join(_REV.get(c, "N") for c in reversed(s))


NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    NT4[_b] = _i
    NT4[ord(chr(_b).lower())] = _i


def _codes(s: str) -> np.ndarray:
    return NT4[np.frombuffer(s.encode("latin-1"), dtype=np.uint8)]


def _render(seq1: str, seq2: str, c1: np.ndarray, c2: np.ndarray,
            cigar: list[int], fi: int, fj: int, row: int
            ) -> tuple[str, str, str]:
    """Alignment text (aln_stdaln_aux, stdaln.c:806-830): out1/outm/out2."""
    o1, o2, om = [], [], []
    i, j = fi, fj
    first = True
    for c in cigar:
        op = c & 0xF
        ln = c >> 4
        for _ in range(ln):
            if not first:
                if op == 0:
                    i += 1
                    j += 1
                elif op == 1:
                    j += 1
                else:
                    i += 1
            first = False
            if op == 0:
                o1.append(seq1[i - 1])
                o2.append(seq2[j - 1])
                om.append("|" if (c1[i - 1] == c2[j - 1]
                                  and c1[i - 1] != row) else " ")
            elif op == 1:
                o1.append("-")
                o2.append(seq2[j - 1])
                om.append(" ")
            else:
                o1.append(seq1[i - 1])
                o2.append("-")
                om.append(" ")
    return "".join(o1), "".join(o2), "".join(om)


def _aln_one(long_name: str, long_seq: str, name: str, s: str, strand: str,
             is_global: bool, thres: int, out: TextIO) -> None:
    c1 = _codes(s)            # short = seq1 (simple_dp.c:98 comment)
    c2 = _codes(long_seq)
    band = len(s) + len(long_seq)
    if is_global:
        cigar_bwa, score = native.global_aln(
            c1, c2, gap_open=5, gap_ext=2, gap_end=0, band=band,
            matrix=SM_BLAST)
        cigar = [((c & 0x1FFFFFFF) << 4) | (c >> 29) for c in cigar_bwa]
        fi = 1 if cigar and (cigar[0] & 0xF) in (0, 2) else 0
        fj = 1 if cigar and (cigar[0] & 0xF) in (0, 1) else 0
        end_i, end_j = len(s), len(long_seq)
        subo = 0
    else:
        cigar, score, fi, fj, end_i, end_j, subo = native.local_aln(
            c1, c2, thres=thres, gap_open=5, gap_ext=2, band=band,
            matrix=SM_BLAST)
        cigar = [((c & 0x1FFFFFFF) << 4) | (c >> 29) for c in cigar]
    if not (score >= thres or is_global) or not cigar:
        return
    o1, o2, om = _render(s, long_seq, c1, c2, cigar, fi, fj, 5)
    # header mirrors simple_dp.c:101-103: long name first but with the
    # SHORT sequence's (seq1) coordinates — the reference's own layout
    out.write(f">{long_name}\t{fi if fi else 1}\t{end_i}\t{name}\t{strand}"
              f"\t{fj if fj else 1}\t{end_j}\t{score}\t{subo}\t")
    # short read is seq1, so I/D swap in the printed cigar ("MDI")
    out.write("".join(f"{c >> 4}{'MDI'[c & 0xF]}" for c in cigar))
    out.write(f"\n{o2}\n{om}\n{o1}\n")


def stdsw(long_fa: str, short_fa: str, thres: int = 1,
          is_global: bool = False, strand: int = 3,
          out: TextIO = sys.stdout) -> None:
    """bwa_stdsw (simple_dp.c:129-162)."""
    longs = [(r.name, r.seq) for r in read_fastx(long_fa)]
    print(f"[load_seqs] {len(longs)} sequences are loaded.",
          file=sys.stderr)
    for rec in read_fastx(short_fa):
        for lname, lseq in longs:
            if strand & 1:
                _aln_one(lname, lseq, rec.name, rec.seq, "+", is_global,
                         thres, out)
            if strand & 2:
                _aln_one(lname, lseq, rec.name, revseq(rec.seq), "-",
                         is_global, thres, out)
