"""samse: .sai -> SAM single-end pipeline (the reference's bwase.c).

Selection, SA->position, gapped refinement, MD/NM and record printing all
mirror bwase.c exactly — including its quirks (MD computed at remapped_pos
which stays 0 in SE mode, bwase.c:367-371; ZR emitted whenever
pos != remapped_pos, bwase.c:556-563) — because the oracle for this repo
is byte parity with the reference binary.

Copy of `ibwa_tpu/sam/bwase.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import TextIO

import numpy as np

from .. import native
from ..align.engine_ref import Hit
from ..align.opts import (BWA_AVG_ERR, BWA_MODE_COMPREAD, GapOpt,
                          cal_maxdiff)
from ..io import sai
from ..io.reads import Read, load_reads
from ..rng import Rand48
from .dbset import DbSet

# bwa_seq_t.type (bwtaln.h:22-25)
TYPE_NO_MATCH, TYPE_UNIQUE, TYPE_REPEAT, TYPE_MATESW = 0, 1, 2, 3

# SAM flags (bwtaln.h:12-20)
SAM_FPD, SAM_FPP, SAM_FSU, SAM_FMU = 1, 2, 4, 8
SAM_FSR, SAM_FMR, SAM_FR1, SAM_FR2 = 16, 32, 64, 128
SAM_FSC = 256

FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3

G_LOG_N = [0] + [int(4.343 * math.log(i) + 0.5) for i in range(1, 256)]


def cigar_op(c: int) -> int:
    return c >> 29


def cigar_len(c: int) -> int:
    return c & 0x1FFFFFFF


def cigar_create(op: int, ln: int) -> int:
    return (op << 29) | ln


@dataclasses.dataclass
class Multi:
    """bwt_multi1_t (bwtaln.h:51-60)."""

    pos: int          # SA index first, then global position
    gap: int
    mm: int
    strand: int
    cigar: list[int] | None = None
    dbidx: int = 0
    # calloc'd to 0 in the reference (bwt_multi1_t), NOT -1 — multis on a
    # remap-enabled db therefore translate through contig 0's remap cigar
    remapped_seqid: int = 0
    remapped_pos: int = 0
    remap_identical: bool = False


@dataclasses.dataclass
class AlnSeq:
    """Per-read alignment state (the mutable part of bwa_seq_t)."""

    read: Read
    type: int = TYPE_NO_MATCH
    strand: int = 0
    sa: int = 0
    pos: int = 0
    remapped_pos: int = 0
    remapped_seqid: int = -1
    dbidx: int = 0
    c1: int = 0
    c2: int = 0
    remap_identical: int = 0
    n_mm: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    score: int = 0
    mapQ: int = 0
    seQ: int = 0
    nm: int = 0
    md: str | None = None
    cigar: list[int] | None = None
    multi: list[Multi] = dataclasses.field(default_factory=list)
    extra_flag: int = 0
    len: int = 0
    seq_fwd: np.ndarray | None = None  # forward-oriented clipped codes
    qual_out: bytes | None = None
    conv: np.ndarray | None = None     # color mode: decoded nt read
    conv_qual: bytes | None = None     # color mode: recomputed quals
    rseq_conv: np.ndarray | None = None

    def __post_init__(self):
        self.len = self.read.clip_len


def aln2seq_core(hits: list[Hit], s: AlnSeq, set_main: bool, n_multi: int,
                 rng: Rand48) -> None:
    """bwa_aln2seq_core (bwase.c:29-104): weighted-random primary pick +
    multi-hit enumeration.  Consumes drand48 in exactly reference order."""
    if not hits:
        s.type = TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return

    if set_main:
        best = hits[0].score
        cnt = 0
        i = 0
        while i < len(hits):
            p = hits[i]
            if p.score > best:
                break
            if rng.drand48() * (p.l - p.k + 1 + cnt) > float(cnt):
                s.n_mm, s.n_gapo, s.n_gape = p.n_mm, p.n_gapo, p.n_gape
                s.strand = p.a
                s.score = p.score
                s.sa = p.k + int((p.l - p.k + 1) * rng.drand48())
            cnt += p.l - p.k + 1
            i += 1
        s.c1 = cnt
        while i < len(hits):
            cnt += hits[i].l - hits[i].k + 1
            i += 1
        s.c2 = cnt - s.c1
        s.type = TYPE_REPEAT if s.c1 > 1 else TYPE_UNIQUE

    if n_multi:
        n_occ = sum(q.l - q.k + 1 for q in hits)
        s.multi = []
        if n_occ > n_multi + 1:  # too many hits: generate none
            return
        rest = n_occ
        z = []
        for q in hits:
            if q.l - q.k + 1 <= rest:
                for pos in range(q.k, q.l + 1):
                    z.append(Multi(pos=pos, gap=q.n_gapo + q.n_gape,
                                   mm=q.n_mm, strand=q.a))
                rest -= q.l - q.k + 1
            else:  # reference comment: "we never come here"
                j = rest
                i2 = q.l - q.k + 1
                while j > 0:
                    p = 1.0
                    x = rng.drand48()
                    while x < p:
                        p -= p * j / i2
                        i2 -= 1
                    z.append(Multi(pos=q.l - i2, gap=q.n_gapo + q.n_gape,
                                   mm=q.n_mm, strand=q.a))
                    j -= 1
                break
        z = [m for m in z if m.pos != s.sa]
        s.multi = z[:n_multi]


def approx_mapQ(s: AlnSeq, mm: int) -> int:
    """bwa_approx_mapQ (bwase.c:111-120)."""
    if s.c1 == 0:
        return 23
    if s.c1 > 1:
        return 0
    if s.n_mm == mm:
        return 25
    if s.c2 == 0:
        return 37
    n = 255 if s.c2 >= 255 else s.c2
    return 0 if 23 < G_LOG_N[n] else 23 - G_LOG_N[n]


def cal_pac_pos(dbs: DbSet, seqs: list[AlnSeq], max_mm: int,
                fnr: float) -> None:
    """bwa_cal_pac_pos (bwase.c:137-161), batched per strand."""
    db = dbs.dbs[0]
    for strand in (1, 0):
        qs: list[tuple[AlnSeq | Multi, int]] = []
        for s in seqs:
            if s.type in (TYPE_UNIQUE, TYPE_REPEAT) and s.strand == strand:
                qs.append((s, s.len))
            for m in s.multi:
                if m.strand == strand:
                    qs.append((m, s.len))
        if not qs:
            continue
        sa_arr = np.array([q.sa if isinstance(q, AlnSeq) else q.pos
                           for q, _ in qs], dtype=np.uint32)
        lens = np.array([ln for _, ln in qs], dtype=np.int64)
        poss = db.sa2seq(strand, sa_arr, lens)
        for (q, _), pos in zip(qs, poss):
            if isinstance(q, AlnSeq):
                q.pos = int(pos)
            else:
                q.pos = int(pos)
    for s in seqs:
        if s.type in (TYPE_UNIQUE, TYPE_REPEAT):
            max_diff = (cal_maxdiff(s.len, BWA_AVG_ERR, fnr) if fnr > 0.0
                        else max_mm)
            s.seQ = s.mapQ = approx_mapQ(s, max_diff)


def refine_gapped_core(dbs: DbSet, dbidx: int, seqid: int, length: int,
                       seq: np.ndarray, pos: int, ext: int,
                       is_end_correct: int, nt: bool = False
                       ) -> tuple[list[int], int]:
    """refine_gapped_core (bwase.c:167-241): re-extract the reference
    around the hit, run banded global DP, post-fix the CIGAR.  Returns
    (cigar, new_pos)."""
    if pos > dbs.l_pac:
        raise RuntimeError(f"position={pos} > l_pac={dbs.l_pac}")
    ref_len = length + abs(ext)
    if ext > 0:
        ref_start = pos
    else:
        x = pos + (length if is_end_correct else ref_len)
        ref_start = x - ref_len if x - ref_len > 0 else 0
        ref_len = x - ref_start
    if nt:  # color space second pass extracts the nucleotide pac
        ref_seq = dbs.extract_sequence(ref_start, ref_len, nt=True)
    else:
        ref_seq = dbs.extract_remapped(dbidx, seqid, ref_start, ref_len)
    cigar, _score = native.global_aln(ref_seq, seq[:length])

    if ext < 0 and is_end_correct:  # fix fwd-strand coordinate
        l = 0
        for c in cigar:
            if cigar_op(c) == FROM_D:
                l -= cigar_len(c)
            elif cigar_op(c) == FROM_I:
                l += cigar_len(c)
        pos += l

    if cigar and cigar_op(cigar[0]) == FROM_D:  # 5'-end deletion
        pos += cigar_len(cigar[0])
        cigar = cigar[1:]
    if cigar and cigar_op(cigar[-1]) == FROM_D:  # 3'-end deletion
        cigar = cigar[:-1]
    # I at either end -> S
    if cigar and cigar_op(cigar[-1]) == FROM_I:
        cigar[-1] = cigar_create(3, cigar_len(cigar[-1]))
    if cigar and cigar_op(cigar[0]) == FROM_I:
        cigar[0] = cigar_create(3, cigar_len(cigar[0]))

    db = dbs.dbs[dbidx]
    if not nt and db.remap is not None and seqid in db.remap \
            and db.remap[seqid].cigar:
        from . import remap as remap_mod
        start = pos - db.offset - db.bns.anns[seqid].offset
        cigar = remap_mod.translate_cigar(
            db.remap[seqid].cigar, start, cigar, length)
    return cigar, pos


_BASE_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP_CHARS = np.frombuffer(b"TGCAN", dtype=np.uint8)
_MD_PAIRS = [f"{g}{b}" for g in range(10) for b in "ACGTN"]


def _md_span(out: list[str], ref: np.ndarray, sub: np.ndarray, u: int
             ) -> tuple[int, int]:
    """One M-span of the MD walk, vectorized; returns (u, n_mismatch)."""
    ref = np.asarray(ref, dtype=np.uint8)
    sub = np.asarray(sub, dtype=np.uint8)
    mis = np.flatnonzero((ref > 3) | (sub > 3) | (ref != sub))
    if len(mis) == 0:
        return u + len(ref), 0
    gaps = np.empty(len(mis), dtype=np.int64)
    gaps[0] = u + int(mis[0])
    gaps[1:] = mis[1:] - mis[:-1] - 1
    if int(gaps.max()) < 10:   # single-digit runs: one table lookup/pair
        idx = (gaps * 5 + ref[mis]).tolist()
        out.append("".join(map(_MD_PAIRS.__getitem__, idx)))
    else:
        bases = "ACGTN"
        refm = ref[mis].tolist()
        out.append("".join(str(g) + bases[c]
                           for g, c in zip(gaps.tolist(), refm)))
    return len(ref) - 1 - int(mis[-1]), len(mis)


def cal_md1(n_cigar: int, cigar: list[int] | None, length: int, pos: int,
            seq: np.ndarray, dbs: DbSet, nt: bool = False
            ) -> tuple[str, int]:
    """bwa_cal_md1 (bwase.c:243-295): MD tag + NM count.

    The walk itself runs natively (sam_text.cpp) with ONE reference
    extraction for the whole span; IBWA_PURE_PY=1 forces this Python
    implementation (the oracle)."""
    import os
    if not os.environ.get("IBWA_PURE_PY"):
        return _cal_md1_native(cigar, length, pos, seq, dbs, nt)
    out = []
    nm = 0
    x, y, u = pos, 0, 0
    if cigar:
        for c in cigar:
            ln = cigar_len(c)
            op = cigar_op(c)
            if op == FROM_M:
                span = min(ln, max(dbs.l_pac - x, 0))
                if span > 0:
                    ref = dbs.extract_sequence(x, span, nt=nt)
                    u, add = _md_span(out, ref, seq[y:y + len(ref)], u)
                    nm += add
                x += ln
                y += ln
            elif op in (FROM_I, FROM_S):
                y += ln
                if op == FROM_I:
                    nm += ln
            elif op == FROM_D:
                out.append(f"{u}")
                out.append("^")
                span = min(ln, max(dbs.l_pac - x, 0))
                if span > 0:
                    ref = dbs.extract_sequence(x, span, nt=nt)
                    out.append(_BASE_CHARS[np.asarray(ref, np.uint8)]
                               .tobytes().decode())
                u = 0
                x += ln
                nm += ln
    else:
        span = min(length, max(dbs.l_pac - x, 0))
        if span > 0:
            ref = dbs.extract_sequence(x, span, nt=nt)
            u, nm = _md_span(out, ref, seq[:len(ref)], u)
    out.append(f"{u}")
    return "".join(out), nm


_MD_STATE: list | None = None


def _cal_md1_native(cigar: list[int] | None, length: int, pos: int,
                    seq: np.ndarray, dbs: DbSet, nt: bool) -> tuple[str, int]:
    import ctypes

    global _MD_STATE
    if _MD_STATE is None:
        lib = native.load()
        _MD_STATE = [lib, ctypes.create_string_buffer(1 << 16),
                     np.zeros(1, dtype=np.int32),
                     np.zeros(1, np.int32).ctypes.data_as(
                         ctypes.POINTER(ctypes.c_int32))]
        _MD_STATE[3] = _MD_STATE[2].ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32))
    lib, out, nm, nm_p = _MD_STATE
    if cigar:
        need = sum(cigar_len(c) for c in cigar
                   if cigar_op(c) in (FROM_M, FROM_D))
        carr = np.asarray(cigar, dtype=np.uint32)
        ncig = len(cigar)
    else:
        need = length
        carr = _MD_ZCIG
        ncig = 0
    span = min(need, max(dbs.l_pac - pos, 0))
    if span > 0:
        # zero-copy fast path: span within one db's pac (always true for
        # single-db samse; extract_sequence copies across boundaries)
        db = dbs.dbs[dbs.coord2idx(pos)] if len(dbs.dbs) > 1 else dbs.dbs[0]
        local = pos - db.offset
        if local + span <= db.bns.l_pac and not nt:
            ref = db.load_pac()[local:local + span]
        else:
            ref = dbs.extract_sequence(pos, span, nt=nt)
    else:
        ref = _MD_ZREF
    if not ref.flags.c_contiguous:
        ref = np.ascontiguousarray(ref)
    read = seq if seq.flags.c_contiguous else np.ascontiguousarray(seq)
    cap = 16 + 2 * need + 12 * (ncig + 1) + len(read)
    if cap > len(out):
        out = ctypes.create_string_buffer(2 * cap)
        _MD_STATE[1] = out
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ibwa_cal_md(
        carr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), ncig,
        ref.ctypes.data_as(u8p), len(ref), pos, dbs.l_pac,
        read.ctypes.data_as(u8p), length, out, cap, nm_p)
    if n < 0:
        raise RuntimeError("ibwa_cal_md: buffer overflow")
    import ctypes as _ct
    return _ct.string_at(out, n).decode("ascii"), int(nm[0])


_MD_ZCIG = np.zeros(1, dtype=np.uint32)
_MD_ZREF = np.zeros(0, dtype=np.uint8)


def correct_trimmed(s: AlnSeq) -> None:
    """bwa_correct_trimmed (bwase.c:297-331)."""
    r = s.read
    if s.len == r.full_len:
        return
    pad = r.full_len - s.len
    if s.strand == 0:
        if s.cigar and cigar_op(s.cigar[-1]) == FROM_S:
            s.cigar[-1] += pad
        else:
            if s.cigar is None:
                s.cigar = [cigar_create(0, s.len)]
            s.cigar.append(cigar_create(3, pad))
    else:
        if s.cigar and cigar_op(s.cigar[0]) == FROM_S:
            s.cigar[0] += pad
        else:
            if s.cigar is None:
                s.cigar = [cigar_create(0, s.len)]
            s.cigar.insert(0, cigar_create(3, pad))
    s.len = r.full_len


def refine_gapped(dbs: DbSet, seqs: list[AlnSeq]) -> None:
    """bwa_refine_gapped (bwase.c:333-449), nucleotide space."""
    for s in seqs:
        r = s.read
        remapped_gapo = 0
        db = dbs.dbs[s.dbidx]
        if db.remap is not None and s.remapped_seqid in db.remap:
            remapped_gapo += db.remap[s.remapped_seqid].n_gapo
        # seq_reverse(s->len, s->seq, 0): s->seq becomes forward-oriented
        s.seq_fwd = r.seq[::-1].copy()
        for q in s.multi:
            if q.gap == 0:
                continue
            qseq = r.rseq if q.strand else s.seq_fwd
            q.cigar, q.pos = refine_gapped_core(
                dbs, q.dbidx, q.remapped_seqid, s.len, qseq, q.pos,
                (1 if q.strand else -1) * q.gap, 1)
        if s.type in (TYPE_NO_MATCH, TYPE_MATESW) or (
                s.n_gapo == 0 and remapped_gapo == 0):
            continue
        sseq = r.rseq if s.strand else s.seq_fwd
        s.cigar, s.pos = refine_gapped_core(
            dbs, s.dbidx, s.remapped_seqid, s.len, sseq, s.pos,
            (1 if s.strand else -1) * (s.n_gapo + s.n_gape), 1)

    if dbs.color_space:  # bwase.c:367-388: decode + re-refine vs ntpac
        from . import cs2nt
        for s in seqs:
            cs2nt.bwa_cs2nt_core(s, dbs)
            for q in s.multi:
                if q.gap == 0:
                    continue
                q.cigar, q.pos = refine_gapped_core(
                    dbs, q.dbidx, s.remapped_seqid, s.len, s.seq_fwd,
                    q.pos, (1 if q.strand else -1) * q.gap, 0, nt=True)
            if s.type != TYPE_NO_MATCH and s.cigar:
                s.cigar, s.pos = refine_gapped_core(
                    dbs, s.dbidx, s.remapped_seqid, s.len, s.seq_fwd,
                    s.pos, (1 if s.strand else -1) * (s.n_gapo + s.n_gape),
                    0, nt=True)

    for s in seqs:
        if s.type != TYPE_NO_MATCH:
            # reference quirk: MD/NM computed at remapped_pos (bwase.c:367)
            if s.conv is not None:
                sseq = s.seq_fwd
            else:
                sseq = s.read.rseq if s.strand else s.seq_fwd
            n_cigar = len(s.cigar) if s.cigar else 0
            s.md, s.nm = cal_md1(n_cigar, s.cigar, s.len, s.remapped_pos,
                                 sseq, dbs, nt=dbs.color_space)

    if not dbs.color_space:  # trimming is Illumina-only (bwase.c:441)
        for s in seqs:
            correct_trimmed(s)


def pos_end(s: AlnSeq) -> int:
    if s.cigar:
        x = s.pos
        for c in s.cigar:
            if cigar_op(c) in (0, 2):
                x += cigar_len(c)
        return x
    return s.pos + s.len


def pos_end_multi(q: Multi, length: int) -> int:
    if q.cigar:
        x = q.pos
        for c in q.cigar:
            if cigar_op(c) in (0, 2):
                x += cigar_len(c)
        return x
    return q.pos + length


def pos_5(s: AlnSeq) -> int:
    if s.type != TYPE_NO_MATCH:
        return pos_end(s) if s.strand else s.pos
    return -1


def cigar_str(cigar: list[int]) -> str:
    return "".join(f"{cigar_len(c)}{'MIDSN'[cigar_op(c)]}" for c in cigar)


def print_sam1(dbs: DbSet, p: AlnSeq, mate: AlnSeq | None, mode: int,
               max_top2: int, out: TextIO, rg_id: str | None = None) -> None:
    """bwa_print_sam1 (bwase.c:451-581)."""
    w: list = []   # one out.write per record
    r = p.read
    if p.type != TYPE_NO_MATCH or (mate and mate.type != TYPE_NO_MATCH):
        am = 0
        flag = p.extra_flag
        if p.type == TYPE_NO_MATCH:
            p.pos = mate.pos
            p.remapped_pos = mate.remapped_pos
            p.strand = mate.strand
            flag |= SAM_FSU
            j = 1
        else:
            j = pos_end(p) - p.pos

        nn, seqid, bns, bnsoffset = dbs.coor_pac2real(p.pos, j)
        if p.type != TYPE_NO_MATCH and \
                p.pos + j - (bns.anns[seqid].offset + bnsoffset) \
                > bns.anns[seqid].length:
            flag |= SAM_FSU  # bridges two adjacent reference sequences

        if p.strand:
            flag |= SAM_FSR
        if mate:
            if mate.type != TYPE_NO_MATCH:
                if mate.strand:
                    flag |= SAM_FMR
            else:
                flag |= SAM_FMU
        w.append(f"{r.name}\t{flag}\t{bns.anns[seqid].name}\t")
        w.append(f"{p.pos - (bns.anns[seqid].offset + bnsoffset) + 1}"
                  f"\t{p.mapQ}\t")

        if p.cigar:
            w.append(cigar_str(p.cigar))
        elif p.type == TYPE_NO_MATCH:
            w.append("*")
        else:
            w.append(f"{p.len}M")

        if mate and mate.type != TYPE_NO_MATCH:
            am = min(mate.seQ, p.seQ)
            _, m_seqid, m_bns, m_bnsoffset = dbs.coor_pac2real(
                mate.pos, mate.len)
            same = (seqid == m_seqid and bnsoffset == m_bnsoffset)
            w.append("\t" + ("=" if same else m_bns.anns[m_seqid].name)
                      + "\t")
            isize = pos_5(mate) - pos_5(p) if same else 0
            if p.type == TYPE_NO_MATCH:
                isize = 0
            w.append(f"{mate.pos - (m_bns.anns[m_seqid].offset + m_bnsoffset) + 1}"
                      f"\t{isize}\t")
        elif mate:
            w.append(f"\t=\t{p.pos - (bns.anns[seqid].offset + bnsoffset) + 1}"
                      f"\t0\t")
        else:
            w.append("\t*\t0\t0\t")

        # sequence + quality (original read orientation rules)
        if p.conv is not None:  # color mode: decoded nucleotide read
            w.append(_BASE_CHARS[np.asarray(p.conv, np.uint8)]
                      .tobytes().decode("latin-1"))
            w.append("\t")
            w.append(p.conv_qual.decode("latin-1") if p.conv_qual
                      else "*")
        else:
            orig = np.asarray(r.orig, np.uint8)
            if p.strand == 0:
                w.append(_BASE_CHARS[orig].tobytes().decode("latin-1"))
            else:
                w.append(_COMP_CHARS[orig[::-1]].tobytes()
                          .decode("latin-1"))
            w.append("\t")
            if r.qual is not None:
                q = r.qual
                if p.strand:
                    q = q[:p.len][::-1] + q[p.len:]
                w.append(q.decode("latin-1"))
            else:
                w.append("*")

        if rg_id:
            w.append(f"\tRG:Z:{rg_id}")
        if r.bc:
            w.append(f"\tBC:Z:{r.bc}")
        if r.clip_len < r.full_len:
            w.append(f"\tXC:i:{r.clip_len}")
        if p.type != TYPE_NO_MATCH:
            XT = "NURM"[p.type]
            if nn > 10:
                XT = "N"
            tag = "NM" if mode & BWA_MODE_COMPREAD else "CM"
            w.append(f"\tXT:A:{XT}\t{tag}:i:{p.nm}")
            if nn:
                w.append(f"\tXN:i:{nn}")
            if mate:
                w.append(f"\tSM:i:{p.seQ}\tAM:i:{am}")
            if p.type != TYPE_MATESW:
                w.append(f"\tX0:i:{p.c1}")
                if p.c1 <= max_top2:
                    w.append(f"\tX1:i:{p.c2}")
            w.append(f"\tXM:i:{p.n_mm}\tXO:i:{p.n_gapo}"
                      f"\tXG:i:{p.n_gapo + p.n_gape}")
            if p.md:
                w.append(f"\tMD:Z:{p.md}")
            if p.multi:
                w.append("\tXA:Z:")
                for q in p.multi:
                    j = pos_end_multi(q, p.len) - q.pos
                    nn, seqid, bns, bnsoffset = dbs.coor_pac2real(q.pos, j)
                    w.append(f"{bns.anns[seqid].name},"
                              f"{'-' if q.strand else '+'}"
                              f"{q.pos - (bns.anns[seqid].offset + bnsoffset) + 1},")
                    w.append(cigar_str(q.cigar) if q.cigar
                              else f"{p.len}M")
                    w.append(f",{q.gap + q.mm};")
        if p.pos != p.remapped_pos:
            _, rseqid, rbns, rbnsoffset = dbs.coor_pac2real(
                p.remapped_pos, j)
            w.append(f"\tZR:Z:{rbns.anns[rseqid].name},"
                      f"{p.remapped_pos - (rbns.anns[rseqid].offset + rbnsoffset) + 1}")
        w.append("\n")
        out.write("".join(w))
    else:  # no match
        flag = p.extra_flag | SAM_FSU
        if mate and mate.type == TYPE_NO_MATCH:
            flag |= SAM_FMU
        w.append(f"{r.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t")
        s = r.rseq if p.strand else r.orig
        w.append(_BASE_CHARS[np.asarray(s[:p.len], np.uint8)]
                  .tobytes().decode("latin-1"))
        w.append("\t")
        if r.qual is not None:
            q = r.qual
            if p.strand:
                q = q[:p.len][::-1] + q[p.len:]
            w.append(q.decode("latin-1"))
        else:
            w.append("*")
        if rg_id:
            w.append(f"\tRG:Z:{rg_id}")
        if r.bc:
            w.append(f"\tBC:Z:{r.bc}")
        if r.clip_len < r.full_len:
            w.append(f"\tXC:i:{r.clip_len}")
        w.append("\n")
        out.write("".join(w))


def print_sam_PG(out: TextIO, version: str = "0.5.9-ibwa (Release)") -> None:
    out.write(f"@PG\tID:bwa\tPN:bwa\tVN:{version}\n")


def parse_rg(s: str) -> tuple[str | None, str | None]:
    """bwa_set_rg (bwase.c:628-646): unescape + extract the ID field."""
    if not s.startswith("@RG"):
        return None, None
    line = (s.replace("\\t", "\t").replace("\\n", "\n")
            .replace("\\r", "\r").replace("\\\\", "\\"))
    at = line.find("\tID:")
    if at < 0:
        return line, None
    end = at + 4
    while end < len(line) and line[end] not in "\t\n":
        end += 1
    return line, line[at + 4:end]


BATCH = 0x40000


def sai2sam_se(prefix: str, sai_path: str, fq_path: str, n_occ: int = 3,
               out: TextIO = sys.stdout, rg_line: str | None = None,
               rg_id: str | None = None) -> None:
    """bwa_sai2sam_se_core (bwase.c:643-708)."""
    with open(sai_path, "rb") as fp:
        opt = sai.read_header(fp)
        color = not (opt.mode & BWA_MODE_COMPREAD)
        dbs = DbSet([prefix], color_space=color)
        rng = Rand48(dbs.dbs[0].bns.seed)
        out.write(dbs.sam_SQ(rg_line))
        print_sam_PG(out)
        import os
        nat = None
        rb = None
        if not os.environ.get("IBWA_PURE_PY") and not color:
            import dataclasses as _dc
            from .pe_native import PeNative, scan_sai_batch

            @_dc.dataclass
            class _Popt:
                remapping: int = 0

            nat = PeNative(dbs, _Popt(), opt)
            blob = fp.read()
            cursor = 0
            if opt.trim_qual < 1 and not (opt.mode & 0x200) \
                    and not (opt.mode >> 24):
                from ..io.reads import load_read_batch
                rb = load_read_batch(fq_path)
        if rb is None:
            reads = load_reads(fq_path, trim_qual=opt.trim_qual,
                               is_comp=not color,
                               is_64=bool(opt.mode & 0x200),
                               l_bc=opt.mode >> 24)
            n_reads = len(reads)
        else:
            n_reads = rb.n
        for start in range(0, n_reads, BATCH):
            n = min(BATCH, n_reads - start)
            if nat is not None:
                # fully native batch: selection -> SA resolution -> refine
                # -> MD -> print, one call chain with no per-read Python
                from .pe_native import scan_sai_batch
                counts, recs, used = scan_sai_batch(blob[cursor:], n)
                cursor += used
                nat.set_sai_batch(0, 0, counts, recs, n)
                i64, i32, mc, mpos, mmeta, cap = nat.se_select_arrays(
                    n, n_occ, rng)
                if rb is not None:
                    lens = rb.lens[start:start + n]
                    fulls = rb.fulls[start:start + n]
                else:
                    batch = reads[start:start + n]
                    lens = np.array([r.clip_len for r in batch],
                                    dtype=np.int32)
                    fulls = np.array([r.full_len for r in batch],
                                     dtype=np.int32)
                if opt.fnr > 0.0:
                    md_by_len = {int(v): cal_maxdiff(int(v), BWA_AVG_ERR,
                                                     opt.fnr)
                                 for v in np.unique(lens)}
                    mdiff = np.array([md_by_len[int(v)] for v in lens],
                                     dtype=np.int32)
                else:
                    mdiff = np.full(n, opt.max_diff, dtype=np.int32)
                if rb is not None:
                    sl = slice(start, start + n + 1)
                    text = nat.emit_blobs(
                        n, rb.orig_blob[int(rb.orig_off[start]):],
                        rb.orig_off[sl] - rb.orig_off[start],
                        rb.qual_blob[int(rb.qual_off[start]):],
                        rb.qual_off[sl] - rb.qual_off[start],
                        rb.name_blob[int(rb.name_off[start]):],
                        rb.name_off[sl] - rb.name_off[start],
                        np.zeros(1, np.uint8),
                        np.zeros(n + 1, np.int64),
                        lens, fulls, mdiff, i64, i32, mc, mpos, mmeta,
                        cap, None, opt.mode, opt.max_top2, rg_id,
                        is_pe=False, se_mode=True)
                else:
                    text = nat.emit(batch, lens, fulls, mdiff, i64, i32,
                                    mc, mpos, mmeta, cap, None, opt.mode,
                                    opt.max_top2, rg_id, is_pe=False,
                                    se_mode=True)
                out.write(text.decode("latin-1"))
            else:
                batch = reads[start:start + n]
                seqs = []
                for r in batch:
                    s = AlnSeq(read=r)
                    hits = sai.read_read_hits(fp)
                    aln2seq_core(hits or [], s, True, n_occ, rng)
                    seqs.append(s)
                cal_pac_pos(dbs, seqs, opt.max_diff, opt.fnr)
                refine_gapped(dbs, seqs)
                for s in seqs:
                    print_sam1(dbs, s, None, opt.mode, opt.max_top2, out,
                               rg_id)
            print(f"[samse] {start + n} sequences processed",
                  file=sys.stderr)
