"""BWA-SW driver: per-read pipeline, seed chaining, extension, CIGAR and
SAM emission (bwtsw2_aux.c + bwtsw2_chain.c + bwtsw2_main.c).

Copy of `ibwa_tpu/bwasw/aux.py`: the port keeps its own host code and
imports nothing of `ibwa_tpu`.  What differs: `bsw2_aln` takes the route
of the seed extensions as arguments (`engine`, `device`, `min_jobs`) in
place of the JAX package's environment switch, installs the device route
for one run only, and prints where the extensions ran; `Bsw2Native.run`
passes the native driver's switches (`min_jobs`, `staged`) as arguments,
keeps its stage timers and job counts (`last_stats`), and raises the
device route's exception when a batch failed.  `IBWA_PURE_PY=1` still runs the Python
pipeline (host extensions only), the oracle of the native driver.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import TextIO

import numpy as np

from .. import native
from ..fm.fmindex import FmIndex
from ..index import formats
from ..index.builder import load_index
from ..index.formats import NT4_TABLE, Bns
from ..rng import Rand48
from . import dp_glue
from .bwtl import Bwtl
from .core import (Bsw2Opt, Hit, HitList, bsw2_core, resolve_duphits,
                   resolve_query_overlaps)

NT_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
           "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}


def _gen_matrix(opt: Bsw2Opt) -> np.ndarray:
    """__gen_ap (bwtsw2_aux.c:70-77): match a, everything else -b."""
    m = np.full(25, -opt.b, dtype=np.int32)
    for i in range(4):
        m[i * 5 + i] = opt.a
    return m


@dataclasses.dataclass
class Chain:
    """hsaip_t (bwtsw2_chain.c:4-10)."""

    tbeg: int
    tend: int
    qbeg: int
    qend: int
    flag: int
    idx: int
    chain: int


def _chaining(opt: Bsw2Opt, shift: int, z: list[Chain]) -> list[Chain]:
    """chaining (bwtsw2_chain.c:16-42)."""
    z.sort(key=lambda a: a.qbeg)
    chains: list[Chain] = []
    for p in z:
        k = len(chains) - 1
        while k >= 0:
            q = chains[k]
            x = p.qbeg - q.qbeg
            y = p.tbeg - q.tbeg
            if y > 0 and x - y <= opt.bw and y - x <= opt.bw:
                if p.qend > q.qend:
                    q.qend = p.qend
                if p.tend > q.tend:
                    q.tend = p.tend
                q.chain += 1
                p.chain = shift + k
                break
            k -= 1
        if k < 0:
            c = dataclasses.replace(p)
            c.chain = 1
            c.idx = shift + len(chains)
            p.chain = shift + len(chains)
            chains.append(c)
    return chains


def chain_filter(opt: Bsw2Opt, length: int, b: tuple[HitList, HitList]
                 ) -> None:
    """bsw2_chain_filter (bwtsw2_chain.c:44-107)."""
    z = [[], []]
    for k in range(2):
        for i, p in enumerate(b[k].hits):
            z[k].append(Chain(tbeg=p.k, tend=p.k + p.len, qbeg=p.beg,
                              qend=p.end, flag=k, idx=i, chain=-1))
    chains0 = _chaining(opt, 0, z[0])
    chains1 = _chaining(opt, len(chains0), z[1])
    for p in chains1:
        tmp = p.qbeg
        p.qbeg = length - p.qend
        p.qend = length - tmp
    allc = chains0 + chains1
    flag = [0] * len(allc)
    order = sorted(allc, key=lambda a: a.qbeg)
    for k in range(1, len(order)):
        p = order[k]
        for q in order[:k]:
            if flag[q.idx]:
                continue
            if q.qend >= p.qend and q.chain > p.chain * opt.t_seeds * 2:
                flag[p.idx] = 1
                break
    for k in range(2):
        for p in z[k]:
            if flag[p.chain]:
                b[p.flag].hits[p.idx].G = 0
        b[k].hits = [h for h in b[k].hits if h.G]


def _pac_base(pac: np.ndarray, k: int) -> int:
    return int(pac[k])


def extend_left(opt: Bsw2Opt, b: HitList, query: np.ndarray, lq: int,
                pac: np.ndarray, l_pac: int, is_rev: bool,
                matrix: np.ndarray) -> None:
    """bsw2_extend_left (bwtsw2_aux.c:80-129); pac is UNPACKED codes."""
    b.hits.sort(key=lambda h: -h.end)  # __left_lt: (a).end > (b).end
    rquery = query[::-1]
    for i, p in enumerate(b.hits):
        p.n_seeds = 1
        if p.l or p.k == 0:
            continue
        score = 0
        for q in b.hits[:i]:
            if (q.beg <= p.beg and q.k <= p.k
                    and q.k + q.len >= p.k + p.len):
                if q.n_seeds < (1 << 14) - 2:
                    q.n_seeds += 1
                score += 1
        if score:
            continue
        lt = ((p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
        if lt > p.k:
            lt = p.k
        # target = reversed reference upstream of p.k (k=0 not included,
        # matching the reference's FIXME)
        if is_rev:
            idx = l_pac - 1 - np.arange(p.k - 1, max(p.k - 1 - lt, 0), -1)
            target = pac[idx]
        else:
            target = pac[p.k - 1:max(p.k - 1 - lt, 0):-1]
        lt = len(target)
        sc, end_i, end_j = native.extend_aln(
            target, rquery[lq - p.beg:lq], opt.q, opt.r, opt.bw, matrix,
            p.G)
        if sc > p.G:
            p.G = sc
            p.len += end_i
            p.beg -= end_j
            p.k -= end_i


def extend_rght(opt: Bsw2Opt, b: HitList, query: np.ndarray, lq: int,
                pac: np.ndarray, l_pac: int, is_rev: bool,
                matrix: np.ndarray) -> None:
    """bsw2_extend_rght (bwtsw2_aux.c:131-164)."""
    for p in b.hits:
        if p.l:
            continue
        lt = ((lq - p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
        hi = min(p.k + lt, l_pac)
        if is_rev:
            idx = l_pac - 1 - np.arange(p.k, hi)
            target = pac[idx]
        else:
            target = pac[p.k:hi]
        sc, end_i, end_j = native.extend_aln(
            target, query[p.beg:lq], opt.q, opt.r, opt.bw, matrix, 1)
        if sc >= p.G:
            p.G = sc
            p.len = end_i
            p.end = end_j + p.beg


def merge_hits(b: list[HitList], length: int, is_reverse: bool) -> None:
    """merge_hits (bwtsw2_aux.c:231-252)."""
    for p in b[1].hits:
        if is_reverse:
            x = p.beg
            p.beg = length - p.end
            p.end = length - x
            p.flag |= 0x10
        b[0].hits.append(p)
    b[1] = None  # type: ignore[assignment]


def _core_native(opt: Bsw2Opt, seq_codes: np.ndarray, fm: FmIndex
                 ) -> tuple[HitList, HitList]:
    """bsw2_core via the compiled implementation (native/src/bsw2.cpp —
    the reference's hot loop, bwtsw2_core.c:429-594); byte-compatible
    with core.py::bsw2_core which remains the oracle (IBWA_PURE_PY=1)."""
    arr_b, arr_b1 = native.bsw2_core(
        fm, seq_codes, opt.a, opt.b, opt.q, opt.r, opt.t, opt.bw, opt.z,
        opt.is_)
    out = []
    for arr in (arr_b, arr_b1):
        hl = HitList()
        hl.hits = [Hit(k=int(r[0]), l=int(r[1]), flag=int(r[2]),
                       n_seeds=int(r[3]), len=int(r[4]), G=int(r[5]),
                       G2=int(r[6]), beg=int(r[7]), end=int(r[8]))
                   for r in arr]
        out.append(hl)
    return out[0], out[1]


def aln1_core(opt: Bsw2Opt, bns: Bns, pac: np.ndarray, target_fm: FmIndex,
              length: int, seq: list[np.ndarray], is_rev: bool,
              matrix: np.ndarray, rng: Rand48) -> HitList:
    """bsw2_aln1_core (bwtsw2_aux.c:252-276)."""
    import os
    use_native = not os.environ.get("IBWA_PURE_PY")
    bb = []
    for k in range(2):
        if use_native:
            b_all, b_narrow = _core_native(opt, seq[k], target_fm)
        else:
            query_bwtl = Bwtl(seq[k])
            b_all, b_narrow = bsw2_core(opt, query_bwtl, target_fm)
        bb.append([b_all, b_narrow])
    pair = (bb[0][1], bb[1][1])
    chain_filter(opt, length, pair)
    b = [None, None]
    for k in range(2):
        extend_left(opt, bb[k][1], seq[k], length, pac, bns.l_pac, is_rev,
                    matrix)
        merge_hits(bb[k], length, False)
        resolve_duphits(None, bb[k][0], 0)
        extend_rght(opt, bb[k][0], seq[k], length, pac, bns.l_pac, is_rev,
                    matrix)
        b[k] = bb[k][0]
    merge_hits(b, length, True)
    resolve_query_overlaps(b[0], opt.mask_level, rng)
    return b[0]


def flag_fr(b: list[HitList]) -> None:
    """flag_fr (bwtsw2_aux.c:279-300)."""
    for p in b[0].hits:
        p.flag |= 0x10000
    for p in b[1].hits:
        p.flag |= 0x20000
    for p in b[0].hits:
        for q in b[1].hits:
            if (q.beg == p.beg and q.end == p.end and q.k == p.k
                    and q.len == p.len and q.G == p.G):
                q.flag |= 0x30000
                p.flag |= 0x30000
                break


def gen_cigar(opt: Bsw2Opt, lq: int, seq: list[np.ndarray],
              pac: np.ndarray, b: HitList, matrix: np.ndarray) -> None:
    """gen_cigar (bwtsw2_aux.c:167-216); cigars use op&0xf | len<<4
    (the samtools encoding, NOT bwa_cigar_t)."""
    b.cigars = [None] * b.n
    for i, p in enumerate(b.hits):
        if p.l:
            continue
        beg = lq - p.end if p.flag & 0x10 else p.beg
        end = lq - p.beg if p.flag & 0x10 else p.end
        query = seq[1 if p.flag & 0x10 else 0][beg:end]
        target = pac[p.k:p.k + p.len]
        cigar_bwa, _score = native.global_aln(
            target, query, gap_open=opt.q, gap_ext=opt.r, gap_end=opt.r,
            band=opt.bw, matrix=matrix)
        # convert op<<29|len -> len<<4|op
        cigar = [((c & 0x1FFFFFFF) << 4) | (c >> 29) for c in cigar_bwa]
        if beg != 0 or end < lq:
            if beg != 0:
                cigar.insert(0, beg << 4 | 4)
            if end < lq:
                cigar.append((lq - end) << 4 | 4)
        b.cigars[i] = cigar


def fix_cigar(bns: Bns, dbs_helper, p: Hit, cigar: list[int]) -> list[int]:
    """fix_cigar (bwtsw2_aux.c:316-386): split a CIGAR straddling two
    adjacent reference sequences, keep the longer-M side."""
    seqid = dbs_helper.seq_for_pos(bns, p.k)
    coor = p.k - bns.anns[seqid].offset
    refl = bns.anns[seqid].length
    x, y = coor, 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (1, 4, 5):
            y += ln
        elif op == 2:
            x += ln
        else:
            x += ln
            y += ln
    lq = y
    if x <= refl:
        return cigar
    nc = 0
    mq = [0, 0]
    nlen = [0, 0]
    cn: list[int] = []
    kk = 0
    x, y = coor, 0
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if op in (4, 5, 1):
            y += ln
            cn.append(c)
        elif op == 2:
            if x + ln >= refl and nc == 0:
                cn.append((lq - y) << 4 | 4)
                nc = len(cn)
                cn.append(y << 4 | 4)
                kk = p.k + (x + ln - refl)
                nlen[0] = x - coor
                nlen[1] = p.len - nlen[0] - ln
            else:
                cn.append(c)
            x += ln
        elif op == 0:
            if x + ln >= refl and nc == 0:
                cn.append((refl - x) << 4 | 0)
                cn.append((lq - y - (refl - x)) << 4 | 4)
                nc = len(cn)
                mq[0] += refl - x
                cn.append((y + (refl - x)) << 4 | 4)
                if x + ln - refl:
                    cn.append((x + ln - refl) << 4 | 0)
                mq[1] += x + ln - refl
                kk = bns.anns[seqid].offset + refl
                nlen[0] = refl - coor
                nlen[1] = p.len - nlen[0]
            else:
                cn.append(c)
                mq[1 if nc else 0] += ln
            x += ln
            y += ln
    if mq[0] > mq[1]:  # take the first part
        p.len = nlen[0]
        return cn[:nc]
    p.k = kk
    p.len = nlen[1]
    return cn[nc:]


class _BnsHelper:
    """bns_seq_for_pos (bntseq.c:278-294) over a standalone Bns."""

    @staticmethod
    def seq_for_pos(bns: Bns, pac_coor: int) -> int:
        left, mid, right = 0, 0, bns.n_seqs
        while left < right:
            mid = (left + right) >> 1
            if pac_coor >= bns.anns[mid].offset:
                if mid == bns.n_seqs - 1:
                    break
                if pac_coor < bns.anns[mid + 1].offset:
                    break
                left = mid + 1
            else:
                right = mid
        return mid

    @staticmethod
    def coor_pac2real(bns: Bns, pac_coor: int, length: int
                      ) -> tuple[int, int]:
        seqid = _BnsHelper.seq_for_pos(bns, pac_coor)
        left, right, nn = 0, bns.n_holes, 0
        while left < right:
            mid = (left + right) >> 1
            h = bns.ambs[mid]
            if pac_coor >= h.offset + h.length:
                left = mid + 1
            elif pac_coor + length <= h.offset:
                right = mid
            else:
                if pac_coor >= h.offset:
                    nn += (h.offset + h.length - pac_coor
                           if h.offset + h.length < pac_coor + length
                           else length)
                else:
                    nn += (h.length
                           if h.offset + h.length < pac_coor + length
                           else length - (h.offset - pac_coor))
                break
        return nn, seqid


def print_hits(bns: Bns, opt: Bsw2Opt, name: str, seq_str: str,
               qual: str | None, b: HitList | None, out: TextIO) -> None:
    """print_hits (bwtsw2_aux.c:390-455)."""
    L = len(seq_str)
    if b is None or b.n == 0:
        out.write(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_str}")
        out.write(f"\t{qual}\n" if qual else "\t*\n")
        return
    for i, p in enumerate(b.hits):
        seqid = -1
        coor = -1
        nn = 0
        cigar = b.cigars[i]
        if p.l == 0:
            cigar = fix_cigar(bns, _BnsHelper, p, cigar)
            b.cigars[i] = cigar
            nn, seqid = _BnsHelper.coor_pac2real(bns, p.k, p.len)
            coor = p.k - bns.anns[seqid].offset
        out.write(f"{name}\t{p.flag & 0x10}")
        out.write(f"\t{bns.anns[seqid].name if seqid >= 0 else '*'}"
                  f"\t{coor + 1}")
        if p.l == 0:
            c = 1.0
            subo = p.G2 if p.G2 > opt.t else opt.t
            if p.flag >> 16 in (1, 2):
                c *= 0.5
            if p.n_seeds < 2:
                c *= 0.2
            qual_v = int(c * (p.G - subo) * (250.0 / p.G + 0.03 / opt.a)
                         + 0.499)
            if qual_v > 250:
                qual_v = 250
            if p.flag & 1:
                qual_v = 0
            out.write(f"\t{qual_v}\t")
            ops = "MIDNHHP" if opt.hard_clip else "MIDNSHP"
            out.write("".join(f"{c2 >> 4}{ops[c2 & 0xF]}" for c2 in cigar))
        else:
            out.write("\t0\t*")
        out.write("\t*\t0\t0\t")
        beg, end = 0, L
        if opt.hard_clip:
            if (cigar[0] & 0xF) == 4:
                beg += cigar[0] >> 4
            if (cigar[-1] & 0xF) == 4:
                end -= cigar[-1] >> 4
        if p.flag & 0x10:
            out.write("".join(NT_COMP.get(seq_str[L - 1 - j], "N")
                              for j in range(beg, end)))
        else:
            out.write(seq_str[beg:end])
        if qual:
            out.write("\t")
            if p.flag & 0x10:
                out.write("".join(qual[L - 1 - j] for j in range(beg, end)))
            else:
                out.write(qual[beg:end])
        else:
            out.write("\t*")
        out.write(f"\tAS:i:{p.G}\tXS:i:{p.G2}\tXF:i:{p.flag >> 16}"
                  f"\tXE:i:{p.n_seeds}\tXN:i:{nn}")
        if p.l:
            out.write(f"\tXI:i:{p.l - p.k + 1}")
        out.write("\n")


def bsw2_aln_one(opt0: Bsw2Opt, bns: Bns, pac: np.ndarray,
                 fms: tuple[FmIndex, FmIndex], name: str, seq_str: str,
                 qual: str | None, rng: Rand48, out: TextIO) -> None:
    """One read of bsw2_aln_core (bwtsw2_aux.c:459-545)."""
    l = len(seq_str)
    opt = dataclasses.replace(opt0)
    if opt.t < math.log(l) * opt.coef:
        opt.t = int(math.log(l) * opt.coef + 0.499)
    k = (l * opt.a - 2 * opt.q) // (2 * opt.r + opt.a)
    i = (l * opt.a - opt.a - opt.t) // opt.r
    if k > i:
        k = i
    if k < 1:
        k = 1
    opt.bw = min(opt0.bw, k)

    raw = np.frombuffer(seq_str.encode("latin-1"), dtype=np.uint8)
    codes = NT4_TABLE[raw].copy()
    amb = np.flatnonzero(codes >= 4)
    n_amb = len(amb)
    for i in amb:  # rng draws only for ambiguous bases, in read order
        codes[i] = int(rng.drand48() * 4)
    seq = [codes, (3 - codes)[::-1].copy()]
    rseq = [codes[::-1].copy(), (3 - codes).copy()]
    if l - n_amb < opt.t:
        print_hits(bns, opt, name, seq_str, qual, None, out)
        return

    matrix = _gen_matrix(opt)
    b0 = aln1_core(opt, bns, pac, fms[0], l, seq, False, matrix, rng)
    need_rev = any(h.n_seeds < opt.t_seeds for h in b0.hits)
    if need_rev:
        b1 = aln1_core(opt, bns, pac, fms[1], l, rseq, True, matrix, rng)
        for p in b1.hits:
            x = p.beg
            p.beg = l - p.end
            p.end = l - x
            if p.l == 0:
                p.k = bns.l_pac - (p.k + p.len)
        pair = [b0, b1]
        flag_fr(pair)
        merge_hits(pair, l, False)
        resolve_duphits(None, pair[0], 0)
        resolve_query_overlaps(pair[0], opt.mask_level, rng)
        b0 = pair[0]
    gen_cigar(opt, l, seq, pac, b0, matrix)
    print_hits(bns, opt, name, seq_str, qual, b0, out)


# ibwa_bsw2_run's stats, in its order (native/src/bsw2.cpp)
STATS = ("core_s", "ext_s", "cigar_s", "all_s", "core_pre_s",
         "core_fill_s", "core_save_s", "jobs", "callback_jobs",
         "host_jobs", "empty_jobs", "callback_batches", "host_batches",
         "callback_s", "host_loop_s")


class Bsw2Native:
    """Native per-read bwasw driver (bsw2.cpp's ibwa_bsw2_run): the whole
    bwtsw2_aux.c pipeline in C++.  aux.py's Python pipeline remains the
    oracle (IBWA_PURE_PY=1)."""

    def __init__(self, bns: Bns, prefix: str,
                 fms: tuple[FmIndex, FmIndex]):
        import ctypes

        self._ct = ctypes
        self._lib = native.load()
        pac_packed = np.fromfile(prefix + ".pac", dtype=np.uint8)
        l_pac = (len(pac_packed) - 2) * 4 + int(pac_packed[-1])
        pac_packed = pac_packed[:(l_pac + 3) // 4].copy()
        fmf, fmr = fms
        itl_f = np.ascontiguousarray(fmf._interleaved, dtype=np.uint32)
        itl_r = np.ascontiguousarray(fmr._interleaved, dtype=np.uint32)
        l2 = np.ascontiguousarray(fmf.L2, dtype=np.uint32)
        sa_f = np.ascontiguousarray(fmf.sa, dtype=np.uint32)
        sa_r = np.ascontiguousarray(fmr.sa, dtype=np.uint32)
        ann_off = np.array([a.offset for a in bns.anns], dtype=np.int64)
        ann_len = np.array([a.length for a in bns.anns], dtype=np.int64)
        names = [a.name.encode("latin-1") for a in bns.anns]
        name_off = np.zeros(len(names) + 1, dtype=np.int64)
        name_off[1:] = np.cumsum([len(s) for s in names])
        name_blob = np.frombuffer(b"".join(names) or b"\0", dtype=np.uint8)
        amb_off = np.array([h.offset for h in bns.ambs], dtype=np.int64)
        amb_len = np.array([h.length for h in bns.ambs], dtype=np.int64)
        self._keep = [pac_packed, itl_f, itl_r, l2, sa_f, sa_r, ann_off,
                      ann_len, name_blob, name_off, amb_off, amb_len]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        self._ctx = self._lib.ibwa_bsw2_new_ctx(
            p(itl_f, ctypes.c_uint32), fmf.primary,
            p(itl_r, ctypes.c_uint32), fmr.primary,
            p(l2, ctypes.c_uint32), fmf.seq_len, fmf.sa_intv,
            p(sa_f, ctypes.c_uint32), p(sa_r, ctypes.c_uint32),
            p(pac_packed, ctypes.c_uint8), bns.l_pac, bns.n_seqs,
            p(ann_off, ctypes.c_int64), p(ann_len, ctypes.c_int64),
            p(name_blob, ctypes.c_uint8), p(name_off, ctypes.c_int64),
            bns.n_holes, p(amb_off, ctypes.c_int64),
            p(amb_len, ctypes.c_int64))

    def run(self, opt: Bsw2Opt, names: list[bytes], seqs: list[bytes],
            quals: list[bytes], rng: Rand48,
            min_jobs: int = dp_glue.EXT_DEV_MIN, staged: bool = True,
            profile: bool = False) -> bytes:
        """The SAM text of a chunk of reads.  min_jobs: the least jobs of
        an extension batch the installed device route takes (`dp_glue`);
        staged: batch a segment's extensions (the default), or run the
        reads one by one; profile: time the core's sections too.
        `last_stats` gets the run's STATS."""
        ctypes = self._ct
        n = len(names)
        p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))

        def blob(parts):
            off = np.zeros(n + 1, dtype=np.int64)
            off[1:] = np.cumsum([len(x) for x in parts])
            return (np.frombuffer(b"".join(parts) or b"\0",
                                  dtype=np.uint8), off)

        seq_b, seq_o = blob(seqs)
        qual_b, qual_o = blob(quals)
        name_b, name_o = blob(names)
        st = np.array([rng.x], dtype=np.uint64)
        stats = np.zeros(len(STATS), dtype=np.float64)
        ln = self._lib.ibwa_bsw2_run(
            self._ctx, n, p(seq_b, ctypes.c_uint8),
            p(seq_o, ctypes.c_int64), p(qual_b, ctypes.c_uint8),
            p(qual_o, ctypes.c_int64), p(name_b, ctypes.c_uint8),
            p(name_o, ctypes.c_int64), p(st, ctypes.c_uint64),
            opt.a, opt.b, opt.q, opt.r, opt.t, opt.bw, opt.z, opt.is_,
            opt.t_seeds, opt.hard_clip, opt.mask_level, opt.coef,
            int(min_jobs), int(bool(staged)), int(bool(profile)),
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        self.last_stats = dict(zip(STATS, stats.tolist()))
        if ln == -2:   # a batch's callback failed: no SAM of this chunk
            raise dp_glue.error() or RuntimeError(
                "a batch of seed extensions failed on the device route")
        if ln < 0:
            raise RuntimeError("ibwa_bsw2_run failed")
        rng.x = int(st[0])
        return self._ct.string_at(self._lib.ibwa_bsw2_text(self._ctx), ln)

    def __del__(self):
        try:
            self._lib.ibwa_bsw2_free_ctx(self._ctx)
        except Exception:
            pass


def _native_chunks(opt: Bsw2Opt, nat: Bsw2Native, fq_path: str,
                   rng: Rand48, out: TextIO, min_jobs: int, staged: bool,
                   profile: bool) -> tuple[int, dict]:
    """The reads through the native driver in opt.chunk_size chunks:
    (reads, the run's STATS summed over the chunks)."""
    from ..io.fasta import read_fastx

    total = dict.fromkeys(STATS, 0.0)
    n = 0

    def flush(names, seqs, quals):
        out.write(nat.run(opt, names, seqs, quals, rng, min_jobs, staged,
                          profile).decode("latin-1"))
        for k, v in nat.last_stats.items():
            total[k] += v

    names: list[bytes] = []
    seqs: list[bytes] = []
    quals: list[bytes] = []
    budget = 0
    for rec in read_fastx(fq_path):
        names.append(rec.name.encode("latin-1"))
        seqs.append(rec.seq.encode("latin-1"))
        quals.append((rec.qual or "").encode("latin-1"))
        budget += len(rec.seq)
        n += 1
        if budget >= opt.chunk_size:  # 10 Mbp chunks (bwtsw2_aux.c:624)
            flush(names, seqs, quals)
            names, seqs, quals, budget = [], [], [], 0
    if names:
        flush(names, seqs, quals)
    return n, total


def bsw2_aln(opt: Bsw2Opt, prefix: str, fq_path: str,
             out: TextIO = sys.stdout, engine: str = "torch",
             device="cuda", min_jobs: int = dp_glue.EXT_DEV_MIN,
             staged: bool = True, profile: bool = False) -> None:
    """bsw2_aln (bwtsw2_aux.c:605-650) + bwa_bwtsw2 (bwtsw2_main.c).

    engine "torch" runs every seed-extension batch of at least min_jobs
    jobs (bsw2.cpp's default, 64) on `device` (K9 on a CUDA device,
    its plain version on the CPU); "native" runs them all on the host.
    staged=False runs the native driver read by read (no batches of a
    segment); profile=True also times the core's sections (pre, fill,
    save).  Prints where the extensions ran, and the driver's stage split,
    to stderr."""
    import os

    if engine not in ("torch", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    bns = formats.read_ann(prefix + ".ann")
    formats.read_amb(prefix + ".amb", bns)
    fms = (FmIndex(load_index(prefix, 0)), FmIndex(load_index(prefix, 1)))
    rng = Rand48(11)  # srand48(11), bwtsw2_main.c:19
    if not os.environ.get("IBWA_PURE_PY"):
        # the device route first: a missing card raises before any output
        ext = dp_glue.install(device, min_jobs) if engine == "torch" \
            else None
        try:
            for a in bns.anns:
                out.write(f"@SQ\tSN:{a.name}\tLN:{a.length}\n")
            nat = Bsw2Native(bns, prefix, fms)
            n, st = _native_chunks(opt, nat, fq_path, rng, out, min_jobs,
                                   staged, profile)
        finally:
            if ext is not None:
                dp_glue.uninstall()
        print(f"[bsw2_aln] {n} sequences processed", file=sys.stderr)
        c = {k: int(st[k]) for k in ("jobs", "host_jobs", "empty_jobs")}
        if ext is not None:
            print(f"[bsw2_aln] extensions: {ext.jobs} jobs in "
                  f"{ext.batches} batches on {ext.device} ({ext.launches} "
                  f"launches), {ext.gate + c['host_jobs'] + c['empty_jobs']}"
                  f" on the host (gate {ext.gate}, under the minimum "
                  f"{c['host_jobs']}, empty {c['empty_jobs']}); {c['jobs']} "
                  f"jobs in all",
                  file=sys.stderr)
        else:
            print(f"[bsw2_aln] extensions: {c['jobs']} jobs, all on the "
                  f"host (engine native; empty {c['empty_jobs']})",
                  file=sys.stderr)
        print(f"[bsw2_aln] stages: core {st['core_s']:.4f} s, extensions "
              f"{st['ext_s']:.4f} s (device route {st['callback_s']:.4f} s, "
              f"host loop {st['host_loop_s']:.4f} s), cigar "
              f"{st['cigar_s']:.4f} s, all {st['all_s']:.4f} s" + (
                  f"; core: pre {st['core_pre_s']:.4f} s, fill "
                  f"{st['core_fill_s']:.4f} s, save {st['core_save_s']:.4f} s"
                  if profile else ""), file=sys.stderr)
        return
    from ..io.fasta import read_fastx

    print("[bsw2_aln] IBWA_PURE_PY=1: the Python pipeline, seed extensions "
          "on the host", file=sys.stderr)
    for a in bns.anns:
        out.write(f"@SQ\tSN:{a.name}\tLN:{a.length}\n")
    n = 0
    pac = formats.read_pac(prefix + ".pac")
    for rec in read_fastx(fq_path):
        bsw2_aln_one(opt, bns, pac, fms, rec.name, rec.seq,
                     rec.qual or None, rng, out)
        n += 1
    print(f"[bsw2_aln] {n} sequences processed", file=sys.stderr)
