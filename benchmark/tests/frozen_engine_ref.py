"""The second witness of the benchmark's `aln` reference: a frozen copy of
the port's host emulator (`align/engine_ref.py`, a behavioural
re-implementation of bwt_cal_width, bwtaln.c:54-78, and bwt_match_gap,
bwtgap.c:104-264) and of its options (`align/opts.py`), over the
benchmark's own FM-index.  The benchmark's reference (`benchmark/refaln.py`)
is written again from the C in another structure; the tests hold the two
against each other.  Nothing but the tests uses this copy.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from benchmark.sim import CODE

NEG1 = 0xFFFFFFFF
BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_NONSTOP = 0x10
BWA_AVG_ERR = 0.02
STATE_M, STATE_I, STATE_D = 0, 1, 2
_HEADER = struct.Struct("<7if8i")


@dataclasses.dataclass
class GapOpt:
    """gap_init_opt's defaults (bwtaln.c:21-37)."""

    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    mode: int = BWA_MODE_GAPE | BWA_MODE_COMPREAD
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    fnr: float = 0.04
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    max_seed_diff: int = 2
    seed_len: int = 32
    n_threads: int = 1
    max_top2: int = 30
    trim_qual: int = 0

    def pack(self) -> bytes:
        return _HEADER.pack(self.s_mm, self.s_gapo, self.s_gape, self.mode,
                            self.indel_end_skip, self.max_del_occ,
                            self.max_entries, self.fnr, self.max_diff,
                            self.max_gapo, self.max_gape, self.max_seed_diff,
                            self.seed_len, self.n_threads, self.max_top2,
                            self.trim_qual)


def opt_from_args(args: list[str]) -> GapOpt:
    """The options `aln` takes from the subset of its flags a
    configuration may give: -n (a rate or a count), -o, -e, -l, -k, -t."""
    opt = GapOpt()
    flags = dict(zip(args[0::2], args[1::2]))
    unknown = set(flags) - {"-n", "-o", "-e", "-l", "-k", "-t"}
    if unknown or len(args) % 2:
        raise ValueError(f"aln flags the reference does not take: {args}")
    if "-n" in flags:
        if "." in flags["-n"]:
            opt.fnr, opt.max_diff = float(flags["-n"]), -1
        else:
            opt.max_diff, opt.fnr = int(flags["-n"]), -1.0
    if "-o" in flags:
        opt.max_gapo = int(flags["-o"])
    if int(flags.get("-e", -1)) > 0:
        opt.max_gape = int(flags["-e"])
        opt.mode &= ~BWA_MODE_GAPE
    if "-l" in flags:
        opt.seed_len = int(flags["-l"])
    if "-k" in flags:
        opt.max_seed_diff = int(flags["-k"])
    opt.n_threads = int(flags.get("-t", 1))
    return opt


def cal_maxdiff(length: int, err: float = BWA_AVG_ERR,
                thres: float = 0.04) -> int:
    """Poisson tail bound on allowed differences (bwtaln.c:39-51)."""
    elambda = math.exp(-length * err)
    y, x, total = 1.0, 1, elambda
    for k in range(1, 1000):
        y *= length * err
        x *= k
        total += elambda * y / x
        if 1.0 - total < thres:
            return k
    return 2


def aln_score(n_mm: int, n_gapo: int, n_gape: int, opt: GapOpt) -> int:
    return n_mm * opt.s_mm + n_gapo * opt.s_gapo + n_gape * opt.s_gape


@dataclasses.dataclass
class Hit:
    n_mm: int
    n_gapo: int
    n_gape: int
    a: int
    k: int
    l: int
    score: int


@dataclasses.dataclass
class _Entry:
    a: int
    i: int
    k: int
    l: int
    n_mm: int
    n_gapo: int
    n_gape: int
    state: int
    last_diff_pos: int
    score: int


def cal_width(fm, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """D(i) lower-bound widths (bwtaln.c:54-78): (w, bid), len(seq)+1."""
    n = len(seq)
    w = np.zeros(n + 1, dtype=np.int64)
    bid = np.zeros(n + 1, dtype=np.int32)
    k, l, b = 0, fm.seq_len, 0
    for i in range(n):
        c = int(seq[i])
        if c < 4:
            ok = fm.occ(k - 1 if k > 0 else NEG1, c)
            ol = fm.occ(l, c)
            k = int(fm.L2[c]) + ok + 1
            l = int(fm.L2[c]) + ol
        if k > l or c > 3:
            k, l = 0, fm.seq_len
            b += 1
        w[i] = l - k + 1
        bid[i] = b
    w[n] = 0
    bid[n] = b + 1
    return w, bid


class _Stack:
    """Score-bucketed LIFO stack (bwtgap.c:13-79)."""

    def __init__(self, n_buckets: int):
        self.buckets: list[list[_Entry]] = [[] for _ in range(n_buckets)]
        self.best = n_buckets
        self.n = 0

    def push(self, e: _Entry) -> None:
        self.buckets[e.score].append(e)
        self.n += 1
        if e.score < self.best:
            self.best = e.score

    def pop(self) -> _Entry:
        q = self.buckets[self.best]
        e = q.pop()
        self.n -= 1
        if not q and self.n:
            b = self.best + 1
            while not self.buckets[b]:
                b += 1
            self.best = b
        elif self.n == 0:
            self.best = len(self.buckets)
        return e


def match_gap(fms, seq: np.ndarray, rseq: np.ndarray, widths, seed_widths,
              opt: GapOpt, max_diff: int, max_pops: int | None = None
              ) -> list[Hit]:
    """bwt_match_gap (bwtgap.c:104-264).  fms = (fwd, rev); strand a
    searches fms[1-a].  `widths` are mutated (gap_shadow)."""
    n = len(seq)
    best_score = aln_score(max_diff + 1, opt.max_gapo + 1, opt.max_gape + 1,
                           opt)
    best_cnt = 0
    hits: list[Hit] = []
    seqs = (seq, rseq)
    if int((seq > 3).sum()) > max_diff:
        return hits
    stack = _Stack(best_score + 1)
    stack.push(_Entry(0, n, 0, fms[0].seq_len, 0, 0, 0, 0, 0, 0))
    stack.push(_Entry(1, n, 0, fms[0].seq_len, 0, 0, 0, 0, 0, 0))
    mode_gape = bool(opt.mode & BWA_MODE_GAPE)
    mode_nonstop = bool(opt.mode & BWA_MODE_NONSTOP)
    mode_loggap = bool(opt.mode & BWA_MODE_LOGGAP)
    pops = 0

    while stack.n:
        if stack.n > opt.max_entries:
            break
        if max_pops is not None and pops >= max_pops:
            break
        pops += 1
        e = stack.pop()
        a, i, k, l = e.a, e.i, e.k, e.l
        if not mode_nonstop and e.score > best_score + opt.s_mm:
            break
        m = max_diff - (e.n_mm + e.n_gapo)
        if mode_gape:
            m -= e.n_gape
        if m < 0:
            continue
        fm = fms[1 - a]
        s = seqs[a]
        w_arr, bid_arr = widths[a]
        if seed_widths is not None:
            sw_arr, sbid_arr = seed_widths[a]
            m_seed = opt.max_seed_diff - (e.n_mm + e.n_gapo)
            if mode_gape:
                m_seed -= e.n_gape
        if i > 0 and m < bid_arr[i - 1]:
            continue

        hit_found = False
        if i == 0:
            hit_found = True
        elif m == 0 and (e.state == STATE_M or mode_gape
                         or e.n_gape == opt.max_gape):
            cnt, k2, l2 = fm.match_exact_alt(s[:i], k, l)
            if cnt:
                k, l = k2, l2
                hit_found = True
            else:
                continue

        if hit_found:
            score = aln_score(e.n_mm, e.n_gapo, e.n_gape, opt)
            do_add = True
            if not hits:
                best_score = score
                best_diff = e.n_mm + e.n_gapo
                if mode_gape:
                    best_diff += e.n_gape
                if not mode_nonstop:
                    max_diff = min(best_diff + 1, max_diff)
            if score == best_score:        # an int in bwtgap.c: it wraps
                best_cnt = ((best_cnt + l - k + 1 + 0x80000000)
                            & 0xFFFFFFFF) - 0x80000000
            elif best_cnt > opt.max_top2:
                break
            if e.n_gapo:                   # bwtgap.c:178-182
                if any(h.k == k and h.l == l for h in hits):
                    do_add = False
            if do_add:
                _gap_shadow(l - k + 1, fm.seq_len, e.last_diff_pos,
                            w_arr, bid_arr)
                hits.append(Hit(e.n_mm, e.n_gapo, e.n_gape, a, k, l, score))
            continue

        i -= 1
        cnt_k = fm.occ4(k - 1 if k > 0 else NEG1)
        cnt_l = fm.occ4(l)
        occ = l - k + 1
        allow_diff = allow_m = True
        if i > 0:
            ii = i - (n - opt.seed_len)
            if bid_arr[i - 1] > m - 1:
                allow_diff = False
            elif (bid_arr[i - 1] == m - 1 and bid_arr[i] == m - 1
                  and w_arr[i - 1] == w_arr[i]):
                allow_m = False
            if seed_widths is not None and ii > 0:
                if sbid_arr[ii - 1] > m_seed - 1:
                    allow_diff = False
                elif (sbid_arr[ii - 1] == m_seed - 1
                      and sbid_arr[ii] == m_seed - 1
                      and sw_arr[ii - 1] == sw_arr[ii]):
                    allow_m = False

        tmp = (_int_log2(e.n_gape + e.n_gapo) // 2 + 1 if mode_loggap
               else e.n_gapo + e.n_gape)
        if (allow_diff and i >= opt.indel_end_skip + tmp
                and n - i >= opt.indel_end_skip + tmp):
            if e.state == STATE_M:
                if e.n_gapo < opt.max_gapo:
                    sc = aln_score(e.n_mm, e.n_gapo + 1, e.n_gape, opt)
                    stack.push(_Entry(a, i, k, l, e.n_mm, e.n_gapo + 1,
                                      e.n_gape, STATE_I, i, sc))
                    for j in range(4):
                        kj = int(fm.L2[j] + cnt_k[j]) + 1
                        lj = int(fm.L2[j] + cnt_l[j])
                        if kj <= lj:
                            stack.push(_Entry(a, i + 1, kj, lj, e.n_mm,
                                              e.n_gapo + 1, e.n_gape,
                                              STATE_D, i + 1, sc))
            elif e.state == STATE_I:
                if e.n_gape < opt.max_gape:
                    stack.push(_Entry(a, i, k, l, e.n_mm, e.n_gapo,
                                      e.n_gape + 1, STATE_I, i,
                                      aln_score(e.n_mm, e.n_gapo,
                                                e.n_gape + 1, opt)))
            elif e.state == STATE_D:
                if e.n_gape < opt.max_gape:
                    if (e.n_gape + e.n_gapo < max_diff
                            or occ < opt.max_del_occ):
                        sc = aln_score(e.n_mm, e.n_gapo, e.n_gape + 1, opt)
                        for j in range(4):
                            kj = int(fm.L2[j] + cnt_k[j]) + 1
                            lj = int(fm.L2[j] + cnt_l[j])
                            if kj <= lj:
                                stack.push(_Entry(a, i + 1, kj, lj, e.n_mm,
                                                  e.n_gapo, e.n_gape + 1,
                                                  STATE_D, i + 1, sc))

        if allow_diff and allow_m:
            for j in range(1, 5):
                c = (int(s[i]) + j) & 3
                is_mm = (j != 4 or int(s[i]) > 3)
                kj = int(fm.L2[c] + cnt_k[c]) + 1
                lj = int(fm.L2[c] + cnt_l[c])
                if kj <= lj:
                    stack.push(_Entry(a, i, kj, lj, e.n_mm + is_mm, e.n_gapo,
                                      e.n_gape, STATE_M,
                                      i if is_mm else e.last_diff_pos,
                                      aln_score(e.n_mm + is_mm, e.n_gapo,
                                                e.n_gape, opt)))
        elif int(s[i]) < 4:
            c = int(s[i]) & 3
            kj = int(fm.L2[c] + cnt_k[c]) + 1
            lj = int(fm.L2[c] + cnt_l[c])
            if kj <= lj:
                stack.push(_Entry(a, i, kj, lj, e.n_mm, e.n_gapo, e.n_gape,
                                  STATE_M, e.last_diff_pos, e.score))
    return hits


def _gap_shadow(x: int, seq_len: int, last_diff_pos: int, w: np.ndarray,
                bid: np.ndarray) -> None:
    """Subtract a found hit's count from the width bounds
    (bwtgap.c:81-91)."""
    j = 0
    for i in range(last_diff_pos):
        if w[i] > x:
            w[i] -= x
        elif w[i] == x:
            bid[i] = 1
            j += 1
            w[i] = seq_len - j


def _int_log2(v: int) -> int:
    c = 0
    for bits, mask in ((16, 0xFFFF0000), (8, 0xFF00), (4, 0xF0), (2, 0xC)):
        if v & mask:
            v >>= bits
            c |= bits
    if v & 0x2:
        c |= 1
    return c


def batch_opt(opt: GapOpt, max_len: int) -> GapOpt:
    """The batch's options (bwtaln.c:86-92): max_diff from the batch's
    longest read, max_gapo clamped by it."""
    out = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        out.max_diff = cal_maxdiff(max_len, thres=opt.fnr)
    if out.max_diff < out.max_gapo:
        out.max_gapo = out.max_diff
    return out


def align_read(fms, seq: np.ndarray, rseq: np.ndarray, opt: GapOpt,
               bopt: GapOpt, max_pops: int | None = None) -> list[Hit]:
    """One read of bwa_cal_sa_reg_gap (bwtaln.c:93-135): `seq` is the
    reversed read, `rseq` its reverse complement (bwaseqio.c:189-192);
    `bopt` the batch's options (`batch_opt`)."""
    n = len(seq)
    max_diff = (cal_maxdiff(n, thres=opt.fnr) if opt.fnr > 0.0
                else bopt.max_diff)
    local = dataclasses.replace(bopt)
    local.seed_len = opt.seed_len if opt.seed_len < n else 0x7FFFFFFF
    widths = [cal_width(fms[0], seq), cal_width(fms[1], rseq)]
    seed_widths = ([cal_width(fms[0], seq[n - opt.seed_len:]),
                    cal_width(fms[1], rseq[n - opt.seed_len:])]
                   if n > opt.seed_len else None)
    return match_gap(fms, seq, rseq, widths, seed_widths, local, max_diff,
                     max_pops)


def record(hits: list[Hit]) -> bytes:
    """One read's .sai record: int32 n_aln, then 16 bytes a hit."""
    out = [struct.pack("<i", len(hits))]
    for h in hits:
        out.append(struct.pack(
            "<IIIi", (h.n_mm & 0xFF) | ((h.n_gapo & 0xFF) << 8)
            | ((h.n_gape & 0xFF) << 16) | ((h.a & 1) << 24),
            h.k & 0xFFFFFFFF, h.l & 0xFFFFFFFF, h.score))
    return b"".join(out)


def split_records(data: bytes) -> tuple[bytes, list[bytes], int]:
    """(64-byte header, each read's record, bytes left over that make no
    whole record) of a .sai stream."""
    header, pos, out = data[:64], 64, []
    while pos + 4 <= len(data):
        (n_aln,) = struct.unpack_from("<i", data, pos)
        end = pos + 4 + 16 * max(n_aln, 0)
        if n_aln < 0 or end > len(data):
            break
        out.append(data[pos:end])
        pos = end
    return header, out, len(data) - pos


def read_codes(read: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(seq, rseq) of an ASCII read as bwa_read_seq gives them: the
    reversed 2-bit codes and the reverse complement."""
    codes = CODE[read]
    comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
    return codes[::-1].copy(), comp[::-1].copy()
