"""The plain reference of `aln`: bwa 0.5.9's gap search, written out again
from the C in the C's own structures.

- gap_opt_t's defaults (gap_init_opt, bwtaln.c:21-37) and the 64-byte
  header `aln` writes first (bwtaln.c:192);
- bwa_cal_maxdiff (bwtaln.c:39-51), with the C's int factorial;
- bwt_cal_width (bwtaln.c:54-78): a read's D(i) bounds as bwt_width_t
  pairs [w, bid];
- gap_stack_t (bwtgap.h, gap_init_stack / gap_reset_stack / gap_push /
  gap_pop, bwtgap.c:13-79): a bucket of slots for each score, each slot a
  gap_entry_t written in place by gap_push (`info` = score<<21 | a<<20 |
  i; last_diff_pos only where the push is a difference) and copied out by
  gap_pop; the stack is kept across reads, as each of bwa's threads keeps
  its own, and a reset clears the counts, never the slots;
- gap_shadow (bwtgap.c:81-91) and bwt_match_gap (bwtgap.c:104-264), with
  best_cnt a C int and bwtint_t a u32;
- one read of bwa_cal_sa_reg_gap (bwtaln.c:80-135) and its .sai record,
  int32 n_aln then bwt_aln1_t's 16 bytes a hit (bwtaln.c:227-231).

It queries the benchmark's own FM-index (`refindex.RefFm`: occ counts
rows 0..k, none at k = (bwtint_t)-1) and imports nothing of the program.

`max_pops`, where given, stops a read's search after that many pops and
keeps the hits found so far: an answer that is no longer exact, which the
tests put in the program's place.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from benchmark.sim import CODE

U32 = 0xFFFFFFFF
BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_NONSTOP = 0x10
BWA_AVG_ERR = 0.02
STATE_M, STATE_I, STATE_D = 0, 1, 2
_HEADER = struct.Struct("<7if8i")
_AWORD = struct.Struct("<IIIi")

# gap_entry_t's fields, a slot a list in this order
INFO, N_MM, N_GAPO, N_GAPE, STATE, K, L, LAST_DIFF_POS = range(8)


@dataclasses.dataclass
class GapOpt:
    """gap_opt_t as gap_init_opt leaves it (bwtaln.c:21-37)."""

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
        """The header: gap_opt_t's fields in their declared order."""
        return _HEADER.pack(self.s_mm, self.s_gapo, self.s_gape, self.mode,
                            self.indel_end_skip, self.max_del_occ,
                            self.max_entries, self.fnr, self.max_diff,
                            self.max_gapo, self.max_gape, self.max_seed_diff,
                            self.seed_len, self.n_threads, self.max_top2,
                            self.trim_qual)


def opt_from_args(args: list[str]) -> GapOpt:
    """bwa_aln's getopt (bwtaln.c:243-328) over the flags a configuration
    may give: -n (a rate where it has a dot, else a count), -o, -l, -k,
    -t."""
    opt = GapOpt()
    flags = dict(zip(args[0::2], args[1::2]))
    unknown = set(flags) - {"-n", "-o", "-l", "-k", "-t"}
    if unknown or len(args) % 2:
        raise ValueError(f"aln flags the reference does not take: {args}")
    if "-n" in flags:
        if "." in flags["-n"]:
            opt.fnr, opt.max_diff = float(flags["-n"]), -1
        else:
            opt.max_diff, opt.fnr = int(flags["-n"]), -1.0
    if "-o" in flags:
        opt.max_gapo = int(flags["-o"])
    if "-l" in flags:
        opt.seed_len = int(flags["-l"])
    if "-k" in flags:
        opt.max_seed_diff = int(flags["-k"])
    opt.n_threads = int(flags.get("-t", 1))
    return opt


def _int32(v: int) -> int:
    return ((v + 0x80000000) & U32) - 0x80000000


def cal_maxdiff(length: int, err: float, thres: float) -> int:
    """bwa_cal_maxdiff: the least k whose Poisson tail at length * err
    falls under thres (x, k! as a C int)."""
    elambda = math.exp(-length * err)
    y, x, total = 1.0, 1, elambda
    for k in range(1, 1000):
        y *= length * err
        x = _int32(x * k)
        total += elambda * y / x
        if 1.0 - total < thres:
            return k
    return 2


def aln_score(m: int, o: int, e: int, opt: GapOpt) -> int:
    return m * opt.s_mm + o * opt.s_gapo + e * opt.s_gape


def cal_width(bwt, length: int, s, width: list) -> int:
    """bwt_cal_width: width[i] = [w, bid] for s[0..i], then width[len] =
    [0, bid + 1]; the backward search restarts where it comes to nothing
    or to an N."""
    k, l, bid = 0, bwt.seq_len, 0
    L2 = bwt.L2
    for i in range(length):
        c = s[i]
        if c < 4:
            ok = bwt.occ((k - 1) & U32, c)
            ol = bwt.occ(l, c)
            k = L2[c] + ok + 1
            l = L2[c] + ol
        if k > l or c > 3:
            k, l = 0, bwt.seq_len
            bid += 1
        width[i][0] = l - k + 1
        width[i][1] = bid
    bid += 1
    width[length][0] = 0
    width[length][1] = bid
    return bid


class GapStack:
    """gap_stack_t: `stacks[score]` is [n_entries, slots]."""

    def __init__(self, max_mm: int, max_gapo: int, max_gape: int,
                 opt: GapOpt):
        n = aln_score(max_mm + 1, max_gapo + 1, max_gape + 1, opt)
        # calloc: four zeroed slots a bucket
        self.stacks = [[0, [[0] * 8 for _ in range(4)]] for _ in range(n)]
        self.best = n
        self.n_entries = 0
        self.s = (opt.s_mm, opt.s_gapo, opt.s_gape)

    def reset(self) -> None:
        for q in self.stacks:
            q[0] = 0
        self.best = len(self.stacks)
        self.n_entries = 0

    def push(self, a, i, k, l, n_mm, n_gapo, n_gape, state, is_diff):
        s_mm, s_gapo, s_gape = self.s
        score = n_mm * s_mm + n_gapo * s_gapo + n_gape * s_gape
        q = self.stacks[score]
        slots = q[1]
        if q[0] == len(slots):
            # realloc: the C leaves the new slots as memory held them; a
            # slot is written before its last_diff_pos is read unless it
            # is the popped parent's (bucket 0 never sees a difference)
            slots.extend([0] * 8 for _ in range(len(slots)))
        p = slots[q[0]]
        p[INFO] = score << 21 | a << 20 | i
        p[K] = k
        p[L] = l
        p[N_MM] = n_mm
        p[N_GAPO] = n_gapo
        p[N_GAPE] = n_gape
        p[STATE] = state
        if is_diff:
            p[LAST_DIFF_POS] = i
        q[0] += 1
        self.n_entries += 1
        if self.best > score:
            self.best = score

    def pop(self) -> list:
        q = self.stacks[self.best]
        e = list(q[1][q[0] - 1])
        q[0] -= 1
        self.n_entries -= 1
        if q[0] == 0 and self.n_entries:
            i = self.best + 1
            while i < len(self.stacks) and self.stacks[i][0] == 0:
                i += 1
            self.best = i
        elif self.n_entries == 0:
            self.best = len(self.stacks)
        return e


def gap_shadow(x: int, max_: int, last_diff_pos: int, w: list) -> None:
    """The hit's count taken off the bounds before its last difference;
    a bound it uses up is set to a block of its own."""
    j = 0
    for i in range(last_diff_pos):
        if w[i][0] > x:
            w[i][0] -= x
        elif w[i][0] == x:
            w[i][1] = 1
            j += 1
            w[i][0] = max_ - j


def _int_log2(v: int) -> int:
    c = 0
    if v & 0xFFFF0000:
        v >>= 16
        c |= 16
    if v & 0xFF00:
        v >>= 8
        c |= 8
    if v & 0xF0:
        v >>= 4
        c |= 4
    if v & 0xC:
        v >>= 2
        c |= 2
    if v & 0x2:
        c |= 1
    return c


def match_exact_alt(bwt, i: int, s, k: int, l: int):
    """bwt_match_exact_alt (bwt.c:235): s[0..i-1] from its end, from
    (k, l); (count, k, l), count 0 at an N or where nothing is left."""
    L2 = bwt.L2
    for j in range(i - 1, -1, -1):
        c = s[j]
        if c > 3:
            return 0, k, l
        ok = bwt.occ((k - 1) & U32, c)
        ol = bwt.occ(l, c)
        k = L2[c] + ok + 1
        l = L2[c] + ol
        if k > l:
            return 0, k, l
    return l - k + 1, k, l


def match_gap(bwts, length: int, seq, w, seed_w, opt: GapOpt,
              stack: GapStack, max_pops: int | None = None) -> list:
    """bwt_match_gap: the read's hits as bwt_aln1_t lists [n_mm, n_gapo,
    n_gape, a, k, l, score].  bwts = (bwt, rbwt); strand a searches
    bwts[1 - a] with seq[a], bounded by w[a] (changed by gap_shadow) and,
    where the read is longer than the seed, seed_w[a]."""
    best_score = aln_score(opt.max_diff + 1, opt.max_gapo + 1,
                           opt.max_gape + 1, opt)
    best_diff = opt.max_diff + 1
    max_diff = opt.max_diff
    best_cnt = 0
    aln: list = []
    gape_mode = opt.mode & BWA_MODE_GAPE
    nonstop = opt.mode & BWA_MODE_NONSTOP
    if sum(1 for c in seq[0][:length] if c > 3) > max_diff:
        return aln
    stack.reset()
    seq_len = bwts[0].seq_len
    stack.push(0, length, 0, seq_len, 0, 0, 0, STATE_M, 0)
    stack.push(1, length, 0, seq_len, 0, 0, 0, STATE_M, 0)
    pops = 0
    while stack.n_entries:
        if stack.n_entries > opt.max_entries:
            break
        if max_pops is not None and pops >= max_pops:
            break
        pops += 1
        e = stack.pop()
        k, l = e[K], e[L]
        a = e[INFO] >> 20 & 1
        i = e[INFO] & 0xFFFF
        if not nonstop and (e[INFO] >> 21) > best_score + opt.s_mm:
            break
        m = max_diff - (e[N_MM] + e[N_GAPO])
        if gape_mode:
            m -= e[N_GAPE]
        if m < 0:
            continue
        bwt = bwts[1 - a]
        s = seq[a]
        width = w[a]
        seed_width = None
        if seed_w is not None:
            seed_width = seed_w[a]
            m_seed = opt.max_seed_diff - (e[N_MM] + e[N_GAPO])
            if gape_mode:
                m_seed -= e[N_GAPE]
        if i > 0 and m < width[i - 1][1]:
            continue

        hit_found = i == 0
        if not hit_found and m == 0 and (
                e[STATE] == STATE_M or gape_mode
                or e[N_GAPE] == opt.max_gape):
            cnt, k2, l2 = match_exact_alt(bwt, i, s, k, l)
            if not cnt:
                continue
            k, l, hit_found = k2, l2, True

        if hit_found:
            score = aln_score(e[N_MM], e[N_GAPO], e[N_GAPE], opt)
            do_add = True
            if not aln:
                best_score = score
                best_diff = e[N_MM] + e[N_GAPO]
                if gape_mode:
                    best_diff += e[N_GAPE]
                if not nonstop:
                    max_diff = (opt.max_diff if best_diff + 1 > opt.max_diff
                                else best_diff + 1)
            if score == best_score:
                best_cnt = _int32(best_cnt + ((l - k + 1) & U32))
            elif best_cnt > opt.max_top2:
                break
            if e[N_GAPO]:
                for h in aln:
                    if h[4] == k and h[5] == l:
                        do_add = False
                        break
            if do_add:
                gap_shadow(_int32(l - k + 1) & U32, seq_len,
                           e[LAST_DIFF_POS], width)
                aln.append([e[N_MM], e[N_GAPO], e[N_GAPE], a, k, l, score])
            continue

        i -= 1
        occ_k = bwt.occ4((k - 1) & U32)
        occ_l = bwt.occ4(l)
        L2 = bwt.L2
        occ = l - k + 1
        allow_diff = allow_m = True
        if i > 0:
            ii = i - (length - opt.seed_len)
            if width[i - 1][1] > m - 1:
                allow_diff = False
            elif (width[i - 1][1] == m - 1 and width[i][1] == m - 1
                  and width[i - 1][0] == width[i][0]):
                allow_m = False
            if seed_width is not None and ii > 0:
                if seed_width[ii - 1][1] > m_seed - 1:
                    allow_diff = False
                elif (seed_width[ii - 1][1] == m_seed - 1
                      and seed_width[ii][1] == m_seed - 1
                      and seed_width[ii - 1][0] == seed_width[ii][0]):
                    allow_m = False
        n_mm, n_gapo, n_gape = e[N_MM], e[N_GAPO], e[N_GAPE]
        tmp = (_int_log2(n_gape + n_gapo) // 2 + 1
               if opt.mode & BWA_MODE_LOGGAP else n_gapo + n_gape)
        if (allow_diff and i >= opt.indel_end_skip + tmp
                and length - i >= opt.indel_end_skip + tmp):
            if e[STATE] == STATE_M:
                if n_gapo < opt.max_gapo:
                    stack.push(a, i, k, l, n_mm, n_gapo + 1, n_gape,
                               STATE_I, 1)
                    for j in range(4):
                        kj = L2[j] + int(occ_k[j]) + 1
                        lj = L2[j] + int(occ_l[j])
                        if kj <= lj:
                            stack.push(a, i + 1, kj, lj, n_mm, n_gapo + 1,
                                       n_gape, STATE_D, 1)
            elif e[STATE] == STATE_I:
                if n_gape < opt.max_gape:
                    stack.push(a, i, k, l, n_mm, n_gapo, n_gape + 1,
                               STATE_I, 1)
            elif e[STATE] == STATE_D:
                if n_gape < opt.max_gape:
                    if n_gape + n_gapo < max_diff or occ < opt.max_del_occ:
                        for j in range(4):
                            kj = L2[j] + int(occ_k[j]) + 1
                            lj = L2[j] + int(occ_l[j])
                            if kj <= lj:
                                stack.push(a, i + 1, kj, lj, n_mm, n_gapo,
                                           n_gape + 1, STATE_D, 1)
        c0 = s[i]
        if allow_diff and allow_m:
            for j in range(1, 5):
                c = (c0 + j) & 3
                is_mm = j != 4 or c0 > 3
                kj = L2[c] + int(occ_k[c]) + 1
                lj = L2[c] + int(occ_l[c])
                if kj <= lj:
                    stack.push(a, i, kj, lj, n_mm + is_mm, n_gapo, n_gape,
                               STATE_M, is_mm)
        elif c0 < 4:
            c = c0 & 3
            kj = L2[c] + int(occ_k[c]) + 1
            lj = L2[c] + int(occ_l[c])
            if kj <= lj:
                stack.push(a, i, kj, lj, n_mm, n_gapo, n_gape, STATE_M, 0)
    return aln


def batch_opt(opt: GapOpt, max_len: int) -> GapOpt:
    """local_opt as bwa_cal_sa_reg_gap sets it for a batch whose longest
    read is max_len: max_diff from it, max_gapo clamped by it."""
    out = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        out.max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr)
    if out.max_diff < out.max_gapo:
        out.max_gapo = out.max_diff
    return out


class Aligner:
    """One of bwa's threads: its stack, kept from read to read, and its
    width arrays, over the batch's options (`batch_opt`)."""

    def __init__(self, bwts, opt: GapOpt, bopt: GapOpt):
        self.bwts, self.opt, self.bopt = bwts, opt, bopt
        self.stack = GapStack(bopt.max_diff, bopt.max_gapo, bopt.max_gape,
                              bopt)
        self.seed_w = [[[0, 0] for _ in range(opt.seed_len + 1)]
                       for _ in range(2)]

    def align(self, seq, rseq, max_pops: int | None = None) -> list:
        """One read: `seq` its reversed codes, `rseq` their complement
        (bwa_read_seq); its hits as `match_gap` gives them."""
        opt, n = self.opt, len(seq)
        local = dataclasses.replace(self.bopt)
        s = (seq.tolist(), rseq.tolist())
        w = [[[0, 0] for _ in range(n + 1)] for _ in range(2)]
        cal_width(self.bwts[0], n, s[0], w[0])
        cal_width(self.bwts[1], n, s[1], w[1])
        if opt.fnr > 0.0:
            local.max_diff = cal_maxdiff(n, BWA_AVG_ERR, opt.fnr)
        local.seed_len = opt.seed_len if opt.seed_len < n else 0x7FFFFFFF
        seed_w = None
        if n > opt.seed_len:
            for a in (0, 1):
                cal_width(self.bwts[a], opt.seed_len,
                          s[a][n - opt.seed_len:], self.seed_w[a])
            seed_w = self.seed_w
        return match_gap(self.bwts, n, s, w, seed_w, local, self.stack,
                         max_pops)


def record(hits: list) -> bytes:
    """A read's .sai record: int32 n_aln, then each bwt_aln1_t (n_mm:8,
    n_gapo:8, n_gape:8, a:1 in one u32; k, l as u32; int score)."""
    return struct.pack("<i", len(hits)) + b"".join(
        _AWORD.pack((m & 0xFF) | (o & 0xFF) << 8 | (e & 0xFF) << 16
                    | (a & 1) << 24, k & U32, l & U32, score)
        for m, o, e, a, k, l, score in hits)


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
