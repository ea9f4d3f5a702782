"""SOLiD color-space to nucleotide decoding (the reference's cs2nt.c):
a 4-state DP over the nucleotide lattice scored by color quality
(COLOR_MM floor) and NUCL_MM penalties, followed by recomputed base
qualities from flanking color agreement.

Copy of `ibwa_tpu/sam/cs2nt.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import numpy as np

COLOR_MM = 19
NUCL_MM = 25
NTNT2CS = [4, 0, 0, 1, 0, 2, 3, 4, 0, 3, 2, 4, 1, 4, 4, 4]
FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3


def cs2nt_dp(size: int, nt_ref: np.ndarray, cs_read: np.ndarray
             ) -> np.ndarray:
    """cs2nt_DP (cs2nt.c:37-78): returns nt_read[0..size]."""
    h = [0] * 8
    if nt_ref[0] >= 4:
        for x in range(4):
            h[x] = 0
    else:
        for x in range(4):
            h[x] = NUCL_MM
        h[nt_ref[0]] = 0
    bt = np.zeros((size + 1) * 4, dtype=np.uint8)
    curr, last = 1, 0
    for k in range(1, size + 1):
        cq = cs_read[k - 1] & 0x3F
        cc = cs_read[k - 1] >> 6
        for x in range(4):
            mn = 0x7FFFFFFF
            ymin = 0
            for y in range(4):
                s = h[last << 2 | y]
                if cq != 63 and cc != NTNT2CS[(1 << x) | (1 << y)]:
                    s += COLOR_MM if cq < COLOR_MM else cq
                if nt_ref[k] < 4 and nt_ref[k] != x:
                    s += NUCL_MM
                if s < mn:
                    mn = s
                    ymin = y
            h[curr << 2 | x] = mn
            bt[k << 2 | x] = ymin
        last, curr = curr, 1 - curr
    hmin = 0x7FFFFFFF
    xmin = 0
    for x in range(4):
        if h[last << 2 | x] < hmin:
            hmin = h[last << 2 | x]
            xmin = x
    nt_read = np.zeros(size + 1, dtype=np.uint8)
    nt_read[size] = xmin
    for k in range(size - 1, -1, -1):
        nt_read[k] = bt[(k + 1) << 2 | nt_read[k + 1]]
    return nt_read


def cs2nt_nt_qual(size: int, nt_read: np.ndarray, cs_read: np.ndarray
                  ) -> np.ndarray:
    """cs2nt_nt_qual (cs2nt.c:84-110): returns base<<6|qual array of
    length size-1 (positions 1..size-1 of nt_read)."""
    tarr = np.zeros(size, dtype=np.int32)
    c1 = int(nt_read[0])
    for k in range(1, size + 1):
        c2 = int(nt_read[k])
        tarr[k - 1] = 4 if (c1 >= 4 or c2 >= 4) \
            else NTNT2CS[(1 << c1) | (1 << c2)]
        c1 = c2
    out = np.zeros(size - 1, dtype=np.uint8)
    for k in range(1, size):
        q = 0
        cqm1 = int(cs_read[k - 1] & 0x3F)
        cq = int(cs_read[k] & 0x3F)
        ccm1 = int(cs_read[k - 1] >> 6)
        cc = int(cs_read[k] >> 6)
        if tarr[k - 1] == ccm1 and tarr[k] == cc:
            q = cqm1 + cq + 10
        elif tarr[k - 1] == ccm1:
            q = cqm1 - cq
        elif tarr[k] == cc:
            q = cq - cqm1
        q = max(0, min(60, q))
        v = (int(nt_read[k]) << 6) | q
        if cqm1 == 63 or cq == 63:
            v = 0
        out[k - 1] = v
    return out


def bwa_cs2nt_core(s, dbs) -> None:
    """bwa_cs2nt_core (cs2nt.c:113-196): decode one aligned color read.

    Called after refine_gapped re-oriented s.seq_fwd; sets s.conv (the
    genome-forward nucleotide read), s.conv_qual and updates s.len."""
    from .bwase import TYPE_NO_MATCH, cigar_len, cigar_op

    if s.type == TYPE_NO_MATCH:
        return
    r = s.read
    seq = r.rseq if s.strand else s.seq_fwd   # genome-forward colors
    qual = r.qual or b""

    def csbase(i: int) -> int:
        q = qual[r.clip_len - 1 - i if s.strand else i] - 33
        if q > 60:
            q = 60
        if seq[i] > 3:
            q = 63
        return (int(seq[i]) << 6) | q

    nt_ref = [4]
    if s.pos:
        nt_ref = [int(dbs.extract_sequence(s.pos - 1, 1, nt=True)[0])]
    cs_read = []
    if s.cigar is None:
        length = s.len
        ref = dbs.extract_sequence(s.pos, s.len, nt=True)
        nt_ref.extend(int(b) for b in ref)
        cs_read = [csbase(i) for i in range(s.len)]
    else:
        x, y = s.pos, 0
        for c in s.cigar:
            ln = cigar_len(c)
            op = cigar_op(c)
            if op == FROM_M:
                ref = dbs.extract_sequence(x, ln, nt=True)
                nt_ref.extend(int(b) for b in ref)
                for _ in range(ln):
                    cs_read.append(csbase(y))
                    x += 1
                    y += 1
            elif op == FROM_I:
                for _ in range(ln):
                    cs_read.append(csbase(y))
                    nt_ref.append(4)
                    y += 1
            elif op == FROM_S:
                y += ln
            else:
                x += ln
        length = len(cs_read)
    nt_ref = np.array(nt_ref[:length + 1], dtype=np.uint8)
    cs_arr = np.array(cs_read, dtype=np.int32)

    nt_read = cs2nt_dp(length, nt_ref, cs_arr)
    new_nt = cs2nt_nt_qual(length, nt_read, cs_arr)

    s.len = length - 1
    conv = np.zeros(s.len, dtype=np.uint8)
    cq = bytearray(s.len)
    for i in range(s.len):
        if (new_nt[i] & 0x3F) == 63:
            cq[i] = 33
            conv[i] = 4
        else:
            cq[i] = (new_nt[i] & 0x3F) + 33
            conv[i] = new_nt[i] >> 6
    s.conv = conv                # genome-forward nucleotide read
    s.conv_qual = bytes(cq)
    s.seq_fwd = conv             # downstream MD/refine read both strands
    s.rseq_conv = conv
