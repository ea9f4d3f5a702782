"""BWA-SW core: DP over (prefix-DAG of the read's BWT) x (prefix-trie of
the genome FM-index) with the Z-best beam heuristic (bwtsw2_core.c).

Naming follows the reference: "target" is the READ's bwtl, "query" is the
GENOME FM-index.  Cells, entries, the pending-merge machinery, cut_tail,
duplicate removal and hit collection are ported 1:1 — the hit set is
sensitive to all of them.

Copy of `ibwa_tpu/bwasw/core.py`: the port keeps its own host code and
imports nothing of `ibwa_tpu`.  `bsw2_core` is the Python oracle of the
native core (`native/src/bsw2.cpp`), the route `IBWA_PURE_PY=1` runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..fm.fmindex import FmIndex
from .bwtl import Bwtl

MINUS_INF = -0x3FFFFFFF
MASK_LEVEL = 0.90


@dataclasses.dataclass
class Bsw2Opt:
    """bsw2opt_t defaults (bsw2_init_opt, bwtsw2_aux.c:48-57)."""

    a: int = 1
    b: int = 3
    q: int = 5
    r: int = 2
    t: int = 30
    bw: int = 50
    z: int = 1
    is_: int = 3
    t_seeds: int = 5
    hard_clip: int = 0
    mask_level: float = 0.50
    yita: float = 5.5
    coef: float = 5.5
    n_threads: int = 1
    chunk_size: int = 10000000

    @property
    def qr(self) -> int:
        return self.q + self.r


class Cell:
    """bsw2cell_t (bwtsw2_core.c:19-26)."""

    __slots__ = ("qk", "ql", "I", "D", "G", "pj", "qlen", "tlen", "ppos",
                 "upos", "cpos")

    def __init__(self):
        self.qk = 0
        self.ql = 0
        self.I = MINUS_INF
        self.D = MINUS_INF
        self.G = MINUS_INF
        self.pj = 0
        self.qlen = 0
        self.tlen = 0
        self.ppos = -1
        self.upos = -1
        self.cpos = [-1, -1, -1, -1]


class Entry:
    """bsw2entry_t: one read-BWT interval + its cell array."""

    __slots__ = ("tk", "tl", "cells")

    def __init__(self):
        self.tk = 0
        self.tl = 0
        self.cells: list[Cell] = []

    @property
    def n(self) -> int:
        return len(self.cells)


@dataclasses.dataclass
class Hit:
    """bsw2hit_t (bwtsw2.h:16-20)."""

    k: int = 0
    l: int = 0
    flag: int = 0
    n_seeds: int = 0
    len: int = 0
    G: int = 0
    G2: int = 0
    beg: int = 0
    end: int = 0


class HitList:
    """bwtsw2_t: hits + their cigars."""

    def __init__(self):
        self.hits: list[Hit] = []
        self.cigars: list[list[int] | None] = []

    @property
    def n(self) -> int:
        return len(self.hits)


def _heapadjust(i: int, n: int, h: list[int]) -> None:
    """ks_heapadjust for ints (max-heap sift down)."""
    tmp = h[i]
    k = (i << 1) + 1
    while k < n:
        if k != n - 1 and h[k] < h[k + 1]:
            k += 1
        if h[k] < tmp:
            break
        h[i] = h[k]
        i = k
        k = (i << 1) + 1
    h[i] = tmp


def _connectivity(b: Bwtl) -> dict[tuple[int, int], int]:
    """bsw2_connectivity (bwtsw2_core.c:87-120): in-degree of every
    read-BWT interval reachable by backward extension."""
    h: dict[tuple[int, int], int] = {}
    stack = [(0, b.seq_len)]
    while stack:
        k0, l0 = stack.pop()
        cntk = b.occ4(k0 - 1)
        cntl = b.occ4(l0)
        for j in range(4):
            k = int(b.L2[j] + cntk[j]) + 1
            l = int(b.L2[j] + cntl[j])
            if k > l:
                continue
            key = (k, l)
            if key not in h:
                h[key] = 1
                stack.append(key)
            else:
                h[key] += 1
    return h


def _cut_tail(u: Entry, T: int) -> None:
    """cut_tail (bwtsw2_core.c:122-145): keep the top-T scoring cells."""
    if u.n <= T:
        return
    a = [-c.G for c in u.cells if c.ql and c.G > 0]
    if len(a) <= T:
        return
    x = -sorted(a)[T]
    n = 0
    for p in u.cells:
        if p.G == x:
            n += 1
        if p.G < x or (p.G == x and n >= T):
            p.qk = p.ql = 0
            p.G = 0
            if p.ppos >= 0:
                u.cells[p.ppos].cpos[p.pj] = -1


def _remove_duplicate(u: Entry) -> None:
    """remove_duplicate (bwtsw2_core.c:147-172)."""
    seen: dict[tuple[int, int], tuple[int, int]] = {}  # (qk,ql)->(idx,G)
    for i, p in enumerate(u.cells):
        if p.ql == 0:
            continue
        key = (p.qk, p.ql)
        j = -1
        prev = seen.get(key)
        if prev is not None:
            if prev[1] >= p.G:
                j = i
            else:
                j = prev[0]
                seen[key] = (i, p.G)
        else:
            seen[key] = (i, p.G)
        if j >= 0:
            p2 = u.cells[j]
            p2.qk = p2.ql = 0
            p2.G = 0
            if p2.ppos >= 0:
                u.cells[p2.ppos].cpos[p2.pj] = -3


def _merge_entry(u: Entry, v: Entry) -> None:
    """merge_entry (bwtsw2_core.c:174-193): append v's cells to u."""
    off = u.n
    for p in v.cells:
        if p.ppos >= 0:
            p.ppos += off
        for t in range(4):
            if p.cpos[t] >= 0:
                p.cpos[t] += off
    u.cells.extend(v.cells)
    v.cells = []


def _save_hits(bwt: Bwtl, thres: int, hits: list[Hit], u: Entry) -> None:
    """save_hits (bwtsw2_core.c:211-233): 2 slots per read position."""
    for p in u.cells:
        if p.G < thres:
            continue
        for k in range(u.tk, u.tl + 1):
            beg = int(bwt.sa[k])
            end = beg + p.tlen
            q = None
            if p.G > hits[beg * 2].G:
                hits[beg * 2 + 1] = dataclasses.replace(hits[beg * 2])
                q = hits[beg * 2]
            elif p.G > hits[beg * 2 + 1].G:
                q = hits[beg * 2 + 1]
            if q is not None:
                q.k = p.qk
                q.l = p.ql
                q.len = p.qlen
                q.G = p.G
                q.beg = beg
                q.end = end
                q.G2 = 0 if q.k == q.l else q.G
                q.flag = q.n_seeds = 0


def _save_narrow_hits(bwtl: Bwtl, u: Entry, b1: HitList, t: int,
                      IS: int) -> None:
    """save_narrow_hits (bwtsw2_core.c:236-258)."""
    for p in u.cells:
        if p.G >= t and p.ql - p.qk + 1 <= IS:
            b1.hits.append(Hit(k=p.qk, l=p.ql, len=p.qlen, G=p.G, G2=0,
                               beg=int(bwtl.sa[u.tk]),
                               end=int(bwtl.sa[u.tk]) + p.tlen, flag=0))
            p.qk = p.ql = 0
            p.G = 0
            if p.ppos >= 0:
                u.cells[p.ppos].cpos[p.pj] = -3


def _hit_sort_key(h: Hit):
    return -h.G  # __hitG_lt: (a).G > (b).G


def resolve_duphits(fm: FmIndex | None, b: HitList, IS: int) -> int:
    """bsw2_resolve_duphits (bwtsw2_core.c:261-327)."""
    if b.n == 0:
        return 0
    if fm is not None:  # expand SA intervals to chromosome coordinates
        new_hits: list[Hit] = []
        for p in b.hits:
            if p.l - p.k + 1 <= IS:
                for k in range(p.k, p.l + 1):
                    q = dataclasses.replace(p)
                    q.k = fm.sa_at(k)
                    q.l = 0
                    new_hits.append(q)
            elif p.G > 0:
                q = dataclasses.replace(p)
                q.k = fm.sa_at(p.k)
                q.l = 0
                q.flag |= 1
                new_hits.append(q)
        b.hits = new_hits
    b.hits.sort(key=_hit_sort_key)
    n = b.n
    cut = n
    for i in range(1, n):
        p = b.hits[i]
        if p.G == 0:
            cut = i
            break
        for q in b.hits[:i]:
            compatible = True
            if q.G == 0:
                continue
            if p.l == 0 and q.l == 0:
                qol = min(p.end, q.end) - max(p.beg, q.beg)
                if qol < 0:
                    qol = 0
                if (qol / (p.end - p.beg) > MASK_LEVEL
                        or qol / (q.end - q.beg) > MASK_LEVEL):
                    tol = (min(p.k + p.len, q.k + q.len)
                           - max(p.k, q.k))
                    if (tol / p.len > MASK_LEVEL
                            or tol / q.len > MASK_LEVEL):
                        compatible = False
            if not compatible:
                p.G = 0
                break
    else:
        cut = n
    b.hits = [h for h in b.hits[:cut] if h.G != 0]
    return b.n


def resolve_query_overlaps(b: HitList, mask_level: float, rng) -> int:
    """bsw2_resolve_query_overlaps (bwtsw2_core.c:329-378)."""
    if b.n == 0:
        return 0
    b.hits.sort(key=_hit_sort_key)
    G0 = b.hits[0].G
    i = 1
    while i < b.n and b.hits[i].G == G0:
        i += 1
    j = int(i * rng.drand48())
    if j:
        b.hits[0], b.hits[j] = b.hits[j], b.hits[0]
    n = b.n
    cut = n
    for i in range(1, n):
        p = b.hits[i]
        all_compatible = True
        if p.G == 0:
            cut = i
            break
        for q in b.hits[:i]:
            if q.G == 0:
                continue
            tol = 0
            qol = min(p.end, q.end) - max(p.beg, q.beg)
            if qol < 0:
                qol = 0
            if p.l == 0 and q.l == 0:
                tol = (min(p.k + p.len, q.k + q.len) - max(p.k, q.k))
                if tol < 0:
                    tol = 0
            fol = qol / min(p.end - p.beg, q.end - q.beg)
            compatible = (fol < mask_level
                          or (tol > 0 and qol < p.end - p.beg
                              and qol < q.end - q.beg))
            if not compatible:
                if q.G2 < p.G:
                    q.G2 = p.G
                all_compatible = False
        if not all_compatible:
            p.G = 0
    else:
        cut = n
    b.hits = [h for h in b.hits[:cut] if h.G != 0]
    return b.n


def _query_occ4(fm: FmIndex, k: int) -> np.ndarray:
    return native.occ4(fm._interleaved, fm.primary,
                       fm.L2.astype(np.uint32), fm.seq_len,
                       k & 0xFFFFFFFF).astype(np.int64)


def bsw2_core(opt: Bsw2Opt, target: Bwtl, query: FmIndex
              ) -> tuple[HitList, HitList]:
    """bsw2_core (bwtsw2_core.c:429-594).  Returns (b, b1): all hits and
    narrow-SA hits, both duplicate-resolved in genome coordinates."""
    chash = _connectivity(target)
    score_mat = [[opt.a if i == j else -opt.b for j in range(4)]
                 for i in range(4)]
    heap_size = opt.z
    # pending[idx] keyed like the reference's kvec of entries
    pending: list[Entry | None] = []

    b = HitList()
    b.hits = [Hit() for _ in range(target.seq_len * 2)]
    b1 = HitList()

    root = Entry()
    root.tk = 0
    root.tl = target.seq_len
    x0 = Cell()
    x0.G = 0
    x0.qk = 0
    x0.ql = query.seq_len
    root.cells.append(x0)
    stack0 = [root]
    n_pending = 0
    Lq = query.L2

    while stack0 or n_pending:
        v = stack0.pop()
        old_n = v.n

        for p in v.cells:  # band-width test
            if p.ql == 0:
                continue
            if p.tlen - p.qlen > opt.bw or p.qlen - p.tlen > opt.bw:
                p.qk = p.ql = 0
                if p.ppos >= 0:
                    v.cells[p.ppos].cpos[p.pj] = -5

        tcntk = target.occ4(v.tk - 1)
        tcntl = target.occ4(v.tl)
        for tj in range(4):
            k = int(target.L2[tj] + tcntk[tj]) + 1
            l = int(target.L2[tj] + tcntl[tj])
            if k > l:
                continue
            key = (k, l)
            chash[key] -= 1
            cnt = chash[key] & 0xFFFFFFFF
            u = Entry()
            u.tk = k
            u.tl = l
            heap = [0] * heap_size
            csm = score_mat[tj]

            i = 0
            while i < v.n:
                p = v.cells[i]
                is_added = False
                if p.ql == 0:
                    i += 1
                    continue
                x = Cell()
                x.G = MINUS_INF
                p.upos = x.upos = -1
                if p.ppos >= 0:  # parent has been visited
                    par = v.cells[p.ppos]
                    c1 = u.cells[par.upos] if par.upos >= 0 else None
                    # fill_cell (bwtsw2_core.c:401-413)
                    G = par.G + csm[p.pj]
                    if c1 is not None:
                        x.I = (c1.I - opt.r if c1.I > c1.G - opt.q
                               else c1.G - opt.qr)
                        if x.I > G:
                            G = x.I
                    else:
                        x.I = MINUS_INF
                    x.D = (p.D - opt.r if p.D > p.G - opt.q
                           else p.G - opt.qr)
                    if x.D > G:
                        G = x.D
                    x.G = G
                    if G > 0:
                        x.ppos = par.upos
                        p.upos = u.n
                        u.cells.append(x)
                        if x.ppos >= 0:
                            u.cells[x.ppos].cpos[p.pj] = p.upos
                        is_added = True
                else:
                    x.D = (p.D - opt.r if p.D > p.G - opt.q
                           else p.G - opt.qr)
                    if x.D > 0:
                        x.G = x.D
                        x.I = MINUS_INF
                        x.ppos = -1
                        p.upos = u.n
                        u.cells.append(x)
                        is_added = True
                if is_added:
                    x.cpos = [-1, -1, -1, -1]
                    x.pj = p.pj
                    x.qk = p.qk
                    x.ql = p.ql
                    x.qlen = p.qlen
                    x.tlen = p.tlen + 1
                    if x.G > -heap[0]:
                        heap[0] = -x.G
                        _heapadjust(0, heap_size, heap)
                if (x.G > opt.qr and x.G >= -heap[0]) or i < old_n:
                    if -1 in p.cpos:
                        qcntk = _query_occ4(query, p.qk - 1)
                        qcntl = _query_occ4(query, p.ql)
                        for qj in range(4):
                            if p.cpos[qj] != -1:
                                continue
                            k2 = int(Lq[qj] + qcntk[qj]) + 1
                            l2 = int(Lq[qj] + qcntl[qj])
                            if k2 > l2:
                                p.cpos[qj] = -2
                                continue
                            y = Cell()
                            y.qk = k2
                            y.ql = l2
                            y.pj = qj
                            y.qlen = p.qlen + 1
                            y.ppos = i
                            y.tlen = p.tlen
                            p.cpos[qj] = v.n
                            v.cells.append(y)
                i += 1

            if u.n:
                _save_hits(target, opt.t, b.hits, u)
            # push u to stack0 or pending (bwtsw2_core.c:546-580)
            full = chash[key]
            pos = full >> 32
            if pos:
                w = pending[pos - 1]
                if u.n:
                    if w.n < u.n:
                        pending[pos - 1], u = u, w
                        w = pending[pos - 1]
                    _merge_entry(w, u)
                if cnt == 0:
                    _remove_duplicate(w)
                    _save_narrow_hits(target, w, b1, opt.t, opt.is_)
                    _cut_tail(w, opt.z)
                    stack0.append(w)
                    pending[pos - 1] = None
                    n_pending -= 1
            elif cnt:
                if u.n:
                    n_pending += 1
                    pending.append(u)
                    chash[key] = (len(pending) << 32) | cnt
            else:
                _save_narrow_hits(target, u, b1, opt.t, opt.is_)
                _cut_tail(u, opt.z)
                stack0.append(u)

    resolve_duphits(query, b, opt.is_)
    resolve_duphits(query, b1, opt.is_)
    return b, b1
