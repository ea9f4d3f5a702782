"""Peaks of the card and the work a kernel has to do, counted from shapes.

`HBM_BYTES_PER_S` is NVIDIA's published HBM3 bandwidth of one H100 SXM at
its 700 W limit; a run prints the card's power limit beside every share.

`width_pass_bytes` counts what K6, the width pass, has to move for a set
of reads, whatever implements it: bwa's width computation (bwt_cal_width,
bwtaln.c:54-78) over each read and its seed suffix on both strands asks
occ at the two ends of an SA interval a base; each such query reads one
row of the index in bwa's own layout (`OCC_INTV` bases a row: four u32
counts and the row's 2-bit text, bwt.h:56-63), and each row the reads
need is counted once.  Added to that: the reads in (a byte a base, both
strands, read and seed suffix) and the widths out (bwt_width_t, a u32
width and an i32 block id a position, len + 1 positions).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
OCC_INTV = 128                       # bases a row of bwa's .bwt
ROW_BYTES = 4 * 4 + OCC_INTV // 4    # four u32 counts + 2-bit text: 48
WIDTH_BYTES = 8                      # bwt_width_t
NEG1 = -1


def _occ(bwt, counts, block: int, k, c):
    """occ(k, c) for tensors k (int64, -1 = none) and c (0..3)."""
    import torch
    safe = k.clamp(min=0)
    b = safe // block
    base = counts[b, c.clamp(max=3)].long()
    idx = b[:, None] * block + torch.arange(block, device=k.device)
    idx_c = idx.clamp(max=bwt.numel() - 1)
    seg = bwt[idx_c]
    inside = idx <= safe[:, None]
    n = ((seg == c[:, None].to(seg.dtype)) & inside).sum(1)
    return torch.where(k < 0, torch.zeros_like(k), base + n)


def width_rows(fm: dict, codes, seq_len: int):
    """The distinct-row keys (row index; -1 where a query reads no row)
    of the width computation over `codes` (uint8 [N, L] tensor, 0..3; 4
    resets as bwa) on one strand.  fm: {bwt, counts, block, L2 (list),
    primary} tensors of the strand, on the same device."""
    import torch
    n_reads, length = codes.shape
    dev = codes.device
    k = torch.zeros(n_reads, dtype=torch.long, device=dev)
    l = torch.full((n_reads,), seq_len, dtype=torch.long, device=dev)
    L2 = torch.tensor(fm["L2"], dtype=torch.long, device=dev)
    keys = []

    def row(q):
        # the row bwt_occ reads for occ(q, .): none at -1 or seq_len
        kk = q - (q >= fm["primary"]).long()
        r = kk // OCC_INTV
        return torch.where((q < 0) | (q == seq_len),
                           torch.full_like(q, NEG1), r)

    for i in range(length):
        c = codes[:, i].long()
        ok = c < 4
        qk = torch.where(k > 0, k - 1, torch.full_like(k, NEG1))
        keys.append(torch.where(ok, row(qk), torch.full_like(qk, NEG1)))
        keys.append(torch.where(ok, row(l), torch.full_like(l, NEG1)))
        cc = c.clamp(max=3)
        nk = L2[cc] + _occ(fm["bwt"], fm["counts"], fm["block"], qk, cc) + 1
        nl = L2[cc] + _occ(fm["bwt"], fm["counts"], fm["block"], l, cc)
        reset = (nk > nl) | ~ok
        k = torch.where(reset, torch.zeros_like(nk), nk)
        l = torch.where(reset, torch.full_like(nl, seq_len), nl)
    return torch.stack(keys)


def width_pass_bytes(fms: tuple[dict, dict], seqs, rseqs, seed_len: int,
                     seq_len: int) -> int:
    """Bytes K6 moves at the least for reads `seqs` / `rseqs` (uint8 [N,
    L] tensors of the reversed reads and their reverse complements, as
    `aln` searches them, all of length L): bwa's widths[a] over fms[a],
    the reversed read on the text's index and its reverse complement on
    the reversed text's."""
    import torch
    n_reads, length = seqs.shape
    if n_reads == 0:
        return 0
    strands = [(fms[0], seqs), (fms[1], rseqs)]
    parts = []
    for fm, codes in strands:
        rows = [width_rows(fm, codes, seq_len)]
        if length > seed_len:
            rows.append(width_rows(fm, codes[:, length - seed_len:],
                                   seq_len))
        r = torch.cat([x.flatten() for x in rows])
        r = r[r >= 0]
        parts.append(torch.unique(r).numel())
    seed = seed_len if length > seed_len else 0
    reads_in = n_reads * 2 * (length + seed)
    widths_out = n_reads * 2 * ((length + 1) + (seed + 1 if seed else 0)) \
        * WIDTH_BYTES
    return sum(parts) * ROW_BYTES + reads_in + widths_out


def strand_tensors(ref_fm, device: str) -> dict:
    """A `refindex.RefFm`'s arrays as the tensors `width_rows` reads."""
    import torch
    from benchmark.refindex import BLOCK
    return {"bwt": torch.from_numpy(np.array(ref_fm.bwt)).to(device),
            "counts": torch.from_numpy(np.array(ref_fm.counts)).to(device),
            "block": BLOCK, "L2": ref_fm.L2, "primary": ref_fm.primary}
