"""The reference's own FM-index, derived from the FASTA's bases.

`build` sorts the suffixes of the text and of its reverse by prefix
doubling (plain `torch.sort`; on the card for a configuration's genome, on
the CPU in the tests) and keeps each strand's BWT as one byte a row (4 at
the row of the whole text, bwa's `primary`) with occurrence counts every
`BLOCK` rows.  Rows follow bwa's convention (bwt.c): row 0 is the empty
suffix, a pattern's rows are those of the suffixes that start with it, and
occ(k, c) counts c in the BWT's rows 0..k.  `.bwt` is the text's strand and
`.rbwt` the reversed text's (bwa 0.5.9's index).

`RefFm` answers the queries the search reference asks (`occ`, `occ4`,
`match_exact_alt`) from those arrays, with numpy on the host.
"""

from __future__ import annotations

import pathlib

import numpy as np

BLOCK = 64           # rows between stored occurrence counts
NEG1 = 0xFFFFFFFF
_PREFIX = 20         # bases in the first sort key: 5**21 < 2**63


def suffix_array(codes, device: str):
    """Start positions of the text's non-empty suffixes in sorted order
    (int64 tensor on `device`); codes: uint8 0..3."""
    import torch
    text = torch.as_tensor(codes, device=device).long()
    n = text.numel()
    padded = torch.cat([text + 1, torch.zeros(_PREFIX, dtype=torch.long,
                                              device=device)])
    key = torch.zeros(n, dtype=torch.long, device=device)
    for j in range(_PREFIX):
        key = key * 5 + padded[j:j + n]
    del padded, text
    h = _PREFIX
    while True:
        skey, sa = torch.sort(key)
        new = torch.ones(n, dtype=torch.long, device=device)
        new[1:] = (skey[1:] != skey[:-1]).long()
        del skey
        rank_sorted = torch.cumsum(new, 0)
        del new
        if int(rank_sorted[-1]) == n:
            return sa
        rank = torch.empty(n, dtype=torch.long, device=device)
        rank[sa] = rank_sorted
        del rank_sorted, sa
        nxt = torch.zeros(n, dtype=torch.long, device=device)
        if h < n:
            nxt[:n - h] = rank[h:]
        key = rank * (n + 1) + nxt
        del rank, nxt
        h *= 2


def strand_arrays(codes: np.ndarray, device: str
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """(BWT uint8[n + 1], counts int32[n // BLOCK + 2, 4] of each base in
    the rows before each block, primary) of one strand's text."""
    import torch
    n = len(codes)
    sa = suffix_array(codes, device)
    text = torch.as_tensor(codes, device=device)
    bwt = torch.empty(n + 1, dtype=torch.uint8, device=device)
    bwt[0] = text[n - 1]
    prev = sa - 1
    bwt[1:] = torch.where(prev >= 0, text[prev.clamp(min=0)],
                          torch.tensor(4, dtype=torch.uint8, device=device))
    primary = int(torch.nonzero(sa == 0)[0, 0]) + 1
    del sa, prev
    n_blk = (n + 1 + BLOCK - 1) // BLOCK
    pad = torch.full((n_blk * BLOCK,), 4, dtype=torch.uint8, device=device)
    pad[:n + 1] = bwt
    per = torch.stack([(pad.view(n_blk, BLOCK) == c).sum(1)
                       for c in range(4)], 1)
    counts = torch.zeros((n_blk + 1, 4), dtype=torch.long, device=device)
    counts[1:] = torch.cumsum(per, 0)
    return (bwt.cpu().numpy(), counts.to(torch.int32).cpu().numpy(),
            primary)


def build(fasta_codes: np.ndarray, out: pathlib.Path, device: str) -> None:
    """Both strands' arrays of the text `fasta_codes` (uint8 0..3) under
    `out`: {fwd,rev}.bwt.npy, {fwd,rev}.occ.npy, meta.npz."""
    out.mkdir(parents=True, exist_ok=True)
    meta = {}
    for name, codes in (("fwd", fasta_codes),
                        ("rev", np.ascontiguousarray(fasta_codes[::-1]))):
        bwt, counts, primary = strand_arrays(codes, device)
        np.save(out / f"{name}.bwt.npy", bwt)
        np.save(out / f"{name}.occ.npy", counts)
        meta[f"{name}_primary"] = primary
    base = np.bincount(fasta_codes, minlength=4)[:4].astype(np.int64)
    meta["L2"] = np.concatenate([[0], np.cumsum(base)])
    np.savez(out / "meta.npz", **meta)


class RefFm:
    """One strand's FM-index queries over `build`'s arrays."""

    def __init__(self, where: pathlib.Path, strand: str):
        self.bwt = np.load(where / f"{strand}.bwt.npy", mmap_mode="r")
        self.counts = np.load(where / f"{strand}.occ.npy", mmap_mode="r")
        meta = np.load(where / "meta.npz")
        self.L2 = [int(v) for v in meta["L2"]]
        self.primary = int(meta[f"{strand}_primary"])
        self.seq_len = len(self.bwt) - 1

    def occ4(self, k: int) -> np.ndarray:
        """Each base's count among rows 0..k (none where k is -1)."""
        if k == NEG1 or k < 0:
            return np.zeros(4, dtype=np.int64)
        b = k // BLOCK
        seg = self.bwt[b * BLOCK:k + 1]
        return (self.counts[b].astype(np.int64)
                + np.bincount(seg, minlength=5)[:4])

    def occ(self, k: int, c: int) -> int:
        if k == NEG1 or k < 0:
            return 0
        b = k // BLOCK
        return int(self.counts[b, c]) + int(
            np.count_nonzero(self.bwt[b * BLOCK:k + 1] == c))

    def match_exact_alt(self, sub: np.ndarray, k: int, l: int
                        ) -> tuple[int, int, int]:
        """Extend (k, l) backwards by sub, right to left; (count, k, l),
        count 0 where the pattern does not occur (bwt.c:235-250)."""
        for i in range(len(sub) - 1, -1, -1):
            c = int(sub[i])
            if c > 3:
                return 0, k, l
            k = self.L2[c] + self.occ(k - 1 if k > 0 else NEG1, c) + 1
            l = self.L2[c] + self.occ(l, c)
            if k > l:
                return 0, k, l
        return l - k + 1, k, l


def load(where: pathlib.Path) -> tuple[RefFm, RefFm]:
    return RefFm(where, "fwd"), RefFm(where, "rev")
