"""In-memory BWT of a single read (bwt_lite.c): full SA + occ, used as
the "target" side of BWA-SW's BWT x BWT dynamic programming.

Copy of `ibwa_tpu/bwasw/bwtl.py`: the port keeps its own host code and
imports nothing of `ibwa_tpu`."""

from __future__ import annotations

import numpy as np

from .. import native


class Bwtl:
    """bwtl_t (bwt_lite.h): read BWT with sentinel-removed text, full SA
    and cumulative occ counts (the reference checkpoints every 16 bases;
    a full cumsum gives identical query results)."""

    def __init__(self, seq: np.ndarray):
        n = len(seq)
        self.seq_len = n
        sa = np.zeros(n + 1, dtype=np.int64)
        sa[0] = n
        if n:
            sa[1:] = native.sais(seq.astype(np.uint8))
        self.sa = sa
        s = np.zeros(n + 1, dtype=np.uint8)
        primary = 0
        nz = sa != 0
        s[nz] = seq[sa[nz] - 1]
        primary = int(np.flatnonzero(~nz)[0])
        self.primary = primary
        # drop the sentinel row (bwt_lite.c:23)
        bwt = np.concatenate([s[:primary], s[primary + 1:]])[:n]
        self.bwt = bwt
        # cumulative counts: cum[c][i] = #{j < i : bwt[j] == c}
        self.cum = np.zeros((4, n + 1), dtype=np.int64)
        for c in range(4):
            np.cumsum(bwt == c, out=self.cum[c][1:])
        self.L2 = np.zeros(5, dtype=np.int64)
        self.L2[1:] = np.cumsum([int(self.cum[c][n]) for c in range(4)])

    def occ4(self, k: int) -> np.ndarray:
        """bwtl_occ4 (bwt_lite.c:69-83)."""
        if k == -1 or k == 0xFFFFFFFF:
            return np.zeros(4, dtype=np.int64)
        if k >= self.primary:
            k -= 1
        return self.cum[:, min(k, self.seq_len - 1) + 1].copy()

    def two_occ4(self, k: int, l: int) -> tuple[np.ndarray, np.ndarray]:
        return self.occ4(k), self.occ4(l)
