"""Host-side FM-index queries + the structure-of-arrays device export.

The on-disk interleaved layout (12 words per 128-base block: 4 occ counts +
8 packed text words, bwt.h:56-63) is re-laid-out for the TPU as:

    ckpt:  uint32[n_blk + 1, 4]   occ checkpoints (counts before block)
    words: uint32[n_blk, 8]       2-bit packed BWT text, zero padded

Host queries here are exact mirrors of bwt_occ / bwt_2occ / bwt_occ4 /
bwt_2occ4 / bwt_match_exact[_alt] (bwt.c:90-250) and are used by the
reference emulator, tests and the host fallback path.

Copy of `ibwa_tpu/fm/fmindex.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import numpy as np

from ..index.formats import BwtIndex

OCC_INTV = 128
NEG1 = 0xFFFFFFFF  # bwtint_t(-1)


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF  # & needed: no 32-bit wraparound


class FmIndex:
    """One strand's FM-index with host-side query ops."""

    def __init__(self, idx: BwtIndex):
        self.primary = int(idx.primary)
        self.L2 = idx.L2.astype(np.int64)
        self.seq_len = int(idx.seq_len)
        self.sa_intv = idx.sa_intv
        self.sa = idx.sa
        self._interleaved = idx.interleaved
        self._ckpt = None
        self._words = None

    # the de-interleaved SoA planes (device export) are built lazily: the
    # native SAM stages query through `_interleaved` only, and the copy
    # is ~18 MB + 15 ms per strand on a 32 Mbp genome
    @property
    def ckpt(self) -> np.ndarray:
        if self._ckpt is None:
            self._build_soa()
        return self._ckpt

    @property
    def words(self) -> np.ndarray:
        if self._words is None:
            self._build_soa()
        return self._words

    def _build_soa(self) -> None:
        # the interleaved stream is ragged: every block is 4 ckpt words + up
        # to 8 text words; only the last block may be short
        n_blk = (self.seq_len + OCC_INTV - 1) // OCC_INTV
        n_text_words = (self.seq_len + 15) >> 4
        flat = self._interleaved
        self._ckpt = np.zeros((n_blk + 1, 4), dtype=np.uint32)
        self._words = np.zeros((n_blk, 8), dtype=np.uint32)
        if n_blk:
            full = n_blk - 1
            body = flat[: full * 12].reshape(full, 12)
            self._ckpt[:full] = body[:, :4]
            self._words[:full] = body[:, 4:]
            rem = n_text_words - full * 8
            off = full * 12
            self._ckpt[full] = flat[off : off + 4]
            self._words[full, :rem] = flat[off + 4 : off + 4 + rem]
            self._ckpt[n_blk] = flat[off + 4 + rem : off + 8 + rem]

    # -- scalar queries ----------------------------------------------------

    def occ(self, k: int, c: int) -> int:
        """Count of c among B0[0..k] inclusive (bwt.c:90-113)."""
        if k == self.seq_len or k == NEG1 or k < 0:
            return (int(self.L2[c + 1] - self.L2[c])
                    if k == self.seq_len else 0)
        if k >= self.primary:
            k -= 1
        blk, off = divmod(k, OCC_INTV)
        n = int(self.ckpt[blk][c])
        w = self.words[blk]
        nw = off >> 4
        pat = np.uint32(0x55555555 * c)
        if nw:
            full = w[:nw] ^ pat
            t = ~full & (~full >> np.uint32(1)) & np.uint32(0x55555555)
            n += int(_popcount32(t.astype(np.uint64)).sum())
        z = int(w[nw] ^ pat)
        t = ~z & (~z >> 1) & 0x55555555
        nb = (off & 15) + 1
        t &= ~((1 << ((16 - nb) * 2)) - 1) & 0xFFFFFFFF
        n += bin(t & 0xFFFFFFFF).count("1")
        return n

    def occ4(self, k: int) -> np.ndarray:
        if k == NEG1 or k < 0:
            return np.zeros(4, dtype=np.int64)
        if k == self.seq_len:
            return (self.L2[1:5] - self.L2[0:4]).astype(np.int64)
        return np.array([self.occ(k, c) for c in range(4)], dtype=np.int64)

    def two_occ(self, k: int, l: int, c: int) -> tuple[int, int]:
        return self.occ(k, c), self.occ(l, c)

    def two_occ4(self, k: int, l: int) -> tuple[np.ndarray, np.ndarray]:
        return self.occ4(k), self.occ4(l)

    def match_exact_alt(self, sub: np.ndarray, k: int, l: int
                        ) -> tuple[int, int, int]:
        """Backward-extend (k,l) by sub (processed right-to-left);
        returns (n_hits, k, l) with n_hits 0 on mismatch (bwt.c:235-250)."""
        for i in range(len(sub) - 1, -1, -1):
            c = int(sub[i])
            if c > 3:
                return 0, k, l
            ok = self.occ(k - 1 if k > 0 else NEG1, c)
            ol = self.occ(l, c)
            k = int(self.L2[c]) + ok + 1
            l = int(self.L2[c]) + ol
            if k > l:
                return 0, k, l
        return l - k + 1, k, l

    def sa_at(self, k: int) -> int:
        """bwt_sa (bwt.c:69-79): walk to the nearest sampled slot."""
        add = 0
        while k % self.sa_intv != 0:
            add += 1
            k = self.inv_psi(k)
        return add + int(self.sa[k // self.sa_intv])

    def b0(self, k: int) -> int:
        blk, off = divmod(k, OCC_INTV)
        w = int(self.words[blk][off >> 4])
        return (w >> ((15 - (off & 15)) * 2)) & 3

    def inv_psi(self, k: int) -> int:
        if k == self.primary:
            return 0
        c = self.b0(k if k < self.primary else k - 1)
        return int(self.L2[c]) + self.occ(k, c)
