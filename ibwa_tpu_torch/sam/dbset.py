"""Multi-reference database set: N indexed references as one virtual
concatenated address space (the reference's dbset.c).

Each db contributes bns.l_pac bases; db i's global coordinates start at
offset_i = sum of earlier l_pacs (dbset_restore, dbset.c:135-173).

Copy of `ibwa_tpu/sam/dbset.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import bisect
import dataclasses
import os

import numpy as np

from .. import native
from ..fm.fmindex import FmIndex
from ..index import formats
from ..index.builder import load_index
from ..index.formats import Bns


@dataclasses.dataclass
class BwtDb:
    """One indexed reference (the reference's bwtdb_t + seq_t pair)."""

    prefix: str
    bns: Bns
    offset: int                      # global coordinate of base 0
    fm: list[FmIndex | None]         # [fwd, rev], lazy
    pac: np.ndarray | None = None    # unpacked 2-bit codes, lazy
    remap: dict | None = None        # seqid -> remap record (iBWA layer)
    target_idx_cache: dict = dataclasses.field(default_factory=dict)
    ntbns: Bns | None = None         # color space: nucleotide bns
    ntpac: np.ndarray | None = None  # color space: nucleotide pac, lazy
    _sa_handles: list = dataclasses.field(
        default_factory=lambda: [None, None])

    def load_ntpac(self) -> np.ndarray:
        if self.ntpac is None:
            self.ntpac = formats.read_pac(self.prefix + ".nt.pac")
        return self.ntpac

    def load_fm(self, strand: int) -> FmIndex:
        if self.fm[strand] is None:
            self.fm[strand] = FmIndex(load_index(self.prefix, strand))
        return self.fm[strand]

    def load_pac(self) -> np.ndarray:
        if self.pac is None:
            self.pac = formats.read_pac(self.prefix + ".pac")
        return self.pac

    def load_pac_packed(self) -> np.ndarray:
        """Raw packed .pac bytes (4 bases/byte) — the native emit path
        extracts codes itself; skips the numpy unpack of the whole
        genome."""
        path = self.prefix + ".pac"
        size = os.path.getsize(path)
        raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(size,))
        l_pac = (size - 2) * 4 + int(raw[-1])
        return raw[:(l_pac + 3) // 4]

    def pac_window(self, pos: int, take: int) -> np.ndarray:
        """Unpack codes for [pos, pos+take) straight from the packed
        memmap (base 0 in the high bits, see formats.pack_bases) —
        extract_sequence callers want ~100-600 bp windows, for which
        load_pac's whole-genome unpack was ~0.2 s + 1 byte/base RSS."""
        if self.pac is not None:    # already unpacked by another caller
            return self.pac[pos:pos + take]
        raw = self.load_pac_packed()
        idx = np.arange(pos, pos + take, dtype=np.int64)
        return (raw[idx >> 2] >> ((3 - (idx & 3)) * 2).astype(np.uint8)) & 3

    def sa2seq(self, strand: int, sa: np.ndarray, seq_len) -> np.ndarray:
        """Batched bwtdb_sa2seq (dbset.c:239-246): SA index -> global pos.

        strand != 0 uses the forward index; strand == 0 the reverse one.
        seq_len may be scalar or per-query array.
        """
        sa = np.asarray(sa, dtype=np.uint32)
        if strand:
            vals = self._sa_handle(0).lookup(sa)
            return self.offset + vals.astype(np.int64)
        fm = self.load_fm(1)
        vals = self._sa_handle(1).lookup(sa)
        return (self.offset + fm.seq_len
                - (vals.astype(np.int64) + np.asarray(seq_len,
                                                      dtype=np.int64)))

    def _sa_handle(self, strand: int) -> native.SaHandle:
        h = self._sa_handles[strand]
        if h is None:
            fm = self.load_fm(strand)
            h = native.SaHandle(fm._interleaved, fm.primary, fm.L2,
                                fm.seq_len, fm.sa_intv, fm.sa)
            self._sa_handles[strand] = h
        return h


class DbSet:
    """dbset_t: the ordered collection of references (dbset.c:135-238)."""

    def __init__(self, prefixes: list[str], color_space: bool = False):
        self.dbs: list[BwtDb] = []
        offset = 0
        for p in prefixes:
            bns = formats.read_ann(p + ".ann")
            formats.read_amb(p + ".amb", bns)
            db = BwtDb(prefix=p, bns=bns, offset=offset, fm=[None, None])
            if color_space:  # dbset.c:161-164
                ntbns = formats.read_ann(p + ".nt.ann")
                formats.read_amb(p + ".nt.amb", ntbns)
                db.ntbns = ntbns
            self.dbs.append(db)
            offset += bns.l_pac
        self.l_pac = offset
        self._offsets = [db.offset for db in self.dbs]
        self.color_space = color_space

    @property
    def count(self) -> int:
        return len(self.dbs)

    def coord2idx(self, pos: int) -> int:
        """Global position -> db index (dbset.c:17-39)."""
        return bisect.bisect_right(self._offsets, pos) - 1

    def seq_for_pos(self, bns: Bns, pac_coor: int) -> int:
        """bns_seq_for_pos (bntseq.c:278-294): local coordinate -> contig."""
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

    def coor_pac2real(self, pos: int, length: int
                      ) -> tuple[int, int, Bns, int]:
        """dbset_coor_pac2real (dbset.c:247-255) + bns_coor_pac2real
        (bntseq.c:296-318).  Returns (nn, seqid, bns, dboffset)."""
        idx = self.coord2idx(pos)
        db = self.dbs[idx]
        bns = db.bns
        local = pos - db.offset
        seqid = self.seq_for_pos(bns, local)
        # hole overlap count: binary search, counts the FIRST overlapping
        # hole only (matches the reference's early break)
        left, right, nn = 0, bns.n_holes, 0
        while left < right:
            mid = (left + right) >> 1
            h = bns.ambs[mid]
            if local >= h.offset + h.length:
                left = mid + 1
            elif local + length <= h.offset:
                right = mid
            else:
                if local >= h.offset:
                    nn += (h.offset + h.length - local
                           if h.offset + h.length < local + length else length)
                else:
                    nn += (h.length if h.offset + h.length < local + length
                           else length - (h.offset - local))
                break
        return nn, seqid, bns, db.offset

    def extract_sequence(self, beg: int, length: int,
                         nt: bool = False) -> np.ndarray:
        """dbset_extract_sequence (dbset.c:306-325): 2-bit codes for
        [beg, beg+length) of the global space, truncated at l_pac.
        nt=True reads the nucleotide pac (color-space mode)."""
        out = np.empty(length, dtype=np.uint8)
        total = 0
        while total < length:
            if beg >= self.l_pac:
                break
            idx = self.coord2idx(beg)
            db = self.dbs[idx]
            pos = beg - db.offset
            if nt:
                pac = db.load_ntpac()
                take = min(length - total, len(pac) - pos)
                out[total:total + take] = pac[pos:pos + take]
            else:
                take = min(length - total, db.bns.l_pac - pos)
                out[total:total + take] = db.pac_window(pos, take)
            total += take
            beg += take
        return out[:total]

    def extract_remapped(self, dbidx: int, seqid: int, beg: int,
                         length: int) -> np.ndarray:
        """dbset_extract_remapped (dbset.c:261-304); without a remap file
        this degenerates to extract_sequence."""
        db = self.dbs[dbidx]
        if seqid < 0 or db.remap is None:
            return self.extract_sequence(beg, length)
        from . import remap as remap_mod
        return remap_mod.extract_remapped(self, dbidx, seqid, beg, length)

    def sam_SQ(self, rg_line: str | None = None) -> str:
        """dbset_print_sam_SQ (dbset.c:327-339): @SQ lines, skipping
        remapped contigs."""
        lines = []
        for db in self.dbs:
            for j, a in enumerate(db.bns.anns):
                if db.remap is None or j not in db.remap:
                    lines.append(f"@SQ\tSN:{a.name}\tLN:{a.length}\n")
        if rg_line:
            lines.append(rg_line + "\n")
        return "".join(lines)
