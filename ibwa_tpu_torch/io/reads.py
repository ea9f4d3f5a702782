"""Read loading/encoding with the reference's conventions.

bwa_read_seq (bwaseqio.c:145-208): 2-bit encode via nst_nt4_table, store
`seq` REVERSED (plain) and `rseq` reverse-complemented, strip a trailing
"/1" or "/2" from names, optional quality trimming (-q).

Copy of `ibwa_tpu/io/reads.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..index.formats import NT4_TABLE
from .fasta import read_fastx

BWA_MIN_RDLEN = 35


@dataclasses.dataclass
class Read:
    name: str
    seq: np.ndarray   # reversed clipped original, nt4 codes
    rseq: np.ndarray  # reverse-complement of clipped original, nt4 codes
    qual: bytes | None
    full_len: int
    clip_len: int
    orig: np.ndarray | None = None  # full-length forward codes (untrimmed)
    bc: str = ""                    # barcode (-B), empty if unused

    @property
    def len(self) -> int:
        return len(self.seq)


def _complement(codes: np.ndarray) -> np.ndarray:
    out = codes.copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


def trim_len(qual: bytes, full_len: int, trim_qual: int) -> int:
    """bwa_trim_read (bwaseqio.c:74-87): BWA-style 3' quality trimming."""
    s, max_s, max_l = 0, 0, full_len - 1
    for pos in range(full_len - 1, BWA_MIN_RDLEN - 2, -1):
        s += trim_qual - (qual[pos] - 33)
        if s < 0:
            break
        if s > max_s:
            max_s, max_l = s, pos
    return max_l + 1


BARCODE_LOW_QUAL = 13


def _load_reads_fast(path: str, is_comp: bool) -> list[Read] | None:
    """Vectorized plain-FASTQ fast path (no trim/barcode/offset-64): one
    pass over the whole file, one NT4 translate + complement over the
    concatenated bases, per-read arrays as views.  The per-record Python
    loop costs ~80 us/read on this host — 47 s of a 300k-pair sampe run
    went to read loading before this."""
    import gzip
    with open(path, "rb") as f:
        head = f.read(2)
        if not head.startswith(b"@") or head[:2] == b"\x1f\x8b":
            return None
        data = head + f.read()
    lines = data.split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    if len(lines) % 4:
        return None
    names_b = lines[0::4]
    seqs_b = lines[1::4]
    quals_b = lines[3::4]
    lens = np.array([len(s) for s in seqs_b], dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    cat = np.frombuffer(b"".join(seqs_b), dtype=np.uint8)
    codes_all = NT4_TABLE[cat]
    comp_all = codes_all.copy()
    m = comp_all < 4
    comp_all[m] = 3 - comp_all[m]
    reads = []
    for i, nb in enumerate(names_b):
        name = nb[1:].split()[0].decode("latin-1")
        if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
            name = name[:-2]
        a, b = int(starts[i]), int(starts[i] + lens[i])
        codes = codes_all[a:b]
        rs = comp_all[a:b] if is_comp else codes
        reads.append(Read(
            name=name,
            seq=codes[::-1],
            rseq=rs[::-1],
            qual=quals_b[i] or None,
            full_len=b - a,
            clip_len=b - a,
            orig=codes,
            bc="",
        ))
    return reads


@dataclasses.dataclass
class ReadBatch:
    """Whole-file read set as flat blobs (the native emit path's input
    contract) — no per-read Python objects.

    orig_blob holds forward full-length nt4 codes; the native side
    derives reversed/revcomp views itself.  Offsets are int64 [n+1]."""

    n: int
    names: list[bytes] | None    # unused fast-path marker (blob is canonical)
    name_blob: np.ndarray
    name_off: np.ndarray
    orig_blob: np.ndarray
    orig_off: np.ndarray
    qual_blob: np.ndarray
    qual_off: np.ndarray
    lens: np.ndarray             # clip_len per read (int32)
    fulls: np.ndarray            # full_len per read (int32)

    def read(self, i: int) -> Read:
        """Materialize one Read (mate-rescue candidates only)."""
        a, b = int(self.orig_off[i]), int(self.orig_off[i + 1])
        codes = self.orig_blob[a:b]
        qa, qb = int(self.qual_off[i]), int(self.qual_off[i + 1])
        qual = self.qual_blob[qa:qb].tobytes() if qb > qa else None
        rs = _complement(codes)
        na, nb = int(self.name_off[i]), int(self.name_off[i + 1])
        name = self.name_blob[na:nb].tobytes()
        return Read(name=name.decode("latin-1"),
                    seq=codes[::-1], rseq=rs[::-1], qual=qual,
                    full_len=b - a, clip_len=b - a, orig=codes, bc="")


def load_read_batch(path: str) -> ReadBatch | None:
    """Vectorized plain-FASTQ -> ReadBatch (no trim/barcode/offset-64
    support; callers fall back to load_reads for those modes)."""
    import ctypes

    from .. import native
    with open(path, "rb") as f:
        head = f.read(2)
        if not head.startswith(b"@") or head[:2] == b"\x1f\x8b":
            return None
        data = np.frombuffer(head + f.read(), dtype=np.uint8)
    lib = native.load()
    u8p, i64p = (ctypes.POINTER(ctypes.c_uint8),
                 ctypes.POINTER(ctypes.c_int64))
    dptr = data.ctypes.data_as(u8p)
    totals = np.zeros(3, dtype=np.int64)
    n = lib.ibwa_fastq_scan(dptr, len(data),
                            totals.ctypes.data_as(i64p),
                            None, None, None, None, None, None)
    if n < 0:
        return None
    n = int(n)
    orig_blob = np.empty(max(int(totals[0]), 1), dtype=np.uint8)
    qual_blob = np.empty(max(int(totals[1]), 1), dtype=np.uint8)
    name_blob = np.empty(max(int(totals[2]), 1), dtype=np.uint8)
    orig_off = np.zeros(n + 1, dtype=np.int64)
    qual_off = np.zeros(n + 1, dtype=np.int64)
    name_off = np.zeros(n + 1, dtype=np.int64)
    lib.ibwa_fastq_scan(dptr, len(data), None,
                        orig_blob.ctypes.data_as(u8p),
                        orig_off.ctypes.data_as(i64p),
                        qual_blob.ctypes.data_as(u8p),
                        qual_off.ctypes.data_as(i64p),
                        name_blob.ctypes.data_as(u8p),
                        name_off.ctypes.data_as(i64p))
    l32 = np.diff(orig_off).astype(np.int32)
    return ReadBatch(n=n, names=None, name_blob=name_blob,
                     name_off=name_off, orig_blob=orig_blob,
                     orig_off=orig_off, qual_blob=qual_blob,
                     qual_off=qual_off, lens=l32, fulls=l32)


def load_reads(path: str, trim_qual: int = 0, is_64: bool = False,
               is_comp: bool = True, l_bc: int = 0) -> list[Read]:
    # is_comp=False (color space): rseq is the plain reverse
    # (bwaseqio.c:192 with BWA_MODE_COMPREAD cleared); l_bc strips a
    # leading barcode (bwaseqio.c:163-177)
    if l_bc > 15:
        raise ValueError("the maximum barcode length is 15")
    if trim_qual < 1 and not is_64 and not l_bc:
        fast = _load_reads_fast(path, is_comp)
        if fast is not None:
            return fast
    reads = []
    for rec in read_fastx(path):
        if len(rec.seq) <= l_bc:
            continue
        bc = ""
        seq_str, qual_str = rec.seq, rec.qual
        if l_bc:
            bc = "".join(
                c.lower() if (qual_str
                              and ord(qual_str[i]) - (64 if is_64 else 33)
                              < BARCODE_LOW_QUAL)
                else c.upper()
                for i, c in enumerate(seq_str[:l_bc]))
            seq_str = seq_str[l_bc:]
            if qual_str:
                qual_str = qual_str[l_bc:]
        raw = np.frombuffer(seq_str.encode("latin-1"), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        qual = None
        if qual_str:
            qual = qual_str.encode("latin-1")
            if is_64:
                qual = bytes(q - 31 for q in qual)
        full_len = len(codes)
        clip = full_len
        if trim_qual >= 1 and qual is not None:
            clip = trim_len(qual, full_len, trim_qual)
        kept = codes[:clip]
        name = rec.name
        if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
            name = name[:-2]
        rs = _complement(kept) if is_comp else kept
        reads.append(Read(
            name=name,
            seq=kept[::-1].copy(),
            rseq=rs[::-1].copy(),
            qual=qual,
            full_len=full_len,
            clip_len=clip,
            orig=codes,
            bc=bc,
        ))
    return reads
