"""Minimal BAM reader (the reference's bamlite.c): header parse +
per-record decode over a gzip/BGZF stream, plus bwa_read_bam's read
preparation (bwaseqio.c:89-141).

Copy of `ibwa_tpu/io/bam.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .reads import Read, _complement, trim_len

BAM_FREAD1 = 0x40
BAM_FREAD2 = 0x80
BAM_FREVERSE = 0x10

# "=ACMGRSVTWYHKDBN" 4-bit codes -> nt4 (bamlite.h / bwaseqio.c:87)
NT16_NT4 = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4],
                    dtype=np.uint8)


def iter_bam(path: str):
    """Yield (name, flag, seq4bit uint8 codes, qual bytes) per record."""
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", f.read(4))
        f.read(l_text)
        (n_ref,) = struct.unpack("<i", f.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            f.read(l_name + 4)
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            data = f.read(block_size)
            (_refid, _pos, bin_mq_nl, flag_nc, l_seq, _nrid, _npos,
             _tlen) = struct.unpack_from("<iiIIiiii", data, 0)
            l_qname = bin_mq_nl & 0xFF
            n_cigar = flag_nc & 0xFFFF
            flag = flag_nc >> 16
            off = 32
            name = data[off:off + l_qname - 1].decode("latin-1")
            off += l_qname + 4 * n_cigar
            nbytes = (l_seq + 1) // 2
            packed = np.frombuffer(data, dtype=np.uint8, count=nbytes,
                                   offset=off)
            off += nbytes
            qual = data[off:off + l_seq]
            codes4 = np.empty(l_seq, dtype=np.uint8)
            codes4[0::2] = packed[: (l_seq + 1) // 2] >> 4
            if l_seq > 1:
                codes4[1::2] = packed[: l_seq // 2] & 0xF
            yield name, flag, codes4, qual


def load_reads_bam(path: str, which: int, trim_qual: int = 0,
                   is_comp: bool = True) -> list[Read]:
    """bwa_read_bam (bwaseqio.c:89-141): flag-filtered read loading."""
    reads = []
    for name, flag, codes4, qual in iter_bam(path):
        go = ((which & 1) and (flag & BAM_FREAD1)) or \
             ((which & 2) and (flag & BAM_FREAD2)) or \
             ((which & 4) and not (flag & (BAM_FREAD1 | BAM_FREAD2)))
        if not go:
            continue
        codes = NT16_NT4[codes4].copy()
        q = bytes(min(b + 33, 126) for b in qual)
        if flag & BAM_FREVERSE:  # restore original read orientation
            codes = _complement(codes)[::-1].copy()
            q = q[::-1]
        full_len = len(codes)
        clip = full_len
        if trim_qual >= 1:
            clip = trim_len(q, full_len, trim_qual)
        kept = codes[:clip]
        rs = _complement(kept) if is_comp else kept
        reads.append(Read(
            name=name,
            seq=kept[::-1].copy(),
            rseq=rs[::-1].copy(),
            qual=q,
            full_len=full_len,
            clip_len=clip,
            orig=codes,
        ))
    return reads
