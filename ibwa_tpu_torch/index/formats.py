"""Readers/writers for the reference-compatible index artifact set.

Formats (byte-level contracts, cf. the reference source):
  .pac   2-bit packed bases, base i in byte i>>2 at bit offset (3-(i&3))*2;
         trailer: [0x00 pad byte if l_pac%4==0] + 1 byte (l_pac % 4)
         (bntseq.c:238-248)
  .rpac  same packing of the REVERSED (not complemented) sequence; file is
         always (l>>2)+1 data bytes + 1 trailer byte (bwtmisc.c:160-185)
  .ann   text: "l_pac n_seqs seed\\n" then per contig two lines
         (bntseq.c:58-75)
  .amb   text: "l_pac n_seqs n_holes\\n" then one line per N-hole
         (bntseq.c:76-85)
  .bwt   u32 primary, u32 L2[1..4], then the interleaved occ/BWT words:
         per 128-base block 4 count words + 8 text words, final 4-word
         checkpoint at the end (bwtio.c:7-15, bwtmisc.c:122-144)
  .sa    u32 primary, L2[1..4], sa_intv, seq_len, then sa[1..n_sa-1]
         (bwtio.c:17-27)

Copy of `ibwa_tpu/index/formats.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct

import numpy as np

OCC_INTERVAL = 128
SA_INTERVAL = 32

# base encoding: A=0 C=1 G=2 T=3, anything else 4 ('-' is 5); see
# nst_nt4_table (bntseq.c:39-56)
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    NT4_TABLE[_b] = _i
    NT4_TABLE[ord(chr(_b).lower())] = _i
for _i, _b in enumerate(b"0123"):   # color-space digits (bntseq.c:42)
    NT4_TABLE[_b] = _i
NT4_TABLE[ord("-")] = 5


@dataclasses.dataclass
class ContigAnn:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0


@dataclasses.dataclass
class AmbHole:
    offset: int
    length: int
    amb: str


@dataclasses.dataclass
class Bns:
    """Packed-reference metadata (the reference's bntseq_t)."""

    l_pac: int
    seed: int
    anns: list[ContigAnn]
    ambs: list[AmbHole]

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    @property
    def n_holes(self) -> int:
        return len(self.ambs)


def write_ann(path: str, bns: Bns) -> None:
    with open(path, "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.seed}\n")
        for a in bns.anns:
            if a.anno:
                f.write(f"{a.gi} {a.name} {a.anno}\n")
            else:
                f.write(f"{a.gi} {a.name}\n")
            f.write(f"{a.offset} {a.length} {a.n_ambs}\n")


def write_amb(path: str, bns: Bns) -> None:
    with open(path, "w") as f:
        f.write(f"{bns.l_pac} {bns.n_seqs} {bns.n_holes}\n")
        for h in bns.ambs:
            f.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann(path: str) -> Bns:
    with open(path) as f:
        tok = f.read().split("\n")
    l_pac, n_seqs, seed = (int(x) for x in tok[0].split())
    anns = []
    for i in range(n_seqs):
        head = tok[1 + 2 * i].split(None, 2)
        gi = int(head[0])
        name = head[1]
        anno = head[2] if len(head) > 2 else ""
        off, ln, na = (int(x) for x in tok[2 + 2 * i].split())
        anns.append(ContigAnn(name, anno, off, ln, na, gi))
    return Bns(l_pac=l_pac, seed=seed, anns=anns, ambs=[])


def read_amb(path: str, bns: Bns) -> None:
    with open(path) as f:
        lines = f.read().strip().split("\n")
    _, _, n_holes = (int(x) for x in lines[0].split())
    bns.ambs = []
    for i in range(n_holes):
        off, ln, amb = lines[1 + i].split()
        bns.ambs.append(AmbHole(int(off), int(ln), amb))


def pack_bases(codes: np.ndarray) -> np.ndarray:
    """2-bit pack codes (values 0..3) into bytes, base 0 in the high bits."""
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    quads = codes.reshape(-1, 4).astype(np.uint8)
    return (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]


def unpack_bases(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_bases for the first n bases."""
    b = np.asarray(pac, dtype=np.uint8)
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = (b >> 6) & 3
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:n]


def write_pac(path: str, codes: np.ndarray) -> None:
    l_pac = len(codes)
    data = pack_bases(codes).tobytes()
    with open(path, "wb") as f:
        f.write(data)
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def write_rpac(path: str, codes: np.ndarray) -> None:
    """Reversed (not complemented) pac; always (l>>2)+1 data bytes."""
    l_pac = len(codes)
    rev = codes[::-1].copy()
    data = pack_bases(rev).tobytes()
    n_bytes = (l_pac >> 2) + 1
    data = data.ljust(n_bytes, b"\x00")[:n_bytes]
    with open(path, "wb") as f:
        f.write(data)
        f.write(bytes([l_pac % 4]))


def read_pac(path: str) -> np.ndarray:
    """Unpacked 2-bit codes from a .pac/.rpac file."""
    raw = np.fromfile(path, dtype=np.uint8)
    # seq_len recovery per bwa_seq_len (bwtmisc.c:43-54):
    # (file_size - 2) * 4 + last_byte, where last_byte = l_pac % 4
    seq_len = (len(raw) - 2) * 4 + int(raw[-1])
    return unpack_bases(raw[:-1], seq_len)


@dataclasses.dataclass
class BwtIndex:
    """One strand's FM-index in the interleaved on-disk layout."""

    primary: int
    L2: np.ndarray  # uint32[5], L2[0] = 0
    seq_len: int
    interleaved: np.ndarray  # uint32[bwt_size]
    sa_intv: int = 0
    sa: np.ndarray | None = None  # uint32[n_sa] with sa[0] = 0xFFFFFFFF

    @property
    def bwt_size(self) -> int:
        return len(self.interleaved)

    @property
    def n_sa(self) -> int:
        return (self.seq_len + self.sa_intv) // self.sa_intv


def interleave_occ(bwt_words: np.ndarray, seq_len: int) -> np.ndarray:
    """Insert 4-word occ checkpoints every 128 bases + a final checkpoint.

    bwt_words: uint32[ceil(seq_len/16)] plain packed BWT codes.
    Semantics of bwt_bwtupdate_core (bwtmisc.c:122-144).
    """
    n_text_words = (seq_len + 15) >> 4
    assert len(bwt_words) == n_text_words
    w = bwt_words
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    # occ checkpoints need cumulative counts only at BLOCK boundaries:
    # count each code per word with a SWAR popcount, sum per 8-word
    # block, cumsum over blocks.  (The previous per-base cumsum
    # materialized 4*(seq_len+1) uint64 — ~99 GB at 3.1 Gbp.)
    pad = n_text_words * 16 - seq_len
    wblocks = n_blocks * 8
    counts = np.zeros((4, wblocks), dtype=np.uint32)
    for c in range(4):
        t = ~(w ^ np.uint32(0x55555555 * c))
        t &= t >> np.uint32(1)
        t &= np.uint32(0x55555555)
        t = t - ((t >> np.uint32(1)) & np.uint32(0x55555555))
        t = (t & np.uint32(0x33333333)) + ((t >> np.uint32(2))
                                           & np.uint32(0x33333333))
        t = (t + (t >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
        cc = (t * np.uint32(0x01010101)) >> np.uint32(24)
        if c == 0 and pad and n_text_words:
            cc[-1] -= np.uint32(pad)   # padding bits count as code 0
        counts[c, :n_text_words] = cc
    blk = counts.reshape(4, n_blocks, 8).sum(axis=2, dtype=np.uint64)
    cum = np.zeros((4, n_blocks + 1), dtype=np.uint64)
    np.cumsum(blk, axis=1, out=cum[:, 1:])
    del counts, blk
    # cum[c][i] = count of code c before block i; cum[c][n_blocks] = total
    out_size = n_text_words + (n_blocks + 1) * 4
    out = np.zeros(out_size, dtype=np.uint32)
    # vectorized interleave: full blocks are 12 words (4 ckpt + 8 text);
    # only the final block may carry fewer text words
    full = max(n_blocks - 1, 0)
    if full:
        body = out[: full * 12].reshape(full, 12)
        for c in range(4):
            body[:, c] = cum[c][:full]
        body[:, 4:] = w[: full * 8].reshape(full, 8)
    pos = full * 12
    widx = full * 8
    if n_blocks:
        for c in range(4):
            out[pos + c] = cum[c][full]
        pos += 4
        rem = n_text_words - widx
        out[pos : pos + rem] = w[widx:]
        pos += rem
    # trailing checkpoint with the totals (bwtmisc.c:139-140)
    for c in range(4):
        out[pos + c] = cum[c][n_blocks]
    pos += 4
    assert pos == out_size, (pos, out_size)
    return out


def write_bwt(path: str, idx: BwtIndex) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<I", idx.primary))
        f.write(np.asarray(idx.L2[1:5], dtype="<u4").tobytes())
        f.write(np.asarray(idx.interleaved, dtype="<u4").tobytes())


def read_bwt(path: str) -> BwtIndex:
    with open(path, "rb") as f:
        head = f.read(20)
    primary = struct.unpack_from("<I", head, 0)[0]
    l2 = np.zeros(5, dtype=np.uint32)
    l2[1:] = np.frombuffer(head, dtype="<u4", count=4, offset=4)
    # memmap: SAM stages touch only the blocks their SA walks visit, so
    # faulting pages in on demand beats reading the whole strand upfront
    # (the reference pays the full fread, bwtio.c:51-70 — our startup is
    # the dominant samse cost at the 8k-read bench scale)
    size = os.path.getsize(path)
    interleaved = np.memmap(path, dtype="<u4", mode="r", offset=20,
                            shape=((size - 20) // 4,))
    return BwtIndex(primary=primary, L2=l2, seq_len=int(l2[4]),
                    interleaved=interleaved)


def write_sa(path: str, idx: BwtIndex) -> None:
    assert idx.sa is not None
    with open(path, "wb") as f:
        f.write(struct.pack("<I", idx.primary))
        f.write(np.asarray(idx.L2[1:5], dtype="<u4").tobytes())
        f.write(struct.pack("<II", idx.sa_intv, idx.seq_len))
        f.write(np.asarray(idx.sa[1:], dtype="<u4").tobytes())


def read_sa(path: str, idx: BwtIndex) -> None:
    with open(path, "rb") as f:
        data = f.read()
    primary = struct.unpack_from("<I", data, 0)[0]
    if primary != idx.primary:
        raise ValueError("SA-BWT inconsistency: primary differs")
    sa_intv, seq_len = struct.unpack_from("<II", data, 20)
    if seq_len != idx.seq_len:
        raise ValueError("SA-BWT inconsistency: seq_len differs")
    idx.sa_intv = sa_intv
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.empty(n_sa, dtype=np.uint32)
    sa[0] = 0xFFFFFFFF
    sa[1:] = np.frombuffer(data, dtype="<u4", offset=28, count=n_sa - 1)
    idx.sa = sa
