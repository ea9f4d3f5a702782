"""Index construction: FASTA -> {.pac,.rpac,.ann,.amb,.bwt,.rbwt,.sa,.rsa}.

Byte-parity with `ibwa index -a is` (reference bwtindex.c:42-186):
* N bases are replaced by lrand48()&3 draws from a fixed seed of 11,
  consumed in sequence order across contigs (bntseq.c:180-232)
* BWT built by suffix sort (SA-IS), occ checkpoints interleaved every 128
  bases, suffix array sampled every 32 positions

Copy of `ibwa_tpu/index/builder.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from ..io.fasta import read_fasta
from ..rng import Rand48
from . import formats
from .formats import AmbHole, Bns, BwtIndex, ContigAnn, NT4_TABLE


def fasta_to_bnt(fa_path: str, prefix: str) -> tuple[Bns, np.ndarray]:
    """Pack a FASTA into .pac/.ann/.amb; returns (bns, unpacked codes)."""
    rng = Rand48(11)
    anns: list[ContigAnn] = []
    ambs: list[AmbHole] = []
    all_codes: list[np.ndarray] = []
    offset = 0
    # kseq buffer-reuse quirk: a header without a comment inherits the most
    # recent comment string (kseq.h keeps the buffer; bntseq.c:200 strdups
    # whatever is in it). "(null)" only before any comment was ever seen.
    last_comment: str | None = None
    for rec in read_fasta(fa_path):
        raw = np.frombuffer(rec.seq.encode("latin-1"), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        is_n = codes >= 4
        n_ambs = 0
        if is_n.any():
            # hole runs merge only across *identical* raw characters
            # (bntseq.c:206-221)
            idx = np.flatnonzero(is_n)
            run_start = 0
            for t in range(1, len(idx) + 1):
                if (t == len(idx) or idx[t] != idx[t - 1] + 1
                        or raw[idx[t]] != raw[idx[t - 1]]):
                    start = idx[run_start]
                    ambs.append(AmbHole(offset + int(start),
                                        int(t - run_start),
                                        chr(raw[start])))
                    n_ambs += 1
                    run_start = t
            # fill Ns with lrand48 draws in order
            draws = _lrand48_bulk(rng, int(is_n.sum()))
            codes[is_n] = (draws & 3).astype(np.uint8)
        if rec.comment:
            last_comment = rec.comment
        anns.append(ContigAnn(
            name=rec.name,
            anno=last_comment if last_comment is not None else "(null)",
            offset=offset, length=len(codes), n_ambs=n_ambs))
        offset += len(codes)
        all_codes.append(codes)
    if offset == 0:
        raise ValueError("zero length sequence")
    bns = Bns(l_pac=offset, seed=11, anns=anns, ambs=ambs)
    codes = np.concatenate(all_codes)
    formats.write_pac(prefix + ".pac", codes)
    formats.write_ann(prefix + ".ann", bns)
    formats.write_amb(prefix + ".amb", bns)
    return bns, codes


def fasta_to_bnt_packed(fa_path: str, prefix: str
                        ) -> tuple[Bns, np.ndarray]:
    """fasta_to_bnt for huge genomes: identical .pac/.ann/.amb bytes, but
    the genome is packed contig-by-contig (4-base carry across contig
    boundaries) so the unpacked 1-byte/base stream never materializes.
    Returns (bns, packed pac bytes)."""
    rng = Rand48(11)
    anns: list[ContigAnn] = []
    ambs: list[AmbHole] = []
    out = bytearray()
    carry = np.zeros(0, dtype=np.uint8)
    offset = 0
    last_comment: str | None = None
    for rec in read_fasta(fa_path):
        raw = np.frombuffer(rec.seq.encode("latin-1"), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        is_n = codes >= 4
        n_ambs = 0
        if is_n.any():
            idx = np.flatnonzero(is_n)
            run_start = 0
            for t in range(1, len(idx) + 1):
                if (t == len(idx) or idx[t] != idx[t - 1] + 1
                        or raw[idx[t]] != raw[idx[t - 1]]):
                    start = idx[run_start]
                    ambs.append(AmbHole(offset + int(start),
                                        int(t - run_start),
                                        chr(raw[start])))
                    n_ambs += 1
                    run_start = t
            draws = _lrand48_bulk(rng, int(is_n.sum()))
            codes[is_n] = (draws & 3).astype(np.uint8)
        del raw
        if rec.comment:
            last_comment = rec.comment
        anns.append(ContigAnn(
            name=rec.name,
            anno=last_comment if last_comment is not None else "(null)",
            offset=offset, length=len(codes), n_ambs=n_ambs))
        offset += len(codes)
        stream = np.concatenate([carry, codes]) if len(carry) else codes
        del codes
        n_full = (len(stream) // 4) * 4
        out += _pack_codes(stream[:n_full]).tobytes()
        carry = stream[n_full:].copy()
        del stream
    if offset == 0:
        raise ValueError("zero length sequence")
    if len(carry):
        out += _pack_codes(carry).tobytes()
    bns = Bns(l_pac=offset, seed=11, anns=anns, ambs=ambs)
    pac_bytes = np.frombuffer(bytes(out), dtype=np.uint8)
    del out
    # .pac file = packed bytes + trailing pad marker (write_pac layout)
    with open(prefix + ".pac", "wb") as f:
        f.write(pac_bytes.tobytes())
        if offset % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([offset % 4]))
    formats.write_ann(prefix + ".ann", bns)
    formats.write_amb(prefix + ".amb", bns)
    return bns, pac_bytes


def _write_rpac_packed(path: str, pac_bytes: np.ndarray,
                       l_pac: int, chunk: int = 1 << 26) -> None:
    """.rpac (reversed, not complemented) streamed from the packed pac in
    chunks — byte-identical to formats.write_rpac(codes)."""
    n_bytes = (l_pac >> 2) + 1
    with open(path, "wb") as f:
        written = 0
        pos = l_pac
        carry = np.zeros(0, dtype=np.uint8)
        while pos > 0 or len(carry):
            take = min(chunk, pos)
            lo = pos - take
            # unpack bases [lo, pos) then reverse
            seg = pac_bytes[lo >> 2:(pos + 3) >> 2]
            codes = np.empty(len(seg) * 4, dtype=np.uint8)
            for j in range(4):
                codes[j::4] = (seg >> np.uint8((3 - j) << 1)) & np.uint8(3)
            codes = codes[lo & 3:(lo & 3) + take][::-1]
            stream = (np.concatenate([carry, codes]) if len(carry)
                      else codes)
            pos = lo
            if pos > 0:
                n_full = (len(stream) // 4) * 4
                f.write(_pack_codes(stream[:n_full]).tobytes())
                written += n_full // 4
                carry = stream[n_full:].copy()
            else:
                f.write(_pack_codes(stream).tobytes())
                written += (len(stream) + 3) // 4
                carry = np.zeros(0, dtype=np.uint8)
                break
        if written < n_bytes:
            f.write(bytes(n_bytes - written))
        f.write(bytes([l_pac % 4]))


def _lrand48_bulk(rng: Rand48, n: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    vals, state = native.lrand48_stream(rng.x, n)
    rng.x = state
    return vals


def build_bwt_index(codes: np.ndarray, sa_intv: int = formats.SA_INTERVAL
                    ) -> BwtIndex:
    """Full FM-index (interleaved layout + sampled SA) of a code string."""
    seq_len = len(codes)
    l2 = np.zeros(5, dtype=np.uint64)
    l2[1:] = np.cumsum(np.bincount(codes, minlength=4))
    l2 = l2.astype(np.uint32)
    sampled = None
    if sa_intv and 0 < seq_len < (1 << 31) - 2:  # int32 SA-IS territory
        # one SA-IS pass yields BWT + the sampled .sa directly (the
        # reference walks isa over the whole genome instead, bwt.c:58-67)
        bwt_codes, primary, sampled = native.bwt_with_sa(codes, sa_intv)
    else:
        bwt_codes, primary = native.bwt_inplace(codes)
    # pack BWT codes into words, code i at bits (15-(i&15))*2 of word i>>4
    n_words = (seq_len + 15) >> 4
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:seq_len] = bwt_codes
    grouped = padded.reshape(-1, 16)
    words = np.zeros(n_words, dtype=np.uint32)
    for j in range(16):
        words |= grouped[:, j] << np.uint32((15 - j) * 2)
    interleaved = formats.interleave_occ(words, seq_len)
    idx = BwtIndex(primary=primary, L2=l2, seq_len=seq_len,
                   interleaved=interleaved)
    if sa_intv:
        idx.sa_intv = sa_intv
        idx.sa = (sampled if sampled is not None else
                  native.cal_sa(interleaved, primary, l2, seq_len, sa_intv))
    return idx


def _pack_codes(codes: np.ndarray) -> np.ndarray:
    """2-bit pack (the .pac byte layout, base i at bits (~i&3)<<1)."""
    n = len(codes)
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = codes
    g = padded.reshape(-1, 4)
    return ((g[:, 0] << 6) | (g[:, 1] << 4) | (g[:, 2] << 2)
            | g[:, 3]).astype(np.uint8)


def build_bwt_index_packed(pac_bytes: np.ndarray, seq_len: int,
                           l2: np.ndarray, reverse: bool,
                           sa_intv: int = formats.SA_INTERVAL) -> BwtIndex:
    """Bounded-memory FM-index build from a PACKED text (the >2 Gbp
    path; see native.bwt_packed).  reverse=True indexes the reversed
    text without materializing it (.rbwt/.rsa)."""
    sampled = None
    if sa_intv:
        bwt_pac, primary, sampled = native.bwt_packed(
            pac_bytes, seq_len, reverse, sa_intv=sa_intv)
    else:
        bwt_pac, primary = native.bwt_packed(pac_bytes, seq_len, reverse)
    # words straight from packed bytes: 4 pac bytes big-endian == one
    # u32 word in the reference layout (code i at bits (15-(i&15))*2)
    nb = len(bwt_pac)
    padded = np.zeros(((nb + 3) // 4) * 4, dtype=np.uint8)
    padded[:nb] = bwt_pac
    del bwt_pac
    # 4 pac bytes big-endian == one u32 word: a view + one byteswap copy
    words = padded.view(">u4").astype(np.uint32)
    del padded
    n_words = (seq_len + 15) >> 4
    words = np.ascontiguousarray(words[:n_words])
    interleaved = formats.interleave_occ(words, seq_len)
    del words
    idx = BwtIndex(primary=primary, L2=l2, seq_len=seq_len,
                   interleaved=interleaved)
    if sa_intv:
        idx.sa_intv = sa_intv
        idx.sa = sampled
    return idx


NST_COLOR_SPACE_TABLE = [4, 0, 0, 1, 0, 2, 3, 4, 0, 3, 2, 4, 1, 4, 4, 4]


def pac2cspac(nt_prefix: str, cs_prefix: str) -> None:
    """`ibwa pac2cspac` (bwtmisc.c:202-246): nucleotide pac -> color pac
    (color of each adjacent base pair; slot 0 keeps the first base)."""
    codes = formats.read_pac(nt_prefix + ".pac")
    cs = np.empty_like(codes)
    cs[0] = codes[0]
    tbl = np.array(NST_COLOR_SPACE_TABLE, dtype=np.uint8)
    if len(codes) > 1:
        cs[1:] = tbl[(1 << codes[:-1].astype(np.int32))
                     | (1 << codes[1:].astype(np.int32))]
    bns = formats.read_ann(nt_prefix + ".ann")
    formats.read_amb(nt_prefix + ".amb", bns)
    formats.write_ann(cs_prefix + ".ann", bns)
    formats.write_amb(cs_prefix + ".amb", bns)
    formats.write_pac(cs_prefix + ".pac", cs)


def bwa_index(fa_path: str, prefix: str | None = None,
              color: bool = False) -> None:
    """Equivalent of `ibwa index [-c] -a is <fa>`.

    Color mode (bwtindex.c:85-101): nucleotide artifacts land under
    <prefix>.nt.*, the searched index is built over the color-space pac."""
    if prefix is None:
        prefix = fa_path

    # >2 Gbp path (the reference's `index -a bwtsw` territory,
    # bwtindex.c:110-137): everything stays 2-bit packed — streaming
    # FASTA packing, chunked .rpac, and the bounded-memory packed-text
    # SA-IS — so peak memory is the u32 suffix array (~4.4 bytes/base).
    # IBWA_FRUGAL_MIN overrides the byte threshold (used by tests).
    frugal_min = int(os.environ.get("IBWA_FRUGAL_MIN", (1 << 31) - 2))
    if not color and os.path.getsize(fa_path) >= frugal_min:
        bns, pac_bytes = fasta_to_bnt_packed(fa_path, prefix)
        seq_len = bns.l_pac
        _write_rpac_packed(prefix + ".rpac", pac_bytes, seq_len)
        # L2 from per-byte code counts, chunked
        counts = np.zeros(4, dtype=np.int64)
        n_pac = (seq_len + 3) // 4
        for lo in range(0, n_pac, 1 << 26):
            seg = pac_bytes[lo:min(lo + (1 << 26), n_pac)]
            for j in range(4):
                counts += np.bincount((seg >> np.uint8((3 - j) << 1))
                                      & np.uint8(3), minlength=4)
        counts[0] -= (-seq_len) % 4  # padding bases in the last byte
        l2 = np.zeros(5, dtype=np.uint64)
        l2[1:] = np.cumsum(counts)
        l2 = l2.astype(np.uint32)
        for reverse, bwt_name, sa_name in ((False, ".bwt", ".sa"),
                                           (True, ".rbwt", ".rsa")):
            idx = build_bwt_index_packed(pac_bytes, seq_len, l2, reverse)
            formats.write_bwt(prefix + bwt_name, idx)
            formats.write_sa(prefix + sa_name, idx)
            del idx
        return

    if color:
        fasta_to_bnt(fa_path, prefix + ".nt")
        pac2cspac(prefix + ".nt", prefix)
        codes = formats.read_pac(prefix + ".pac")
    else:
        bns, codes = fasta_to_bnt(fa_path, prefix)
    formats.write_rpac(prefix + ".rpac", codes)

    fwd = build_bwt_index(codes)
    formats.write_bwt(prefix + ".bwt", fwd)
    formats.write_sa(prefix + ".sa", fwd)

    rev = build_bwt_index(codes[::-1].copy())
    formats.write_bwt(prefix + ".rbwt", rev)
    formats.write_sa(prefix + ".rsa", rev)


def fa2pac(fa_path: str, prefix: str | None = None) -> None:
    """`ibwa fa2pac` (bntseq.c:256-263): FASTA -> .pac/.ann/.amb only."""
    fasta_to_bnt(fa_path, prefix or fa_path)


def pac2bwt(pac_path: str, bwt_path: str) -> None:
    """`ibwa pac2bwt` / `pac2bwtgen` (bwtmisc.c:56-121): .pac -> raw .bwt
    (no occ interleaving yet).  The BWT of a text is unique, so the SA-IS
    construction and the reference's BWT-SW incremental builder produce
    byte-identical output."""
    codes = formats.read_pac(pac_path)
    idx = build_bwt_index(codes, sa_intv=0)
    # de-interleave: write primary, L2[1..4], plain bwt words
    seq_len = idx.seq_len
    n_words = (seq_len + 15) >> 4
    words = np.zeros(n_words, dtype=np.uint32)
    # reconstruct plain words from the interleaved layout
    flat = idx.interleaved
    widx = 0
    pos = 0
    n_blocks = (seq_len + 127) // 128
    for blk in range(n_blocks):
        pos += 4
        take = min(8, n_words - widx)
        words[widx:widx + take] = flat[pos:pos + take]
        pos += take
        widx += take
    import struct

    with open(bwt_path, "wb") as f:
        f.write(struct.pack("<I", idx.primary))
        f.write(np.asarray(idx.L2[1:5], dtype="<u4").tobytes())
        f.write(words.astype("<u4").tobytes())


def bwtupdate(bwt_path: str) -> None:
    """`ibwa bwtupdate` (bwtmisc.c:122-158): interleave occ checkpoints
    into a raw .bwt in place."""
    import struct

    with open(bwt_path, "rb") as f:
        data = f.read()
    primary = struct.unpack_from("<I", data, 0)[0]
    l2 = np.zeros(5, dtype=np.uint32)
    l2[1:] = np.frombuffer(data, dtype="<u4", count=4, offset=4)
    words = np.frombuffer(data, dtype="<u4", offset=20).copy()
    seq_len = int(l2[4])
    interleaved = formats.interleave_occ(words[: (seq_len + 15) >> 4],
                                         seq_len)
    idx = BwtIndex(primary=primary, L2=l2, seq_len=seq_len,
                   interleaved=interleaved)
    formats.write_bwt(bwt_path, idx)


def pac_rev(pac_path: str, rpac_path: str) -> None:
    """`ibwa pac_rev` (bwtmisc.c:160-201): .pac -> reversed .rpac."""
    codes = formats.read_pac(pac_path)
    formats.write_rpac(rpac_path, codes)


def bwt2sa(bwt_path: str, sa_path: str, intv: int = 32) -> None:
    """`ibwa bwt2sa` (bwtmisc.c:248-267): sampled SA from a .bwt."""
    idx = formats.read_bwt(bwt_path)
    idx.sa_intv = intv
    idx.sa = native.cal_sa(idx.interleaved, idx.primary,
                           idx.L2.astype(np.uint32), idx.seq_len, intv)
    formats.write_sa(sa_path, idx)


def load_index(prefix: str, strand: int) -> BwtIndex:
    """Load .bwt/.sa (strand 0) or .rbwt/.rsa (strand 1)."""
    suffix = (".bwt", ".sa") if strand == 0 else (".rbwt", ".rsa")
    idx = formats.read_bwt(prefix + suffix[0])
    sa_path = prefix + suffix[1]
    if os.path.exists(sa_path):
        formats.read_sa(sa_path, idx)
    return idx
