""".sai binary stream: the aln -> samse/sampe artifact contract.

Layout (bwtaln.c:192,227-231; read back bwase.c:660-682):
  gap_opt_t header (64 bytes), then per read:
    int32 n_aln
    n_aln x bwt_aln1_t (u32 bitfield n_mm|n_gapo<<8|n_gape<<16|a<<24,
                        u32 k, u32 l, i32 score) — 16 bytes each

Copy of `ibwa_tpu/io/sai.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

import numpy as np

from ..align.engine_ref import Hit
from ..align.opts import GapOpt


def write_header(f: BinaryIO, opt: GapOpt) -> None:
    f.write(opt.pack())


def write_read_hits(f: BinaryIO, hits: list[Hit]) -> None:
    f.write(struct.pack("<i", len(hits)))
    if hits:
        arr = np.empty((len(hits), 4), dtype=np.uint32)
        for j, h in enumerate(hits):
            arr[j, 0] = (h.n_mm & 0xFF) | ((h.n_gapo & 0xFF) << 8) \
                | ((h.n_gape & 0xFF) << 16) | ((h.a & 1) << 24)
            arr[j, 1] = h.k
            arr[j, 2] = h.l
            arr[j, 3] = h.score & 0xFFFFFFFF
        f.write(arr.astype("<u4").tobytes())


def read_header(f: BinaryIO) -> GapOpt:
    return GapOpt.unpack(f.read(64))


def read_read_hits(f: BinaryIO) -> list[Hit] | None:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (n_aln,) = struct.unpack("<i", raw)
    hits = []
    if n_aln:
        arr = np.frombuffer(f.read(16 * n_aln), dtype="<u4").reshape(-1, 4)
        for row in arr:
            meta = int(row[0])
            hits.append(Hit(n_mm=meta & 0xFF, n_gapo=(meta >> 8) & 0xFF,
                            n_gape=(meta >> 16) & 0xFF, a=(meta >> 24) & 1,
                            k=int(row[1]), l=int(row[2]),
                            score=int(np.int32(row[3]))))
    return hits


def iter_sai(path: str) -> Iterator[list[Hit]]:
    with open(path, "rb") as f:
        read_header(f)
        while True:
            hits = read_read_hits(f)
            if hits is None:
                return
            yield hits
