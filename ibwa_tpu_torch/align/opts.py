"""Alignment options (the reference's gap_opt_t, bwtaln.h:105-115) and the
64-byte .sai header serialization contract (bwtaln.c:192).

Copy of `ibwa_tpu/align/opts.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import dataclasses
import math
import struct

BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_NONSTOP = 0x10
BWA_MODE_BAM = 0x20
BWA_MODE_BAM_SE = 0x40
BWA_MODE_BAM_READ1 = 0x80
BWA_MODE_BAM_READ2 = 0x100
BWA_MODE_IL13 = 0x200

BWA_AVG_ERR = 0.02
BWA_MIN_RDLEN = 35

_STRUCT = struct.Struct("<7if8i")  # 16 four-byte fields, no padding


@dataclasses.dataclass
class GapOpt:
    """Defaults from gap_init_opt (bwtaln.c:21-37)."""

    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    mode: int = BWA_MODE_GAPE | BWA_MODE_COMPREAD
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    fnr: float = 0.04
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    max_seed_diff: int = 2
    seed_len: int = 32
    n_threads: int = 1
    max_top2: int = 30
    trim_qual: int = 0

    def pack(self) -> bytes:
        return _STRUCT.pack(self.s_mm, self.s_gapo, self.s_gape, self.mode,
                            self.indel_end_skip, self.max_del_occ,
                            self.max_entries, self.fnr, self.max_diff,
                            self.max_gapo, self.max_gape, self.max_seed_diff,
                            self.seed_len, self.n_threads, self.max_top2,
                            self.trim_qual)

    @classmethod
    def unpack(cls, data: bytes) -> "GapOpt":
        v = _STRUCT.unpack(data[:64])
        return cls(s_mm=v[0], s_gapo=v[1], s_gape=v[2], mode=v[3],
                   indel_end_skip=v[4], max_del_occ=v[5], max_entries=v[6],
                   fnr=v[7], max_diff=v[8], max_gapo=v[9], max_gape=v[10],
                   max_seed_diff=v[11], seed_len=v[12], n_threads=v[13],
                   max_top2=v[14], trim_qual=v[15])


def cal_maxdiff(length: int, err: float = BWA_AVG_ERR,
                thres: float = 0.04) -> int:
    """Poisson tail bound on allowed differences (bwtaln.c:39-51)."""
    elambda = math.exp(-length * err)
    y = 1.0
    x = 1
    total = elambda
    for k in range(1, 1000):
        y *= length * err
        x *= k
        total += elambda * y / x
        if 1.0 - total < thres:
            return k
    return 2


def aln_score(n_mm: int, n_gapo: int, n_gape: int, opt: GapOpt) -> int:
    return n_mm * opt.s_mm + n_gapo * opt.s_gapo + n_gape * opt.s_gape
