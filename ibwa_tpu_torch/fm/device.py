"""Device-resident FM-index block table + the paired occ queries (K2).

Port of `ibwa_tpu/fm/device.py` (table layout, `_gather_block`,
`occ4`, `occ1`) without the dimer table and the sharded-index mode.  The
block table packs, per `intv`-base block, 4 occ checkpoint words + the
intv/16 2-bit text words into one row (the reference's interleaved
layout, bwt.h:56-63), fwd strand rows first, so an occ query is one row
gather + a masked popcount.

`blocks` is an int32 tensor holding the u32 bit patterns; every other
u32 value (bounds, counts, `L2`) is an int64 tensor (see `u32.py`).

`occ4_pair` / `occ1_pair` answer the (k-1, l) pair of one SA interval
— the only shape the search asks for.  A CPU tensor goes to the plain
twin (`occ4_plain` / `occ1_plain`), a CUDA tensor to the kernel in
`csrc/occ.cu`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import kernels
from ..u32 import MASK, NEG1, partial_mask, popcount
from .fmindex import FmIndex

OCC_INTV = 128


@dataclasses.dataclass
class DeviceFmPair:
    """Both strands' FM-indexes as tensors on one device (fwd = strand 0)."""

    blocks: torch.Tensor   # int32[2*n_blk, 4 + intv/16], u32 bit patterns
    L2: torch.Tensor       # int64[5] (identical for both strands)
    l2diff: torch.Tensor   # int64[4] = L2[1:5] - L2[0:4]
    primary: torch.Tensor  # int64[2]
    seq_len: int
    n_blk: int             # rows per strand
    intv: int              # bases per row: 32, 64 or 128

    @property
    def wpb(self) -> int:
        """Text words per row (intv bases / 16 per u32)."""
        return self.intv >> 4

    @property
    def device(self) -> torch.device:
        return self.blocks.device


def _popcount_bases(words: np.ndarray) -> np.ndarray:
    """Per-row counts of each base code in a [n, k]-word 2-bit stream
    (uint32[n, 4]).  Zero padding counts as base 0."""
    out = np.zeros((words.shape[0], 4), dtype=np.uint32)
    for c in range(4):
        x = words ^ np.uint32(0x55555555 * c)
        t = (~x) & ((~x) >> np.uint32(1)) & np.uint32(0x55555555)
        bits = np.unpackbits(t.view(np.uint8), axis=-1)
        out[:, c] = bits.reshape(words.shape[0], -1).sum(axis=1)
    return out


def _rechunk_blocks(ckpt: np.ndarray, words: np.ndarray, seq_len: int,
                    intv: int) -> np.ndarray:
    """Re-checkpoint one strand's 128-base layout at `intv`-base rows:
    uint32[ceil(seq_len/intv), 4 + intv/16].  Sub-block i's checkpoint is
    the 128-block checkpoint + the counts of the preceding i*intv bases."""
    sub = OCC_INTV // intv
    w = intv >> 4
    n128 = (seq_len + OCC_INTV - 1) // OCC_INTV
    n_intv = (seq_len + intv - 1) // intv
    rows = np.zeros((sub * n128, 4 + w), dtype=np.uint32)
    acc = ckpt[:n128].copy()
    for i in range(sub):
        rows[i::sub, :4] = acc
        rows[i::sub, 4:] = words[:, w * i:w * (i + 1)]
        if i + 1 < sub:
            acc = acc + _popcount_bases(words[:, w * i:w * (i + 1)])
    return np.ascontiguousarray(rows[:n_intv])


def build_blocks(fwd: FmIndex, rev: FmIndex, intv: int
                 ) -> tuple[np.ndarray, int]:
    """The two strands' row table, uint32[2*n_blk, 4 + intv/16], and
    n_blk — byte-equal to `ibwa_tpu.fm.device.build_device_pair`'s."""
    if intv not in (32, 64, 128):
        raise ValueError(f"occ block interval must be 32, 64 or 128: {intv}")
    if fwd.seq_len != rev.seq_len:
        raise ValueError("strand lengths differ")
    if intv == OCC_INTV:
        n_blk = (fwd.seq_len + OCC_INTV - 1) // OCC_INTV
        blocks = np.empty((2 * n_blk, 12), dtype=np.uint32)
        blocks[:n_blk, :4] = fwd.ckpt[:n_blk]
        blocks[:n_blk, 4:] = fwd.words
        blocks[n_blk:, :4] = rev.ckpt[:n_blk]
        blocks[n_blk:, 4:] = rev.words
        return blocks, n_blk
    n_blk = (fwd.seq_len + intv - 1) // intv
    blocks = np.concatenate(
        [_rechunk_blocks(fwd.ckpt, fwd.words, fwd.seq_len, intv),
         _rechunk_blocks(rev.ckpt, rev.words, rev.seq_len, intv)], axis=0)
    return blocks, n_blk


def build_device_pair(fwd: FmIndex, rev: FmIndex, device,
                      intv: int | None = None) -> DeviceFmPair:
    """Block table + constants on `device`.  intv defaults to
    IBWA_DEV_INTV (64: 32 B rows), as in `ibwa_tpu`."""
    if intv is None:
        intv = int(os.environ.get("IBWA_DEV_INTV", "64"))
    blocks, n_blk = build_blocks(fwd, rev, intv)
    l2 = fwd.L2.astype(np.int64)
    return DeviceFmPair(
        blocks=torch.from_numpy(blocks.view(np.int32)).to(device),
        L2=torch.from_numpy(l2).to(device),
        l2diff=torch.from_numpy(l2[1:5] - l2[0:4]).to(device),
        primary=torch.tensor([fwd.primary, rev.primary], dtype=torch.int64,
                             device=device),
        seq_len=int(fwd.seq_len), n_blk=int(n_blk), intv=int(intv))


# ---- plain twins (ports of ibwa_tpu/fm/device.py:286-364, :430-461) ----

def _gather_block(fm: DeviceFmPair, strand: torch.Tensor, kk: torch.Tensor):
    """Row gather for sentinel-adjusted, clamped queries: returns
    (ck[..., 4], w[..., wpb], nw, nb) as int64 u32 values."""
    shift = fm.intv.bit_length() - 1
    blk = torch.clamp(kk >> shift, max=fm.n_blk - 1)
    off = kk & (fm.intv - 1)
    row = fm.blocks[strand * fm.n_blk + blk].to(torch.int64) & MASK
    return row[..., :4], row[..., 4:], off >> 4, (off & 15) + 1


def _adjust(fm: DeviceFmPair, strand: torch.Tensor, k: torch.Tensor):
    """k -> (k - (k >= primary), clamped to seq_len - 1), in u32."""
    kk = (k - (k >= fm.primary[strand]).to(torch.int64)) & MASK
    return torch.clamp(kk, max=max(fm.seq_len - 1, 0))


def occ4_plain(fm: DeviceFmPair, strand: torch.Tensor, k: torch.Tensor
               ) -> torch.Tensor:
    """Batched bwt_occ4 (bwt.c:139-175): counts of each base in B0[0..k].

    strand, k: int64[...] (k a u32 value); returns int64[..., 4].
    k == NEG1 -> 0; k == seq_len -> L2[c+1] - L2[c]."""
    ck, w, nw, nb = _gather_block(fm, strand, _adjust(fm, strand, k))
    pats = 0x55555555 * torch.arange(4, dtype=torch.int64, device=k.device)
    x = (~(w[..., None, :] ^ pats[:, None])) & MASK      # [..., 4, wpb]
    t = x & (x >> 1) & 0x55555555
    widx = torch.arange(fm.wpb, device=k.device)
    full = widx < nw[..., None, None]
    part = widx == nw[..., None, None]
    pm = partial_mask(nb)[..., None, None]
    sel = torch.where(full, t, 0) | torch.where(part, t & pm, 0)
    cnt = ck + popcount(sel).sum(-1)
    cnt = torch.where((k == NEG1)[..., None], 0, cnt)
    return torch.where((k == fm.seq_len)[..., None], fm.l2diff, cnt)


def occ1_plain(fm: DeviceFmPair, strand: torch.Tensor, k: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Batched bwt_occ (bwt.c:90-113) for one base code c (0..3) per
    query; the same conventions as occ4_plain."""
    ck, w, nw, nb = _gather_block(fm, strand, _adjust(fm, strand, k))
    x = (~(w ^ (0x55555555 * c)[..., None])) & MASK
    t = x & (x >> 1) & 0x55555555
    widx = torch.arange(fm.wpb, device=k.device)
    full = widx < nw[..., None]
    part = widx == nw[..., None]
    pm = partial_mask(nb)[..., None]
    sel = torch.where(full, t, 0) | torch.where(part, t & pm, 0)
    cnt = torch.gather(ck, -1, c[..., None])[..., 0] + popcount(sel).sum(-1)
    cnt = torch.where(k == NEG1, 0, cnt)
    return torch.where(k == fm.seq_len, fm.l2diff[c], cnt)


def occ4_pair_plain(fm: DeviceFmPair, strand, k, l) -> torch.Tensor:
    """Plain twin of occ4_pair: occ4_plain at (k - 1, l)."""
    kl = torch.stack([(k - 1) & MASK, l], dim=-1)
    return occ4_plain(fm, strand[:, None], kl)


def occ1_pair_plain(fm: DeviceFmPair, strand, k, l, c) -> torch.Tensor:
    """Plain twin of occ1_pair: occ1_plain at (k - 1, l)."""
    kl = torch.stack([(k - 1) & MASK, l], dim=-1)
    return occ1_plain(fm, strand[:, None].expand_as(kl), kl,
                      c[:, None].expand_as(kl))


# ---- K2 wrappers ----------------------------------------------------------

def _check_pair_args(fm: DeviceFmPair, *qs: torch.Tensor) -> int:
    m = qs[0].shape[0]
    for q in qs:
        if q.device != fm.device:
            raise ValueError(f"query on {q.device}, index on {fm.device}")
        if q.dtype != torch.int64 or q.dim() != 1 or q.shape[0] != m:
            raise ValueError("occ pair queries must be int64[m] tensors")
    return m


def occ4_pair(fm: DeviceFmPair, strand: torch.Tensor, k: torch.Tensor,
              l: torch.Tensor) -> torch.Tensor:
    """occ4 at (k - 1, l) of each interval: int64[m, 2, 4].

    strand, k, l: int64[m] (k, l u32 values; k == 0 asks NEG1)."""
    m = _check_pair_args(fm, strand, k, l)
    if fm.device.type == "cpu":
        return occ4_pair_plain(fm, strand, k, l)
    if fm.device.type != "cuda":
        raise ValueError(f"unsupported device {fm.device}")
    _check_cuda_table(fm)
    strand, k, l = (q.contiguous() for q in (strand, k, l))
    out = torch.empty((m, 2, 4), dtype=torch.int64, device=fm.device)
    rc = kernels.lib().ibwa_occ4_pair(
        fm.blocks.data_ptr(), fm.primary.data_ptr(), fm.l2diff.data_ptr(),
        strand.data_ptr(), k.data_ptr(), l.data_ptr(), out.data_ptr(), m,
        fm.seq_len, fm.n_blk, fm.intv,
        torch.cuda.current_stream(fm.device).cuda_stream)
    kernels.check(rc, "occ4_pair")
    kernels.launches["occ4_pair"] += 1
    return out


def occ1_pair(fm: DeviceFmPair, strand: torch.Tensor, k: torch.Tensor,
              l: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """occ of base c (0..3) at (k - 1, l) of each interval: int64[m, 2]."""
    m = _check_pair_args(fm, strand, k, l, c)
    if fm.device.type == "cpu":
        return occ1_pair_plain(fm, strand, k, l, c)
    if fm.device.type != "cuda":
        raise ValueError(f"unsupported device {fm.device}")
    _check_cuda_table(fm)
    strand, k, l, c = (q.contiguous() for q in (strand, k, l, c))
    out = torch.empty((m, 2), dtype=torch.int64, device=fm.device)
    rc = kernels.lib().ibwa_occ1_pair(
        fm.blocks.data_ptr(), fm.primary.data_ptr(), fm.l2diff.data_ptr(),
        strand.data_ptr(), k.data_ptr(), l.data_ptr(), c.data_ptr(),
        out.data_ptr(), m, fm.seq_len, fm.n_blk, fm.intv,
        torch.cuda.current_stream(fm.device).cuda_stream)
    kernels.check(rc, "occ1_pair")
    kernels.launches["occ1_pair"] += 1
    return out


def _check_cuda_table(fm: DeviceFmPair) -> None:
    b = fm.blocks
    if (b.dtype != torch.int32 or not b.is_contiguous()
            or b.shape != (2 * fm.n_blk, 4 + fm.wpb)
            or b.data_ptr() % 16):
        raise ValueError("block table must be a contiguous, 16-byte aligned "
                         "int32[2*n_blk, 4 + intv/16] tensor")
    for t in (fm.primary, fm.l2diff):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError("primary/l2diff must be contiguous int64")
