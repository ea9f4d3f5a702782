"""Batched SA-resolution LF walks on the device (K5).

Port of `ibwa_tpu/fm/walk.py`.  The SAM stages resolve SA rows to text
coordinates by walking LF until a sampled row: `while k % sa_intv: ++add;
k = LF(k)` (reference bwt_sa, bwt.c:61-79), then `add +
sampled_sa[k / sa_intv]`.  The walks of a batch are independent pointer
chases, one lane each.

One walk step per lane is one row of the device block table (`device.py`:
intv 64 and 32-byte rows by default, 32 and 128 as options): the row
yields both the BWT code at the row and its inclusive occ count.

`DeviceWalker.resolve_intervals` takes a batch's SA intervals and returns
one u32 SA value per row.  On a CUDA table that is `lf_resolve`, one
persistent launch of `csrc/lf_walk.cu` per wave of at most `WAVE_ROWS`
rows: it builds the rows from the intervals, walks them and looks the
sampled arrays (resident on the card with the table) up; one u32 a row
comes back into pinned memory.  On a CPU table it is the plain version,
`resolve_intervals_plain` (rows expanded with torch ops, `lf_walk_plain`,
the lookup by indexing); any other device raises.

`lf_step_plain` / `lf_walk_plain` are the plain walk (ports of
`_lf_step` / `_lf_walk`); `lf_walk` is K5's first version (one thread a
row, (add, kfin) out), which no path runs any more: it stays so that the
two versions can be timed side by side.  u32 values are int64 tensors, as
everywhere in the port (`u32.py`); the intervals, the sampled arrays and
the values are int32 tensors of u32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..u32 import MASK, from_bits, partial_mask, popcount, to_bits
from .device import (DeviceFmPair, _check_cuda_table, _gather_block,
                     build_device_pair)
from .fmindex import FmIndex


def lf_step_plain(fm: DeviceFmPair, strand: torch.Tensor, k: torch.Tensor
                  ) -> torch.Tensor:
    """One LF step per lane: k -> L2[c] + occ_incl(c, k) with c the code
    at row k; k == primary -> 0 (bwt_invPsi).

    strand, k: int64[N] (k a u32 value).  The sentinel skip is
    `k > primary` here, not the occ queries' `k >= primary`."""
    prim = fm.primary[strand]
    ka = k - (k > prim).to(torch.int64)
    ka = torch.clamp(ka, max=max(fm.seq_len - 1, 0))
    ck, w, nw, nb = _gather_block(fm, strand, ka)

    # code at the row: word nw, the 2-bit field of the in-word offset
    off = ka & (fm.intv - 1)
    word = torch.gather(w, -1, nw[..., None])[..., 0]
    c = (word >> (((~off) & 0xF) << 1)) & 3

    # inclusive occ of c up to ka (the popcount scheme of occ1_plain)
    x = (~(w ^ (0x55555555 * c)[..., None])) & MASK
    t = x & (x >> 1) & 0x55555555
    widx = torch.arange(fm.wpb, device=k.device)
    full = widx < nw[..., None]
    part = widx == nw[..., None]
    pm = partial_mask(nb)[..., None]
    sel = torch.where(full, t, 0) | torch.where(part, t & pm, 0)
    cnt = torch.gather(ck, -1, c[..., None])[..., 0] + popcount(sel).sum(-1)
    return torch.where(k == prim, 0, (fm.L2[c] + cnt) & MASK)


def lf_walk_plain(fm: DeviceFmPair, strand: torch.Tensor, k0: torch.Tensor,
                  intv_mask: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Walk each lane to its nearest sampled row (k & intv_mask == 0).

    Returns (add int64[N] = steps taken, kfin int64[N] = sampled row)."""
    k = k0.clone()
    add = torch.zeros_like(k)
    active = (k & intv_mask) != 0
    while bool(active.any()):
        k = torch.where(active, lf_step_plain(fm, strand, k), k)
        add = add + active.to(torch.int64)
        active = active & ((k & intv_mask) != 0)
    return add, k


def lf_walk(fm: DeviceFmPair, strand: torch.Tensor, k0: torch.Tensor,
            intv_mask: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's first version: `lf_walk_plain` for a table on the CPU, one
    thread a row on a CUDA device.  strand, k0: int64[N] on the table's
    device.  No path runs it; `chip_smoke.py` times it beside
    `lf_resolve`."""
    for q in (strand, k0):
        if q.device != fm.device:
            raise ValueError(f"query on {q.device}, index on {fm.device}")
        if q.dtype != torch.int64 or q.dim() != 1 or q.shape != k0.shape:
            raise ValueError("lf_walk queries must be int64[N] tensors")
    _check_mask(intv_mask)
    if fm.device.type == "cpu":
        return lf_walk_plain(fm, strand, k0, intv_mask)
    if fm.device.type != "cuda":
        raise ValueError(f"unsupported device {fm.device}")
    _check_cuda_table(fm)
    if fm.L2.dtype != torch.int64 or not fm.L2.is_contiguous():
        raise ValueError("L2 must be contiguous int64")
    strand, k0 = strand.contiguous(), k0.contiguous()
    add = torch.empty_like(k0)
    kfin = torch.empty_like(k0)
    rc = kernels.lib().ibwa_lf_walk(
        fm.blocks.data_ptr(), fm.primary.data_ptr(), fm.L2.data_ptr(),
        strand.data_ptr(), k0.data_ptr(), add.data_ptr(), kfin.data_ptr(),
        k0.shape[0], fm.seq_len, fm.n_blk, fm.intv, intv_mask,
        torch.cuda.current_stream(fm.device).cuda_stream)
    kernels.check(rc, "lf_walk")
    if k0.shape[0]:
        kernels.launches["lf_walk_rows"] += 1
    return add, kfin


def _check_mask(intv_mask: int) -> None:
    if intv_mask < 0 or (intv_mask & (intv_mask + 1)):
        raise ValueError(f"intv_mask must be 2**s - 1: {intv_mask}")


def resolve_intervals_plain(fm: DeviceFmPair, sampled: torch.Tensor,
                            iv: torch.Tensor, off: torch.Tensor,
                            row_begin: int, row_end: int, intv_mask: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SA values of rows [row_begin, row_end) of the intervals' row
    space: each row's interval by a search of `off`, its row, the walk
    (`lf_walk_plain`), then add + sampled[strand][kfin >> log2(sa_intv)]
    (u32 wrap).

    sampled: int32[2, n_samp]; iv: int32[2, n_iv] (device strand, first
    row); off: int64[n_iv + 1], the exclusive prefix of the widths.
    Returns (int32[row_end - row_begin] values, int64[3] (rows, LF steps,
    longest walk))."""
    dev = fm.device
    rows = torch.arange(row_begin, row_end, dtype=torch.int64, device=dev)
    own = torch.searchsorted(off, rows, right=True) - 1
    strand = from_bits(iv[0])[own]
    add, kfin = lf_walk_plain(fm, strand, from_bits(iv[1])[own] + rows
                              - off[own], intv_mask)
    slot = torch.clamp(kfin >> (intv_mask.bit_length()),
                       max=sampled.shape[1] - 1)
    vals = (add + from_bits(sampled[strand, slot])) & MASK
    stats = torch.tensor([len(rows), int(add.sum()),
                          int(add.max()) if len(rows) else 0])
    return to_bits(vals), stats


def _launch_resolve(fm: DeviceFmPair, sampled: torch.Tensor,
                    iv: torch.Tensor, off: torch.Tensor, row_begin: int,
                    row_end: int, intv_mask: int, stream: int,
                    max_blocks: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of `csrc/lf_walk.cu`'s persistent kernel on the rows
    [row_begin, row_end), as `resolve_intervals_plain` returns them but
    with stats[0] the work queue's final count (>= the rows).  No checks:
    `lf_resolve` makes them."""
    out = torch.empty(row_end - row_begin, dtype=torch.int32,
                      device=iv.device)
    stats = torch.zeros(3, dtype=torch.int64, device=iv.device)
    rc = kernels.lib().ibwa_lf_resolve(
        fm.blocks.data_ptr(), fm.primary.data_ptr(), fm.L2.data_ptr(),
        sampled.data_ptr(), sampled.shape[1], iv[0].data_ptr(),
        iv[1].data_ptr(), off.data_ptr(), iv.shape[1], row_begin, row_end,
        out.data_ptr(), stats.data_ptr(), fm.seq_len, fm.n_blk, fm.intv,
        intv_mask, max_blocks, stream)
    kernels.check(rc, "lf_resolve")
    if row_end > row_begin:
        kernels.launches["lf_walk"] += 1
    return out, stats


def lf_resolve(fm: DeviceFmPair, sampled: torch.Tensor, iv: torch.Tensor,
               off: torch.Tensor, row_begin: int, row_end: int,
               intv_mask: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`resolve_intervals_plain` for a table on the CPU, one launch of the
    kernel for one on a CUDA device (stats[0] is then the queue's count)."""
    for t, dt, shape in ((sampled, torch.int32, (2, sampled.shape[-1])),
                         (iv, torch.int32, (2, iv.shape[-1])),
                         (off, torch.int64, (iv.shape[-1] + 1,))):
        if t.device != fm.device:
            raise ValueError(f"walk input on {t.device}, index on "
                             f"{fm.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"lf_resolve wants contiguous {dt}{list(shape)}")
    _check_mask(intv_mask)
    if not 0 <= row_begin <= row_end < row_begin + (1 << 31):
        raise ValueError(f"bad wave [{row_begin}, {row_end})")
    if fm.device.type == "cpu":
        return resolve_intervals_plain(fm, sampled, iv, off, row_begin,
                                       row_end, intv_mask)
    if fm.device.type != "cuda":
        raise ValueError(f"unsupported device {fm.device}")
    _check_cuda_table(fm)
    if fm.L2.dtype != torch.int64 or not fm.L2.is_contiguous():
        raise ValueError("L2 must be contiguous int64")
    return _launch_resolve(fm, sampled, iv, off, row_begin, row_end,
                           intv_mask,
                           torch.cuda.current_stream(fm.device).cuda_stream)


WAVE_ROWS = 16 << 20  # rows a launch: 64 MB of values on the card


class DeviceWalker:
    """Device-resident LF walker for one (fwd, rev) index pair: the block
    table and both sampled arrays live on its device.

    Strand convention matches fm.device: 0 = forward index, 1 = reverse.
    `last` holds what the last `resolve_intervals` did: rows, waves,
    launches (kernel launches; 0 on the CPU), LF steps, longest walk.
    """

    def __init__(self, fwd: FmIndex, rev: FmIndex, device):
        if int(fwd.sa_intv) != int(rev.sa_intv):
            raise ValueError("strands differ in sa_intv")
        self._init(build_device_pair(fwd, rev, device), (fwd.sa, rev.sa),
                   int(fwd.sa_intv))

    @classmethod
    def from_table(cls, fm: DeviceFmPair, sampled, sa_intv: int
                   ) -> "DeviceWalker":
        """A walker over a block table that is already on its device."""
        self = cls.__new__(cls)
        self._init(fm, sampled, int(sa_intv))
        return self

    def _init(self, fm: DeviceFmPair, sampled, sa_intv: int) -> None:
        self.fm = fm
        self.sa_intv = sa_intv
        if sa_intv <= 0 or sa_intv & (sa_intv - 1):
            raise ValueError("device walker needs power-of-two sa_intv")
        fwd, rev = (np.asarray(s, dtype=np.uint32) for s in sampled)
        if fwd.shape != rev.shape or fwd.ndim != 1 or not len(fwd):
            raise ValueError("the strands' sampled arrays differ in length")
        self.sampled = torch.from_numpy(
            np.stack([fwd, rev]).view(np.int32)).to(fm.device)
        self.last: dict = {}

    def resolve_intervals(self, strand, ks, ls, wave_rows: int = WAVE_ROWS
                          ) -> tuple[np.ndarray, np.ndarray]:
        """SA values of every row of the intervals [ks[i], ls[i]] of
        device strands strand[i]; bit-equal to the host SA walk.

        Returns (off int64[n + 1], the exclusive prefix of the widths;
        vals uint32[off[-1]], interval by interval, k to l within each).
        The rows are resolved in waves of at most `wave_rows`, one launch
        each on a CUDA device, all enqueued before the one wait."""
        ks = np.asarray(ks, dtype=np.uint32)
        ls = np.asarray(ls, dtype=np.uint32)
        strand = np.asarray(strand, dtype=np.uint32)
        if not ks.shape == ls.shape == strand.shape or ks.ndim != 1:
            raise ValueError("strand, ks, ls must be equal 1-D arrays")
        if (ls < ks).any() or (strand > 1).any():
            raise ValueError("intervals must be non-empty, strands 0 or 1")
        if wave_rows <= 0:
            raise ValueError(f"wave_rows must be positive: {wave_rows}")
        fm = self.fm
        dev = fm.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        off = np.zeros(len(ks) + 1, dtype=np.int64)
        np.cumsum(ls.astype(np.int64) - ks + 1, out=off[1:])
        total = int(off[-1])
        self.last = dict(rows=total, waves=0, launches=0, steps=0, longest=0)
        if not total:
            return off, np.zeros(0, dtype=np.uint32)
        wave_rows = min(wave_rows, (1 << 31) - 1)
        iv = torch.from_numpy(np.stack([strand, ks]).view(np.int32)).to(dev)
        off_t = torch.from_numpy(off).to(dev)
        cuda = dev.type == "cuda"
        host = torch.empty(total, dtype=torch.int32, pin_memory=cuda)
        stats = []
        before = kernels.launches["lf_walk"]
        for r0 in range(0, total, wave_rows):
            r1 = min(r0 + wave_rows, total)
            out, st = lf_resolve(fm, self.sampled, iv, off_t, r0, r1,
                                 self.sa_intv - 1)
            host[r0:r1].copy_(out, non_blocking=cuda)
            stats.append(st)
        # one wait: the stats' copy follows every wave's on the stream
        st = torch.stack(stats).cpu()
        self.last.update(waves=len(stats),
                         launches=kernels.launches["lf_walk"] - before,
                         steps=int(st[:, 1].sum()),
                         longest=int(st[:, 2].max()))
        return off, host.numpy().view(np.uint32)

    def resolve(self, strand: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """SA values for (strand, row) pairs: intervals of width 1."""
        return self.resolve_intervals(strand, rows, rows)[1]
