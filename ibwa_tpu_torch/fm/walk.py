"""Batched SA-resolution LF walks on the device (K5).

Port of `ibwa_tpu/fm/walk.py`.  The SAM stages resolve SA rows to text
coordinates by walking LF until a sampled row: `while k % sa_intv: ++add;
k = LF(k)` (reference bwt_sa, bwt.c:61-79).  The walks of a batch are
independent pointer chases, one lane each.

One walk step per lane is one row of the device block table (`device.py`:
intv 64 and 32-byte rows by default, 32 and 128 as options): the row
yields both the BWT code at the row and its inclusive occ count.  A lane
retires when it stands on a sampled row; the final sampled-array lookup
(a host-resident table) happens in numpy.

`lf_step_plain` / `lf_walk_plain` are the plain PyTorch versions (ports of
`_lf_step` / `_lf_walk`); `lf_walk` sends a CPU table to the plain version
and a CUDA table to the kernel in `csrc/lf_walk.cu`.  u32 values are
int64 tensors, as everywhere in the port (`u32.py`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..u32 import MASK, partial_mask, popcount
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
    """`lf_walk_plain` for a table on the CPU, the kernel for one on a
    CUDA device.  strand, k0: int64[N] on the table's device."""
    for q in (strand, k0):
        if q.device != fm.device:
            raise ValueError(f"query on {q.device}, index on {fm.device}")
        if q.dtype != torch.int64 or q.dim() != 1 or q.shape != k0.shape:
            raise ValueError("lf_walk queries must be int64[N] tensors")
    if intv_mask < 0 or (intv_mask & (intv_mask + 1)):
        raise ValueError(f"intv_mask must be 2**s - 1: {intv_mask}")
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
        kernels.launches["lf_walk"] += 1
    return add, kfin


WALK_LANES = 131072  # rows per dispatch; env IBWA_WALK_LANES overrides


class DeviceWalker:
    """Device-resident LF walker for one (fwd, rev) index pair.

    Strand convention matches fm.device: 0 = forward index, 1 = reverse.
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
        self.shift = sa_intv.bit_length() - 1
        if (1 << self.shift) != sa_intv:
            raise ValueError("device walker needs power-of-two sa_intv")
        # host-resident sampled arrays
        self.sampled = tuple(np.asarray(s, dtype=np.uint32) for s in sampled)
        self.lanes = int(os.environ.get("IBWA_WALK_LANES", WALK_LANES))

    def resolve(self, strand: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """SA values for (strand, row) pairs; bit-equal to the host SA
        walk.  Every dispatch is enqueued before the first read-back."""
        n = len(rows)
        out = np.empty(n, dtype=np.uint32)
        fm = self.fm
        strand = np.asarray(strand)
        to_dev = lambda a: torch.from_numpy(
            np.ascontiguousarray(a).astype(np.int64)).to(fm.device)
        pending = []
        for lo in range(0, n, self.lanes):
            hi = min(lo + self.lanes, n)
            add, kfin = lf_walk(fm, to_dev(strand[lo:hi]),
                                to_dev(rows[lo:hi]), self.sa_intv - 1)
            pending.append((lo, hi, add, kfin))
        for lo, hi, add, kfin in pending:
            addn = add.cpu().numpy().astype(np.uint32)
            slot = kfin.cpu().numpy() >> self.shift
            base = np.where(strand[lo:hi] == 0, self.sampled[0][slot],
                            self.sampled[1][slot]).astype(np.uint32)
            out[lo:hi] = addn + base          # wraps mod 2^32
        return out
