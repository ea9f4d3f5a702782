"""Batched banded seed extensions of `bwasw` on a device (K9).

Port of `ibwa_tpu/ops/dp.py`.  A seed extension is the reference's
one-sided banded Smith-Waterman (aln_extend_core, stdaln.c:862-1008; host
twin `ibwa_extend_aln`, native/src/core.cpp): seeded with G0 at the
origin, the band shrunk to the positive cells of each row, score and
endpoint only.  `bsw2.cpp`'s staged driver collects the extensions of a
whole segment of reads into one batch of independent jobs.

The jobs come as the native driver holds them (`ExtBatch`): the targets
and the queries each in one flat u8 blob with int64 offsets `[n + 1]`, a
G0 and a band a job, one 5x5 matrix and one gap pair a batch.  No job is
padded or bucketed.

`extend_scan` runs the listed jobs: on CUDA tensors one launch of
`csrc/extend_dp.cu` (K9, a warp a job, the band's window on a ring in
shared memory, or for a batch with a band wider than a ring holds the
job's row in global memory), on CPU tensors the plain version
`extend_scan_plain`, on any other device it raises.  `extend_scan_first`
is the same through K9's first version (`csrc/extend_dp_first.cu`), which
no path runs: it is kept to be timed beside the redesign.  `extend_jobs`
takes a batch as numpy arrays, runs on the device every job that is not
empty and that `extend_gate_ok` admits, and the gate's refusals on the
host kernel (`native.extend_aln`).

Value-exactness (each held by `tests/test_torch_dp.py` against the native
scalar kernel and the JAX package's scan):
  * the in-row F chain  f = max(f - r, max(h - qr, 0))  with
    h = max(diag, e, f) is a closed form: an F-sourced h contributes
    f - qr <= f - r, which the decay already holds, so F[i] =
    max_{i' < i} (g[i'] - (i - i' - 1) r) with g = max(max(diag, e) - qr,
    0), one exclusive running max of g + i r;
  * the adaptive band (start = first h > 0 cell, end = last + 3, stop on
    a row without one) is carried exactly, not widened: cells outside it
    keep stale values that later rows read again;
  * the 16-bit rescale of the host kernel (kOverflowThreshold) is not
    implemented: a job whose score can reach it (G0 + qlen max(matrix) >=
    30000) goes to the host kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels, native

NEG_BIG = -(1 << 29)
GATE = 30000


def extend_gate_ok(qlen: int, g0: int, max_match: int) -> bool:
    """True if the job can't trip the host kernel's 16-bit rescale."""
    return g0 + qlen * max_match < GATE


def _window(band: torch.Tensor) -> int:
    """The scan's window: 128 cells, doubled until it holds 2 band + 2."""
    w = 128
    hi = int(band.max()) if band.numel() else 0
    while w < 2 * hi + 2:
        w *= 2
    return w


def _padded(blob: torch.Tensor, off: torch.Tensor, lens: torch.Tensor,
            width: int, lead: int) -> torch.Tensor:
    """int64[m, width]: row x holds a job's sequence from column `lead`
    on, zero elsewhere."""
    col = torch.arange(width, device=blob.device) - lead
    pos = off[:, None] + col[None, :]
    ok = (col[None, :] >= 0) & (col[None, :] < lens[:, None])
    if not blob.numel():
        return torch.zeros(pos.shape, dtype=torch.int64, device=blob.device)
    vals = blob[pos.clamp(0, blob.numel() - 1)].to(torch.int64)
    return torch.where(ok, vals, 0)


def extend_scan_plain(tgt_blob: torch.Tensor, tgt_off: torch.Tensor,
                      qry_blob: torch.Tensor, qry_off: torch.Tensor,
                      g0: torch.Tensor, band: torch.Tensor,
                      ids: torch.Tensor, matrix: torch.Tensor,
                      gap_open: int, gap_ext: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The listed jobs' extensions, all jobs a row of the scan at a time
    (the JAX package's `_extend_scan`, row by row in torch), on any
    device.

    Returns (out int32[n, 3]: (score - 1, end_i, end_j) for the rows in
    `ids` and (-1, 0, 0) for the others; stats int64[4]: jobs, rows run,
    cells computed, the longest job's rows)."""
    dev = tgt_blob.device
    n = g0.shape[0]
    out = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    out[:, 0] = -1
    m = ids.shape[0]
    if not m:
        return out, torch.zeros(4, dtype=torch.int64)
    idx = ids.to(torch.int64)
    toff, qoff = tgt_off[idx], qry_off[idx]
    tlens = tgt_off[idx + 1] - toff
    qlens = qry_off[idx + 1] - qoff
    bands = band[idx].to(torch.int64)
    W = _window(bands)
    L1 = int(tlens.max())
    L2 = int(qlens.max())
    width = max(L1 + 2, W)
    targets = _padded(tgt_blob, toff, tlens, width, 1)   # [:, i] = seq1[i-1]
    queries = _padded(qry_blob, qoff, qlens, L2, 0)
    mat = matrix.to(device=dev, dtype=torch.int64).reshape(-1)
    qr, r = gap_open + gap_ext, gap_ext
    widx = torch.arange(W, device=dev)
    key_off = (widx + 1) * r            # the chain's key, from the window
    f_off = widx * r
    neg = torch.full((m, 1), NEG_BIG, dtype=torch.int64, device=dev)
    zero = torch.zeros((m, 1), dtype=torch.int64, device=dev)
    q5 = queries * 5
    tl1 = tlens + 1

    eh_h = torch.zeros((m, width), dtype=torch.int64, device=dev)
    eh_h[:, 1] = g0[idx].to(torch.int64)
    eh_e = torch.zeros_like(eh_h)
    start = torch.ones(m, dtype=torch.int64, device=dev)
    end = torch.full((m,), 2, dtype=torch.int64, device=dev)
    # a lane stays alive while its job runs: its query has row j, its band
    # is not empty, its last row had a positive cell; a lane that is not
    # alive is never again, so its start and end need no care
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    score = torch.zeros(m, dtype=torch.int64, device=dev)
    end_i = torch.zeros_like(score)
    end_j = torch.zeros_like(score)
    rows = torch.zeros_like(score)
    cells = torch.zeros_like(score)
    for j in range(1, L2 + 1):
        alive &= qlens >= j
        start2 = torch.maximum(start, torch.clamp(j - bands, min=1))
        end2 = torch.minimum(end, torch.minimum(j + bands, tl1))
        alive &= start2 != end2
        rows += alive
        cells += (end2 - start2) * alive

        w0 = min(max(j - 1 - (W // 2 - 1), 0), width - W)
        lo = torch.where(alive, start2 - w0, W)[:, None]
        hi = (end2 - w0)[:, None]
        ge = widx >= lo
        incell = ge & (widx < hi)          # [start2, end2) of a live lane
        hmask = ge & (widx <= hi)          # ... and its cell end2
        hwin = eh_h[:, w0:w0 + W]
        ewin = eh_e[:, w0:w0 + W]
        sc = mat[q5[:, j - 1, None] + targets[:, w0:w0 + W]]

        de = torch.maximum(torch.where(hwin != 0, hwin + sc, 0), ewin)
        g = torch.where(incell, torch.clamp(de - qr, min=0), NEG_BIG)
        # f_{i+1} = max(f_i - r, g_i): g_i reaches cell i + k decayed by
        # (k - 1) r, hence the + 1 in the key (offsets from the window)
        cm = torch.cummax(g + key_off, dim=1).values
        f = torch.cat([neg, cm[:, :-1]], dim=1) - f_off
        h = torch.where(incell, torch.maximum(de, f), 0)

        # the row's maximum and its FIRST position (h is 0 off the band,
        # and score >= 0, so a lane that is not alive never updates)
        rowmax = h.max(dim=1).values
        upd = rowmax > score
        pos = torch.where(h == rowmax[:, None], widx, W).min(dim=1).values
        score = torch.maximum(score, rowmax)
        end_i = torch.where(upd, w0 + pos, end_i)
        end_j = torch.where(upd, j, end_j)

        posm = h > 0
        alive &= posm.any(dim=1)
        start = w0 + torch.where(posm, widx, W).min(dim=1).values
        end = w0 + 3 + torch.where(posm, widx, -1).max(dim=1).values

        e_new = torch.maximum(ewin - r, torch.clamp(h - qr, min=0))
        eh_h[:, w0:w0 + W] = torch.where(
            hmask, torch.cat([zero, h[:, :-1]], dim=1), hwin)
        eh_e[:, w0:w0 + W] = torch.where(
            incell, e_new, torch.where(hmask, 0, ewin))
        if j % 64 == 0 and not bool(alive.any()):
            break
    out[idx] = torch.stack([score - 1, end_i, end_j], dim=1).to(torch.int32)
    stats = torch.tensor([m, int(rows.sum()), int(cells.sum()),
                          int(rows.max())], dtype=torch.int64)
    return out, stats


# the widest band a ring of K9 holds (`kRingBand` in csrc/extend_dp.cu: a
# row touches 2 band + 9 cells of a 512-cell ring); a batch with a wider
# band runs on rows in global memory
RING_BAND = 251


def extend_dp_info(n_ids: int = 1 << 40) -> dict:
    """K9's launch shape for a batch of n_ids jobs (by default one that
    fills the card; `ibwa_extend_dp_info`): warps a block, cells a lane,
    ring cells, the widest band a ring holds, the blocks an SM, the grid,
    and the static shared bytes a block of the rings' mode."""
    buf = (ctypes.c_int * 7)()
    rc = kernels.lib().ibwa_extend_dp_info(n_ids, buf)
    kernels.check(rc, "extend_dp_info")
    return dict(zip(("warps", "cells_a_lane", "ring_cells", "ring_band",
                     "blocks_an_sm", "grid", "smem_bytes"), buf))


def _launch(entry: str, name: str, n_stats: int, eh, tgt_blob, tgt_off,
            qry_blob, qry_off, g0, band, ids, matrix: np.ndarray,
            gap_open: int, gap_ext: int, stream: int, max_blocks: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the C entry `entry` (both of K9's take the same
    arguments), counted as `name`."""
    dev = tgt_blob.device
    n = g0.shape[0]
    out = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    out[:, 0] = -1
    stats = torch.zeros(n_stats, dtype=torch.int64, device=dev)
    mat = np.ascontiguousarray(matrix, dtype=np.int32).reshape(25)
    rc = getattr(kernels.lib(), entry)(
        tgt_blob.data_ptr(), tgt_off.data_ptr(), qry_blob.data_ptr(),
        qry_off.data_ptr(), g0.data_ptr(), band.data_ptr(), ids.data_ptr(),
        ids.shape[0], mat.ctypes.data, gap_open, gap_ext,
        None if eh is None else eh.data_ptr(), out.data_ptr(),
        stats.data_ptr(), max_blocks, stream)
    kernels.check(rc, name)
    if ids.shape[0]:
        kernels.launches[name] += 1
    return out, stats


def _launch_extend(tgt_blob, tgt_off, qry_blob, qry_off, g0, band, ids,
                   matrix: np.ndarray, gap_open: int, gap_ext: int,
                   stream: int, max_blocks: int = 0,
                   widest_band: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of `csrc/extend_dp.cu` on the listed jobs, as
    `extend_scan_plain` returns them but with stats[0] the job queue's
    final count (>= the jobs) and two more stats: [4] jobs run on a ring
    in shared memory, [5] on a row in global memory.  The mode is the
    rings' where the widest listed band fits them (`widest_band`, read
    from the tensors if not given), else the rows', whose scratch is
    allocated only then.  No checks: `extend_scan` makes them."""
    if widest_band is None:
        widest_band = (int(band[ids.to(torch.int64)].max())
                       if ids.numel() else 0)
    eh = None
    if widest_band > RING_BAND:
        # job i's row at the first multiple of 4 from tgt_off[i] + 12 i
        # (the blob holds tgt_off[n] bases: its size needs no read-back)
        eh = torch.empty(tgt_blob.numel() + 12 * g0.shape[0] + 4,
                         dtype=torch.int32, device=tgt_blob.device)
    return _launch("ibwa_extend_dp", "extend_dp", 6, eh, tgt_blob, tgt_off,
                   qry_blob, qry_off, g0, band, ids, matrix, gap_open,
                   gap_ext, stream, max_blocks)


def _launch_extend_first(tgt_blob, tgt_off, qry_blob, qry_off, g0, band,
                         ids, matrix: np.ndarray, gap_open: int,
                         gap_ext: int, stream: int, max_blocks: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K9's first version (`csrc/extend_dp_first.cu`: the
    job's whole row in global memory, 32 cells a stride), as
    `_launch_extend` returns it but with stats int64[4]."""
    # each job's E/H row, len1 + 2 cells, at tgt_off[i] + 2 i
    eh = torch.empty(tgt_blob.numel() + 2 * g0.shape[0], dtype=torch.int32,
                     device=tgt_blob.device)
    return _launch("ibwa_extend_dp_first", "extend_dp_first", 4, eh,
                   tgt_blob, tgt_off, qry_blob, qry_off, g0, band, ids,
                   matrix, gap_open, gap_ext, stream, max_blocks)


def _scan(launch, tgt_blob, tgt_off, qry_blob, qry_off, g0, band, ids,
          matrix, gap_open: int, gap_ext: int, **kw
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The checks, then the plain version for CPU tensors or `launch` on
    the current stream for CUDA tensors."""
    n = g0.shape[0]
    dev = tgt_blob.device
    for t, dt, shape in ((tgt_blob, torch.uint8, None),
                         (qry_blob, torch.uint8, None),
                         (tgt_off, torch.int64, (n + 1,)),
                         (qry_off, torch.int64, (n + 1,)),
                         (g0, torch.int32, (n,)), (band, torch.int32, (n,)),
                         (ids, torch.int32, None)):
        if t.device != dev:
            raise ValueError(f"extension input on {t.device}, blob on {dev}")
        if (t.dtype != dt or t.dim() != 1 or not t.is_contiguous()
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(f"extend_scan wants contiguous {dt}"
                             f"{list(shape) if shape else '[*]'}")
    matrix = np.asarray(matrix)
    if matrix.size != 25:
        raise ValueError("the matrix must hold 25 scores")
    if dev.type == "cpu":
        return extend_scan_plain(tgt_blob, tgt_off, qry_blob, qry_off, g0,
                                 band, ids, torch.from_numpy(
                                     matrix.astype(np.int64).reshape(25)),
                                 gap_open, gap_ext)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return launch(tgt_blob, tgt_off, qry_blob, qry_off, g0, band, ids,
                  matrix, gap_open, gap_ext,
                  torch.cuda.current_stream(dev).cuda_stream, **kw)


def extend_scan(tgt_blob: torch.Tensor, tgt_off: torch.Tensor,
                qry_blob: torch.Tensor, qry_off: torch.Tensor,
                g0: torch.Tensor, band: torch.Tensor, ids: torch.Tensor,
                matrix: np.ndarray, gap_open: int, gap_ext: int,
                widest_band: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The extensions of the jobs `ids` (each non-empty and admitted by
    `extend_gate_ok`): `extend_scan_plain` for CPU tensors, one launch of
    K9 for CUDA tensors (stats[0] is then the queue's count, and stats[4]
    and [5] the jobs run on rings in shared memory and on rows in global
    memory).

    tgt_blob, qry_blob: uint8; tgt_off, qry_off: int64[n + 1]; g0, band:
    int32[n]; ids: int32[m]; all contiguous on one device.  matrix: the
    25 scores (numpy).  widest_band: the largest band of the listed jobs,
    where the caller holds it (else it is read from the tensors, a wait
    for the card)."""
    return _scan(_launch_extend, tgt_blob, tgt_off, qry_blob, qry_off, g0,
                 band, ids, matrix, gap_open, gap_ext,
                 widest_band=widest_band)


def extend_scan_first(tgt_blob: torch.Tensor, tgt_off: torch.Tensor,
                      qry_blob: torch.Tensor, qry_off: torch.Tensor,
                      g0: torch.Tensor, band: torch.Tensor,
                      ids: torch.Tensor, matrix: np.ndarray, gap_open: int,
                      gap_ext: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`extend_scan` through K9's first version on CUDA tensors (the plain
    version on CPU tensors).  No path runs it: `chip_smoke.py` times it
    beside the redesign."""
    return _scan(_launch_extend_first, tgt_blob, tgt_off, qry_blob,
                 qry_off, g0, band, ids, matrix, gap_open, gap_ext)


def device_jobs(tgt_off: np.ndarray, qry_off: np.ndarray, g0: np.ndarray,
                matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(jobs the device runs, jobs the gate leaves to the host), as int32
    and int64 index arrays; empty jobs are in neither.  The device's jobs
    come longest query first (a job runs at most a row a query base): K9's
    queue hands them out in this order, so the long jobs start first and
    the short ones fill in behind them."""
    ql = np.diff(qry_off)
    live = (np.diff(tgt_off) > 0) & (ql > 0)
    ok = extend_gate_ok(ql, g0.astype(np.int64), int(np.max(matrix)))
    ids = np.flatnonzero(live & ok)
    ids = ids[np.argsort(-ql[ids], kind="stable")]
    return ids.astype(np.int32), np.flatnonzero(live & ~ok)


def extend_jobs(tgt_blob: np.ndarray, tgt_off: np.ndarray,
                qry_blob: np.ndarray, qry_off: np.ndarray, g0: np.ndarray,
                band: np.ndarray, matrix: np.ndarray, gap_open: int,
                gap_ext: int, device) -> tuple[np.ndarray, dict]:
    """A batch of extension jobs as the native driver holds it: every job
    that is not empty and that the gate admits on `device` (one launch of
    K9 on a CUDA device, the plain version on the CPU), the gate's
    refusals on the host kernel, empty jobs (-1, 0, 0).

    Returns (out int32[n, 3], counts: device jobs, gate jobs, the
    kernel's stats as a list)."""
    dev = torch.device(device)
    n = len(g0)
    ids, host = device_jobs(tgt_off, qry_off, g0, matrix)
    out = np.zeros((n, 3), dtype=np.int32)
    out[:, 0] = -1
    stats = [0, 0, 0, 0]
    if len(ids):
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        got, st = extend_scan(up(tgt_blob), up(tgt_off), up(qry_blob),
                              up(qry_off), up(g0.astype(np.int32)),
                              up(band.astype(np.int32)), up(ids), matrix,
                              int(gap_open), int(gap_ext),
                              widest_band=int(band[ids].max()))
        if dev.type == "cuda":
            pinned = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
            pinned.copy_(got, non_blocking=True)
            stats = st.tolist()      # waits for the stream
            got = pinned
        else:
            stats = st.tolist()
        out[ids] = got.numpy()[ids]
    m = np.asarray(matrix, dtype=np.int32).reshape(5, 5)
    for i in host:
        out[i] = native.extend_aln(tgt_blob[tgt_off[i]:tgt_off[i + 1]],
                                   qry_blob[qry_off[i]:qry_off[i + 1]],
                                   int(gap_open), int(gap_ext), int(band[i]),
                                   m, int(g0[i]))
    return out, {"device": len(ids), "gate": len(host), "stats": stats}
