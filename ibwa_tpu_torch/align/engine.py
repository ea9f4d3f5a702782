"""Batched `aln` gapped search on a torch device (port of engine_jax).

Re-implements bwt_match_gap (bwtgap.c:104-264) + bwt_cal_width
(bwtaln.c:54-78) over a read batch, exactly as
`ibwa_tpu/align/engine_jax.py` does: a per-read entry arena whose packed
priority key

    key = score << 20 | (0xFFFFF - push_seqno)        (an int32)

makes one first-minimum argmin reproduce the reference's pop order, an
"E" entry state for bwt_match_exact_alt, persistent lanes that stream
reads, and a host fallback (the native C++ search) for every read that
overflows a device capacity.  See engine_jax's module docstring for the
packed entry layout; the port keeps it bit for bit.

Port conventions:
  * u32 values are int64 tensors masked to 32 bits where they can wrap
    (`u32.py`); int32 values are int64 tensors, and the int32 key is
    wrapped with `wrap_i32`; the five arena planes are int32 tensors.
  * JAX's dropped scatters (`mode="drop"` at row B/N) become masked
    writes to rows that exist; gathers whose index JAX would clamp for
    finished lanes are clamped here too.
  * Between a chunk's upload and its download the main path runs two
    hand-written kernels, each with its plain version beside it, taken
    for CPU tensors only: `big_planes` (the width pass: `csrc/width_pass.cu`,
    whose occ query is K2's device code; plain `big_planes_plain`, torch
    ops plus one occ1_pair per base) and `search_chunk`
    (`csrc/search_chunk.cu`: every lane the card holds takes reads from a
    queue, each read's whole search in the one launch, a lane's arena in
    shared memory, its scalars in registers, the reads' planes and output
    rows worked on in place; its step stage is
    `csrc/search_step.cuh`, whose stages 3 and 7 are K2's and K1's device
    code, its switch stage `csrc/lane_switch.cuh`).
  * The plain version of `search_chunk` is the phased loop,
    `run_search_phased`: every SWITCH_K steps a switch phase
    (`_Chunk.switch`; plain `switch_plain` with `_load_lanes`), then
    `search_steps` (plain `_search_step`, torch ops plus occ4_pair /
    occ1_pair and stack_update), then one copy of the two words (reads
    left, steps) to the host.  It is what CPU tensors run.  On CUDA tensors
    the same loop is one `csrc/lane_switch.cu` and one `csrc/search_step.cu`
    launch per phase: no path of `aln` takes it there, the card's check
    holds `search_chunk` against it.
  * The card's path does not sync with the host between the launch of
    `search_chunk` and the download of its results; `finish_chunk`
    (`chunk_schedule`) gives the phased loop's step count from the reads'
    own iteration counts, which the kernel writes.
  * Every read at the host search carries why (FB_*): the plain step and
    switch keep it per lane and read, the kernel per read, and
    `TorchAlnEngine` counts it (`fallback_by_cause`).
  * Still torch ops on the main path: the allocations and uploads of a
    chunk, the final stack / slice of its outputs; `_decode` is numpy on
    the host.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from .. import kernels, native
from ..fm.device import (DeviceFmPair, Shards, build_device_pair, cuda_table,
                         occ1_pair, occ1_pair_plain, occ4_pair,
                         occ4_pair_plain, pair_to, shard_pair)
from ..fm.fmindex import FmIndex
from ..spans import Recorder
from ..u32 import MASK, int_log2, wrap_i32
from . import engine_ref
from .engine_ref import Hit
from .opts import (BWA_MODE_GAPE, BWA_MODE_LOGGAP, BWA_MODE_NONSTOP, GapOpt,
                   aln_score, cal_maxdiff)
from .stack_kernel import stack_update

STATE_M, STATE_I, STATE_D, STATE_E = 0, 1, 2, 3
INT32_MAX = 0x7FFFFFFF
I64 = torch.int64

ACAP = 256        # arena slots per read (1024 for wide budgets / small
                  # genomes, see make_config); overflow -> host fallback
HCAP = 64         # max hits recorded per read
MAX_ITERS = 16384
MAX_SEQ = 0xFFFFF  # seqno field width in the priority key
DEV_BATCH = 1024  # persistent device lanes per dispatch
PERSIST_N = 2048  # reads streamed through the lanes per dispatch
E_UNROLL = 2      # exact-extension bases consumed per E pop
ITER_CAP = 384    # pushes before a read is routed to the host search
CARD_ACAP = 2048        # on a card (`caps`): the arena and step budget of
CARD_ITER_CAP = 1536    # a narrow budget on a big genome, the step budget
                        # of a wide one; chosen by batches' search time
                        # (PERF.md §6)
SWITCH_K = 16     # search steps between lane-switch phases
# why a read went to the host search (its fb flag), in the plain step's
# order where two fire in one step: csrc/search_step.cuh's kCause*, then
# FB_BOUND for the reads that the phased loop's iteration bound sends there
FB_NONE, FB_ITER_CAP, FB_ARENA, FB_HITS, FB_SEQNO, FB_BOUND = range(6)
FB_CAUSES = ("iter_cap", "arena", "hits", "seqno", "bound")  # codes 1..5
HOST_FRAC_INIT = 0.30  # starting host share of a batch (hybrid) on the
                       # CPU; adapts per batch; IBWA_HOST_FRAC fixes it
CARD_HOST_FRAC_INIT = 0.0  # on a card: a one-batch run has nothing to adapt
                           # from, and the card searches a read faster
HOST_CHUNK = 2048      # reads per native job
HYBRID_MIN = 2048      # a batch of at most this many reads has no host
                       # share (engine_jax.py's threshold)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static search parameters of one read batch."""

    L: int            # padded read length
    SL: int           # seed length (opt.seed_len)
    NB: int           # number of score buckets
    s_mm: int
    s_gapo: int
    s_gape: int
    max_gapo: int
    max_gape: int
    max_del_occ: int
    indel_end_skip: int
    max_top2: int
    max_entries: int
    max_seed_diff: int
    iter_cap: int     # per-read device step budget (tail -> host search)
    acap: int         # entry arena slots per read
    gape_mode: bool   # BWA_MODE_GAPE
    nonstop: bool     # BWA_MODE_NONSTOP
    loggap: bool      # BWA_MODE_LOGGAP


def caps(max_diff_hi: int, opt: GapOpt, seq_len: int,
         device_type: str = "cpu") -> tuple[int, int]:
    """(arena slots, step budget) of a read's device search; a read that
    outgrows either goes to the host search.  The CPU's phased loop keeps
    engine_jax's: narrow budgets on big genomes fit the small arena; wide
    budgets and small genomes (wide SA intervals) fan out far more entries.
    On a card a launch lasts as long as its longest read, so the caps rise
    only where the reads they keep from the host search pay for that: a
    narrow budget on a big genome takes CARD_ACAP and CARD_ITER_CAP, a
    wide budget CARD_ITER_CAP in the wide arena; -N and genomes below
    2^22 keep the CPU's caps, which searched them fastest."""
    narrow = max_diff_hi <= 5 and opt.max_gapo <= 1
    nonstop = bool(opt.mode & BWA_MODE_NONSTOP)
    big = seq_len >= (1 << 22)
    acap = ACAP if narrow and big and not nonstop else max(ACAP, 1024)
    if device_type != "cuda" or nonstop or not big:
        return acap, ITER_CAP
    return (max(acap, CARD_ACAP) if narrow else acap,
            max(ITER_CAP, CARD_ITER_CAP))


def make_config(L: int, max_diff_hi: int, opt: GapOpt, seq_len: int = 0,
                device_type: str = "cpu") -> EngineConfig:
    """Search parameters for a read batch (engine_jax.make_config on the
    CPU; `caps` on a card)."""
    nb = aln_score(max_diff_hi + 1, opt.max_gapo + 1, opt.max_gape + 1,
                   opt) + 1
    acap, iter_cap = caps(max_diff_hi, opt, seq_len, device_type)
    return EngineConfig(
        L=L, SL=min(opt.seed_len, L), NB=nb,
        s_mm=opt.s_mm, s_gapo=opt.s_gapo, s_gape=opt.s_gape,
        max_gapo=opt.max_gapo, max_gape=opt.max_gape,
        max_del_occ=opt.max_del_occ,
        indel_end_skip=opt.indel_end_skip, max_top2=opt.max_top2,
        max_entries=min(opt.max_entries, INT32_MAX),
        max_seed_diff=opt.max_seed_diff,
        iter_cap=iter_cap, acap=acap,
        gape_mode=bool(opt.mode & BWA_MODE_GAPE),
        nonstop=bool(opt.mode & BWA_MODE_NONSTOP),
        loggap=bool(opt.mode & BWA_MODE_LOGGAP),
    )


@dataclasses.dataclass
class SearchState:
    """Per-lane search state, in engine_jax's 30-field order
    (engine_jax.py:252-257).  Shapes: [B] unless noted; P = L + SL + 2."""

    rid: torch.Tensor         # read index in the chunk (int32 value)
    lens: torch.Tensor
    has_seed: torch.Tensor    # bool
    lane_it: torch.Tensor
    sk: torch.Tensor          # int32[B, acap] arena planes (u32 bits)
    sl: torch.Tensor
    sm1: torch.Tensor
    sm2: torch.Tensor
    key: torch.Tensor         # int32[B, acap]
    seqc: torch.Tensor
    stack_n: torch.Tensor
    w: torch.Tensor           # [B, 2, P] u32 widths (main ++ seed)
    bid: torch.Tensor         # [B, 2, P]
    meta: torch.Tensor        # [B, 2, P] u32, _pack_meta(w, bid)
    hk: torch.Tensor          # [B, HCAP] u32
    hl: torch.Tensor
    hm: torch.Tensor
    n_hits: torch.Tensor
    best_score: torch.Tensor
    best_cnt: torch.Tensor
    max_diff: torch.Tensor
    done: torch.Tensor        # bool
    fb: torch.Tensor          # bool: route to the host search
    it: torch.Tensor          # [] step counter
    pslot: torch.Tensor       # next pop (computed by stack_update)
    pkey: torch.Tensor
    pk: torch.Tensor
    pl: torch.Tensor
    pm1: torch.Tensor
    pm2: torch.Tensor


FIELDS = tuple(f.name for f in dataclasses.fields(SearchState))


def _pack_m2(nmm, gapo, gape):
    return (nmm | (gapo << 8) | (gape << 16)) & MASK


def _pack_m1(state, a, i, ldp):
    return (state | (a << 2) | (i << 3) | (ldp << 16)) & MASK


@functools.lru_cache(maxsize=None)
def _child_states(dev) -> torch.Tensor:
    """Entry state of child slots 0..9 (I, 4 x D, 4 x M, E): int64[1, 10],
    made once per device (no host-to-device copy per step)."""
    return torch.tensor([STATE_I] + [STATE_D] * 4 + [STATE_M] * 4
                        + [STATE_E], dtype=I64, device=dev)[None, :]


def _occ(fm: DeviceFmPair):
    """The (occ4, occ1) pair queries of the plain width pass and step:
    the wrappers (K2 on a card, its plain version on the CPU), or, for a
    table split by rows, the plain queries over the plain B8
    (`gather_rows_sharded`), on any device: no K2 entry reads a split
    table."""
    if fm.shards:
        return occ4_pair_plain, occ1_pair_plain
    return occ4_pair, occ1_pair


def _compute_widths(fm: DeviceFmPair, seqs: torch.Tensor, lens: torch.Tensor,
                    Lw: int):
    """bwt_cal_width (bwtaln.c:54-78), batched over [N, 2] lanes.

    seqs: uint8[N, 2, Lw] (strand 0 against the fwd index, 1 against rev);
    lens: int64[N].  Returns (w, bid): int64[N, 2, Lw + 1]."""
    N = seqs.shape[0]
    dev = seqs.device
    strand = torch.arange(2, device=dev).repeat(N)
    sq = seqs.to(I64).reshape(2 * N, Lw)
    lens2 = lens.repeat_interleave(2)
    k = torch.zeros(2 * N, dtype=I64, device=dev)
    l = torch.full((2 * N,), fm.seq_len, dtype=I64, device=dev)
    b = torch.zeros(2 * N, dtype=I64, device=dev)
    ws, bids = [], []
    for t in range(Lw):
        c = sq[:, t]
        valid = t < lens2
        cn = torch.clamp(c, max=3)
        o = _occ(fm)[1](fm, strand, k, l, cn)
        base = fm.L2[cn]
        usable = c < 4
        k2 = torch.where(usable, (base + o[:, 0] + 1) & MASK, k)
        l2 = torch.where(usable, (base + o[:, 1]) & MASK, l)
        reset = (k2 > l2) | ~usable
        k = torch.where(valid, torch.where(reset, 0, k2), k)
        l = torch.where(valid, torch.where(reset, fm.seq_len, l2), l)
        b = torch.where(valid, b + reset.to(I64), b)
        ws.append(torch.where(valid, (l - k + 1) & MASK, 0))
        bids.append(torch.where(valid, b, 0))
    zero = torch.zeros(2 * N, dtype=I64, device=dev)
    w = torch.stack(ws + [zero], dim=1)
    bid = torch.stack(bids + [zero], dim=1)
    n = torch.clamp(lens2, max=Lw)[:, None]
    w = w.scatter(1, n, 0)
    bid = bid.scatter(1, n, (b + 1)[:, None])
    return w.reshape(N, 2, Lw + 1), bid.reshape(N, 2, Lw + 1)


def _pack_meta(w, bid):
    """Pop-time width summary, one u32 per position: bid[i-1] (14b) |
    bid[i] << 14 | (w[i-1] == w[i]) << 28, position 0 clamping i-1 to 0
    (engine_jax._pack_meta)."""
    wp = torch.cat([w[..., :1], w[..., :-1]], dim=-1)
    bp = torch.cat([bid[..., :1], bid[..., :-1]], dim=-1)
    return (bp | (bid << 14) | ((wp == w).to(I64) << 28)) & MASK


def big_planes_plain(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens,
                     has_seed, seed_seqs):
    """Plain version of `big_planes`: two `_compute_widths` passes (the
    read, then its seed suffix, of length 0 where has_seed is false) and
    `_pack_meta` over the concatenated planes."""
    w, bid = _compute_widths(fm, seqs, lens, cfg.L)
    slens = torch.where(has_seed, cfg.SL, 0)
    sw, sbid = _compute_widths(fm, seed_seqs, slens, cfg.SL)
    w = torch.cat([w, sw], dim=2)
    bid = torch.cat([bid, sbid], dim=2)
    return w, bid, _pack_meta(w, bid)


def _check_tensor(who: str, name: str, t: torch.Tensor, dev, dtype,
                  shape) -> None:
    """Raise unless `t` is what a kernel takes: on `dev`, of `dtype` and
    `shape`, contiguous."""
    if (t.device != dev or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"{who}: {name} must be a contiguous {dtype}{list(shape)} on "
            f"{dev}, got {t.dtype}{list(t.shape)} on {t.device}")


def _check_index(fm: DeviceFmPair) -> tuple[int, Shards]:
    """Raise unless the index is what the search kernels take; returns
    `cuda_table`'s (flat table address, shard table)."""
    table = cuda_table(fm)
    for name in ("L2", "l2diff", "primary"):
        t = getattr(fm, name)
        if t.dtype != I64 or not t.is_contiguous() or t.device != fm.device:
            raise ValueError(f"{name} must be contiguous int64 on "
                             f"{fm.device}")
    return table


def _launch_width_pass(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens,
                       has_seed, seed_seqs, stream: int):
    """Check the tensors the kernel is given and launch `ibwa_width_pass`
    on them; returns the three planes it filled."""
    dev = fm.device
    N = lens.shape[0]
    for name, t, dtype, shape in (
            ("seqs", seqs, torch.uint8, (N, 2, cfg.L)),
            ("seed_seqs", seed_seqs, torch.uint8, (N, 2, cfg.SL)),
            ("lens", lens, I64, (N,)),
            ("has_seed", has_seed, torch.bool, (N,))):
        _check_tensor("big_planes", name, t, dev, dtype, shape)
    blocks, shards = _check_index(fm)
    w, bid, meta = (torch.empty((N, 2, cfg.L + cfg.SL + 2), dtype=I64,
                                device=dev) for _ in range(3))
    name = "width_pass_sharded" if shards.n else "width_pass"
    entry = getattr(kernels.lib(), f"ibwa_{name}")
    rc = entry(
        ctypes.addressof(shards) if shards.n else blocks,
        fm.primary.data_ptr(), fm.L2.data_ptr(),
        fm.l2diff.data_ptr(), seqs.data_ptr(), seed_seqs.data_ptr(),
        lens.data_ptr(), has_seed.data_ptr(), w.data_ptr(), bid.data_ptr(),
        meta.data_ptr(), N, cfg.L, cfg.SL, fm.seq_len, fm.n_blk, fm.intv,
        stream)
    kernels.check(rc, name)
    kernels.launches[name] += 1
    return w, bid, meta


def big_planes(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens, has_seed,
               seed_seqs):
    """w / bid / meta planes of every read of a chunk: int64[N, 2, P],
    P = L + SL + 2 (columns 0..L the read, L+1.. its seed suffix).

    seqs uint8[N, 2, L], lens int64[N], has_seed bool[N], seed_seqs
    uint8[N, 2, SL].  CPU tensors: `big_planes_plain`.  CUDA tensors: one
    launch of the kernel `csrc/width_pass.cu`, its sharded instantiation
    (B8) when the table is split."""
    dev = fm.device
    if dev.type == "cpu":
        return big_planes_plain(cfg, fm, seqs, lens, has_seed, seed_seqs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch_width_pass(cfg, fm, seqs, lens, has_seed, seed_seqs,
                              torch.cuda.current_stream(dev).cuda_stream)


def _search_step(cfg: EngineConfig, fm: DeviceFmPair, seqs: torch.Tensor,
                 st: SearchState, cause: torch.Tensor | None = None
                 ) -> SearchState:
    """One pop-expand step for every active lane (engine_jax._search_step
    without the dimer path).  seqs: uint8[N, 2, L] of the reads the lanes'
    `rid`s index.  The hit planes hk/hl/hm are updated in place, and so is
    `cause` (int64[B], where given): the FB_* code of a lane whose fb flag
    this step sets."""
    B = st.lens.shape[0]
    dev = st.lens.device
    rows = torch.arange(B, device=dev)
    crid = torch.clamp(st.rid, 0, seqs.shape[0] - 1)
    seq_len = fm.seq_len

    act = ~st.done & ~st.fb
    empty = st.stack_n == 0
    done = st.done | (act & empty)
    act = act & ~empty
    over = st.stack_n > cfg.max_entries
    done = done | (act & over)
    act = act & ~over
    # heavy-tail cap: a read burning > ITER_CAP steps goes to the host
    lane_it = st.lane_it + act.to(I64)
    capped = act & (lane_it > cfg.iter_cap)
    fb = st.fb | capped
    act = act & ~capped

    # ---- pop: the previous step's stack_update left it in pslot..pm2
    e_k, e_l, m1, m2 = st.pk, st.pl, st.pm1, st.pm2
    e_score = st.pkey >> 20
    stack_n = st.stack_n - act.to(I64)
    e_state = m1 & 3
    e_a = (m1 >> 2) & 1
    e_i = (m1 >> 3) & 0x1FFF
    e_ldp = (m1 >> 16) & 0x1FFF
    e_nmm = m2 & 0xFF
    e_gapo = (m2 >> 8) & 0xFF
    e_gape = (m2 >> 16) & 0xFF
    best_score, best_cnt, max_diff = st.best_score, st.best_cnt, st.max_diff

    if not cfg.nonstop:
        brk = e_score > best_score + cfg.s_mm
        done = done | (act & brk)
        act = act & ~brk

    sidx = 1 - e_a                       # FM strand searched (fms[1-a])
    is_e = act & (e_state == STATE_E)
    is_norm = act & (e_state != STATE_E)
    i2 = torch.clamp(e_i - 1, min=0)
    i2g = torch.clamp(i2, max=cfg.L - 1)  # gather index (finished lanes)

    # ---- occ4 at (k-1, l): the expansion AND the E-state extension
    occ4, occ1 = _occ(fm)
    cnt = occ4(fm, sidx, e_k, e_l)                   # [B, 2, 4]
    l2b = fm.L2[:4][None, :]
    kj = (l2b + cnt[:, 0] + 1) & MASK                # [B, 4]
    lj = (l2b + cnt[:, 1]) & MASK
    # width/bid facts at (i2-1, i2) and the seed equivalents: one
    # [B, 2]-position gather of the packed meta plane
    ii = i2 - (st.lens - cfg.SL)
    ii_c = torch.clamp(ii, 0, cfg.SL)
    P = st.meta.shape[2]
    pos2 = torch.stack([torch.clamp(i2, max=P - 1), ii_c + cfg.L + 1], -1)
    mg = st.meta.reshape(-1)[((rows * 2 + e_a) * P)[:, None] + pos2]
    mm_, ms_ = mg[:, 0], mg[:, 1]
    bm1, b0_, weq = mm_ & 0x3FFF, (mm_ >> 14) & 0x3FFF, (mm_ >> 28) & 1
    sbm1, sb0, sweq = ms_ & 0x3FFF, (ms_ >> 14) & 0x3FFF, (ms_ >> 28) & 1
    base = seqs[crid, e_a, i2g].to(I64)              # read base

    # ---- normal entry: budget + D(i) width pruning
    m = max_diff - (e_nmm + e_gapo)
    if cfg.gape_mode:
        m = m - e_gape
    alive = is_norm & (m >= 0) & ~((e_i > 0) & (m < b0_))
    hit_direct = alive & (e_i == 0)
    cond_e = alive & (e_i > 0) & (m == 0)
    if not cfg.gape_mode:
        cond_e = cond_e & ((e_state == STATE_M) | (e_gape == cfg.max_gape))
    expand = alive & ~hit_direct & ~cond_e

    # ---- E entry: one base of bwt_match_exact_alt (bwt.c:235-250)
    e_cn = torch.clamp(base, max=3)[:, None]
    e_k2 = kj.gather(1, e_cn)[:, 0]
    e_l2 = lj.gather(1, e_cn)[:, 0]
    e_go = is_e & (e_i > 0) & (base < 4) & (e_k2 <= e_l2)
    hit_e = is_e & (e_i == 0)

    # ---- hit bookkeeping (bwtgap.c:159-196)
    hit = hit_direct | hit_e
    first = hit & (st.n_hits == 0)
    best_score = torch.where(first, e_score, best_score)
    bdiff = e_nmm + e_gapo + (e_gape if cfg.gape_mode else 0)
    if not cfg.nonstop:
        max_diff = torch.where(first, torch.minimum(bdiff + 1, max_diff),
                               max_diff)
    same = e_score == best_score
    occv = (e_l - e_k + 1) & MASK
    brk2 = hit & ~same & (best_cnt > cfg.max_top2)
    best_cnt = torch.where(hit & same, wrap_i32(best_cnt + wrap_i32(occv)),
                           best_cnt)
    done = done | brk2
    add = hit & ~brk2
    hseen = torch.arange(HCAP, device=dev)[None, :] < st.n_hits[:, None]
    dup = ((st.hk == e_k[:, None]) & (st.hl == e_l[:, None])
           & hseen).any(dim=1)
    do_add = add & ~((e_gapo > 0) & dup)
    hovf = do_add & (st.n_hits >= HCAP)
    fb = fb | hovf
    do_add = do_add & ~hovf
    slot = torch.clamp(st.n_hits, max=HCAP - 1)
    nmeta = _pack_m2(e_nmm, e_gapo, e_gape) | (e_a << 24)
    for plane, v in ((st.hk, e_k), (st.hl, e_l), (st.hm, nmeta)):
        plane[rows, slot] = torch.where(do_add, v, plane[rows, slot])
    n_hits = st.n_hits + do_add.to(I64)

    # ---- gap_shadow (bwtgap.c:81-91) over the main positions < ldp
    x3 = occv[:, None, None]
    strand_sel = torch.arange(2, device=dev)[None, :, None] == e_a[:, None,
                                                                   None]
    inr = torch.arange(P, device=dev)[None, None, :] < e_ldp[:, None, None]
    upd = do_add[:, None, None] & strand_sel & inr
    meq = upd & (st.w == x3)
    j = torch.cumsum(meq.to(I64), dim=2)
    w = torch.where(upd & (st.w > x3), st.w - x3,
                    torch.where(meq, (seq_len - j) & MASK, st.w))
    bid = torch.where(meq, 1, st.bid)
    meta = _pack_meta(w, bid)

    # ---- expansion (bwtgap.c:198-258)
    ad1 = bm1 > m - 1
    am1 = ~ad1 & (bm1 == m - 1) & (b0_ == m - 1) & (weq == 1)
    m_seed = cfg.max_seed_diff - (e_nmm + e_gapo)
    if cfg.gape_mode:
        m_seed = m_seed - e_gape
    sgate = st.has_seed & (ii > 0)
    sad = sbm1 > m_seed - 1
    ad2 = sgate & sad
    am2 = sgate & ~sad & (sbm1 == m_seed - 1) & (sb0 == m_seed - 1) \
        & (sweq == 1)
    at_end = i2 == 0
    allow_diff = at_end | (~ad1 & ~ad2)
    allow_m = at_end | (~am1 & ~am2)
    if cfg.loggap:
        tmp = int_log2(e_gape + e_gapo, cfg.max_gapo + cfg.max_gape) // 2 + 1
    else:
        tmp = e_gapo + e_gape
    ok_indel = (expand & allow_diff & (i2 >= cfg.indel_end_skip + tmp)
                & (st.lens - i2 >= cfg.indel_end_skip + tmp))

    col = lambda v: v[:, None]
    full4 = lambda v: col(v).expand(B, 4)
    # slot 0: I open (from M) or I extend (from I)
    io = ok_indel & (e_state == STATE_M) & (e_gapo < cfg.max_gapo)
    ie = ok_indel & (e_state == STATE_I) & (e_gape < cfg.max_gape)
    # slots 1-4: D open (from M) or D extend (from D), base j = 0..3
    d_open = io
    d_ext = (ok_indel & (e_state == STATE_D) & (e_gape < cfg.max_gape)
             & ((e_gape + e_gapo < max_diff) | (occv < cfg.max_del_occ)))
    d_any = d_open | d_ext
    # slots 5-8: mismatch/match, j = 1..4, c = (base + j) & 3
    allow_full = allow_diff & allow_m
    cm = (col(base) + torch.arange(1, 5, device=dev)) & 3     # [B, 4]
    kc = kj.gather(1, cm)
    lc = lj.gather(1, cm)
    is_mm = torch.cat([torch.ones(B, 3, dtype=I64, device=dev),
                       col(base > 3).to(I64)], dim=1)
    m_ok = torch.cat([full4(allow_full)[:, :3],
                      col(allow_full | (base < 4))], dim=1)
    # slot 9: exact-extension chain (spawn or continuation), burning
    # E_UNROLL - 1 more bases with occ1 (the chain is atomic under LIFO)
    ev = cond_e | e_go
    ek9 = torch.where(cond_e, e_k, e_k2)
    el9 = torch.where(cond_e, e_l, e_l2)
    ei9 = torch.where(cond_e, e_i, e_i - 1)
    for _ in range(E_UNROLL - 1):
        cont = ev & (ei9 > 0)
        bu = seqs[crid, e_a, torch.clamp(ei9 - 1, 0, cfg.L - 1)].to(I64)
        cu = torch.clamp(bu, max=3)
        ou = occ1(fm, sidx, ek9, el9, cu)             # [B, 2]
        l2u = fm.L2[cu]
        k2u = (l2u + ou[:, 0] + 1) & MASK
        l2v = (l2u + ou[:, 1]) & MASK
        okx = cont & (bu < 4) & (k2u <= l2v)
        ev = ev & ~(cont & ~okx)
        ek9 = torch.where(okx, k2u, ek9)
        el9 = torch.where(okx, l2v, el9)
        ei9 = torch.where(okx, ei9 - 1, ei9)

    # ---- children [B, 10] in reference push order
    c_valid = torch.cat([col(io | ie), full4(d_any) & (kj <= lj),
                         expand[:, None] & (kc <= lc) & m_ok, col(ev)], 1)
    ck_ = torch.cat([col(e_k), kj, kc, col(ek9)], 1)
    cl_ = torch.cat([col(e_l), lj, lc, col(el9)], 1)
    c_i = torch.cat([col(i2), full4(i2 + 1), full4(i2), col(ei9)], 1)
    c_state = _child_states(dev)
    c_nmm = torch.cat([col(e_nmm), full4(e_nmm), col(e_nmm) + is_mm,
                       col(e_nmm)], 1)
    c_gapo = torch.cat([col(e_gapo + io.to(I64)),
                        full4(e_gapo + d_open.to(I64)), full4(e_gapo),
                        col(e_gapo)], 1)
    c_gape = torch.cat([col(e_gape + ie.to(I64)),
                        full4(e_gape + d_ext.to(I64)), full4(e_gape),
                        col(e_gape)], 1)
    c_ldp = torch.cat([col(i2), full4(i2 + 1),
                       torch.where(is_mm > 0, col(i2), col(e_ldp)),
                       col(e_ldp)], 1)

    # ---- push (LIFO via seqno) through the stack kernel
    cm1 = _pack_m1(c_state, col(e_a), c_i, c_ldp)
    cm2 = _pack_m2(c_nmm, c_gapo, c_gape)
    sc = c_nmm * cfg.s_mm + c_gapo * cfg.s_gapo + c_gape * cfg.s_gape
    cv = c_valid & col(act)
    cvi = cv.to(I64)
    ofs = torch.cumsum(cvi, dim=1) - cvi              # exclusive rank
    seq_ovf = cv & (col(st.seqc) + ofs >= MAX_SEQ)
    fb = fb | seq_ovf.any(dim=1)
    cv = cv & ~seq_ovf
    kv = wrap_i32((sc << 20) | (MAX_SEQ - (col(st.seqc) + ofs)))
    (key, sk, sl, sm1, sm2, ovf, npush,
     pslot, pkey, pk, pl, pm1, pm2) = stack_update(
        st.pslot, act, cv, ofs, kv, ck_, cl_, cm1, cm2,
        st.key, st.sk, st.sl, st.sm1, st.sm2)
    fb = fb | ovf
    if cause is not None:   # the first of the step's causes, in its order
        code = torch.where(capped, FB_ITER_CAP, torch.where(
            hovf, FB_HITS, torch.where(seq_ovf.any(dim=1), FB_SEQNO,
                                       torch.where(ovf, FB_ARENA, 0))))
        cause.copy_(torch.where(code > 0, code, cause))

    return SearchState(
        rid=st.rid, lens=st.lens, has_seed=st.has_seed, lane_it=lane_it,
        sk=sk, sl=sl, sm1=sm1, sm2=sm2, key=key, seqc=st.seqc + npush,
        stack_n=stack_n + npush, w=w, bid=bid, meta=meta,
        hk=st.hk, hl=st.hl, hm=st.hm, n_hits=n_hits,
        best_score=best_score, best_cnt=best_cnt, max_diff=max_diff,
        done=done, fb=fb, it=st.it + 1,
        pslot=pslot, pkey=pkey, pk=pk, pl=pl, pm1=pm1, pm2=pm2)


_STATE_DTYPES = {"has_seed": torch.bool, "done": torch.bool,
                 "fb": torch.bool, "sk": torch.int32, "sl": torch.int32,
                 "sm1": torch.int32, "sm2": torch.int32, "key": torch.int32}


class _SearchCfg(ctypes.Structure):
    """What both search kernels take beside their own tensors, field for
    field the struct IbwaSearchCfg of csrc/search_step.cuh: the index, the
    reads, then shapes, the config, the engine's constants and the row
    ranges of a split table."""

    _fields_ = (
        [(name, ctypes.c_void_p)
         for name in ("blocks", "primary", "L2", "l2diff", "seqs")]
        + [(name, ctypes.c_int64) for name in ("seq_len", "n_blk")]
        + [(name, ctypes.c_int) for name in (
            "n_reads", "intv", "L", "SL", "acap", "hcap",
            "s_mm", "s_gapo", "s_gape", "max_gapo", "max_gape",
            "max_del_occ", "indel_end_skip", "max_top2", "max_entries",
            "max_seed_diff", "iter_cap", "gape_mode", "nonstop", "loggap",
            "max_seq", "e_unroll", "state_m", "state_i", "state_d",
            "state_e")]
        + [("shards", Shards)])


def _search_cfg(who: str, cfg: EngineConfig, fm: DeviceFmPair,
                seqs: torch.Tensor, split_ok: bool = False) -> _SearchCfg:
    """Check the index and the reads a search kernel is given and build
    its `_SearchCfg`; a split table only where `split_ok`."""
    if (seqs.device != fm.device or seqs.dtype != torch.uint8
            or seqs.dim() != 3 or tuple(seqs.shape[1:]) != (2, cfg.L)
            or seqs.shape[0] < 1 or not seqs.is_contiguous()):
        raise ValueError(f"{who}: seqs must be a contiguous "
                         f"uint8[N, 2, {cfg.L}] on {fm.device}")
    if cfg.acap % 32 or cfg.acap < 32:
        raise ValueError(f"{who}: ACAP={cfg.acap} must be a multiple "
                         "of 32 (one warp per lane row)")
    blocks, shards = _check_index(fm)
    if shards.n and not split_ok:
        raise ValueError(f"{who}: takes a flat table, the index is split")
    return _SearchCfg(
        blocks=blocks, shards=shards, primary=fm.primary.data_ptr(),
        L2=fm.L2.data_ptr(), l2diff=fm.l2diff.data_ptr(),
        seqs=seqs.data_ptr(), seq_len=fm.seq_len, n_blk=fm.n_blk,
        n_reads=seqs.shape[0], intv=fm.intv, hcap=HCAP, max_seq=MAX_SEQ,
        e_unroll=E_UNROLL, state_m=STATE_M, state_i=STATE_I,
        state_d=STATE_D, state_e=STATE_E,
        **{f.name: int(getattr(cfg, f.name))
           for f in dataclasses.fields(cfg) if f.name != "NB"})


class _StepArgs(ctypes.Structure):
    """The launch arguments of `ibwa_search_steps`, field for field the
    struct IbwaStepArgs of csrc/search_step.cu: the 30 state tensors, the
    `_SearchCfg`, the lane and step counts."""

    _fields_ = ([(name, ctypes.c_void_p) for name in FIELDS]
                + [("c", _SearchCfg), ("B", ctypes.c_int),
                   ("n_steps", ctypes.c_int)])


def _check_state(who: str, cfg: EngineConfig, st: SearchState, dev) -> int:
    """Raise unless every field of `st` is the contiguous tensor on `dev`
    the kernels take; returns the lane count."""
    B = st.lens.shape[0]
    P = cfg.L + cfg.SL + 2
    shapes = {"sk": (B, cfg.acap), "sl": (B, cfg.acap), "sm1": (B, cfg.acap),
              "sm2": (B, cfg.acap), "key": (B, cfg.acap), "w": (B, 2, P),
              "bid": (B, 2, P), "meta": (B, 2, P), "hk": (B, HCAP),
              "hl": (B, HCAP), "hm": (B, HCAP), "it": ()}
    for name in FIELDS:
        _check_tensor(who, name, getattr(st, name), dev,
                      _STATE_DTYPES.get(name, I64), shapes.get(name, (B,)))
    return B


def _launch_search_steps(cfg: EngineConfig, fm: DeviceFmPair, seqs, st,
                         n_steps: int, stream: int) -> None:
    """Check the tensors the kernel is given (it takes nothing else) and
    launch `ibwa_search_steps` on them; `st` is updated in place."""
    B = _check_state("search_steps", cfg, st, fm.device)
    args = _StepArgs(
        **{name: getattr(st, name).data_ptr() for name in FIELDS},
        c=_search_cfg("search_steps", cfg, fm, seqs), B=B, n_steps=n_steps)
    rc = kernels.lib().ibwa_search_steps(ctypes.byref(args), stream)
    kernels.check(rc, "search_step")
    kernels.launches["search_step"] += 1


def search_steps(cfg: EngineConfig, fm: DeviceFmPair, seqs: torch.Tensor,
                 st: SearchState, n_steps: int,
                 cause: torch.Tensor | None = None) -> SearchState:
    """`n_steps` search steps of every lane.

    CPU tensors: `n_steps` calls of the plain `_search_step`.  CUDA
    tensors: one launch of the kernel `csrc/search_step.cu` (the step of
    `csrc/search_step.cuh` on a lane state kept in global memory between
    launches), which updates `st` in place; it expects what
    every state loaded or stepped by this module holds, `st.meta ==
    _pack_meta(st.w, st.bid)` and the pop fields of the lane's arena.
    `cause` (CPU tensors only): as `_search_step`'s; the kernel keeps
    none."""
    dev = fm.device
    if dev.type == "cpu":
        for _ in range(n_steps):
            st = _search_step(cfg, fm, seqs, st, cause)
        return st
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if cause is not None:
        raise ValueError("search_steps: the kernel keeps no fallback cause")
    _launch_search_steps(cfg, fm, seqs, st, n_steps,
                         torch.cuda.current_stream(dev).cuda_stream)
    return st


def _load_lanes(cfg: EngineConfig, st: SearchState, load, crid, lens,
                has_seed, max_diff0, big, seq_len: int) -> None:
    """Reset the lanes in `load` to the start of read `crid` (in place):
    the two strand roots in slots 0/1, the a=1 root (slot 1) popped
    first (engine_jax.py:800-844)."""
    col = load[:, None]
    st.lens = torch.where(load, lens[crid], st.lens)
    st.has_seed = torch.where(load, has_seed[crid], st.has_seed)
    md_new = max_diff0[crid]
    st.max_diff = torch.where(load, md_new, st.max_diff)
    l3 = load[:, None, None]
    st.w, st.bid, st.meta = (torch.where(l3, b[crid], p) for p, b in
                             zip((st.w, st.bid, st.meta), big))
    st.key = torch.where(col, INT32_MAX, st.key)
    zero = torch.zeros_like(st.lens)
    root = [_pack_m1(zero + STATE_M, zero + a, st.lens, zero)
            for a in (0, 1)]
    for s in (0, 1):
        for plane, v in ((st.key, MAX_SEQ - s), (st.sl, wrap_i32(seq_len)),
                         (st.sk, 0), (st.sm2, 0),
                         (st.sm1, wrap_i32(root[s]))):
            plane[:, s] = torch.where(load, v, plane[:, s]).to(plane.dtype)
    st.seqc = torch.where(load, 2, st.seqc)
    st.stack_n = torch.where(load, 2, st.stack_n)
    st.pslot = torch.where(load, 1, st.pslot)
    st.pkey = torch.where(load, MAX_SEQ - 1, st.pkey)
    st.pk = torch.where(load, 0, st.pk)
    st.pl = torch.where(load, seq_len, st.pl)
    st.pm1 = torch.where(load, root[1], st.pm1)
    st.pm2 = torch.where(load, 0, st.pm2)
    st.lane_it = torch.where(load, 0, st.lane_it)
    st.n_hits = torch.where(load, 0, st.n_hits)
    st.best_score = torch.where(
        load, (md_new + 1) * cfg.s_mm + (cfg.max_gapo + 1) * cfg.s_gapo
        + (cfg.max_gape + 1) * cfg.s_gape, st.best_score)
    st.best_cnt = torch.where(load, 0, st.best_cnt)


def _empty_lanes(cfg: EngineConfig, B: int, dev) -> SearchState:
    """Lane state "before the first read": rid = lane - B and every lane
    done, so the first switch phase loads read `lane` into lane `lane`.
    An empty arena with its pop (slot 0, a free key) and zero width planes
    with their meta, as a step would leave them.  No two fields share
    memory: the kernels update a state in place."""
    P = cfg.L + cfg.SL + 2

    def zeros(n, *shape, dt=I64):   # n distinct zero tensors, one fill
        return torch.zeros(n, *shape, dtype=dt, device=dev).unbind(0)

    (lane_it, stack_n, n_hits, best_score, best_cnt, max_diff, pslot, pk,
     pl, pm1, pm2) = zeros(11, B)
    sk, sl, sm1, sm2 = zeros(4, B, cfg.acap, dt=torch.int32)
    w, bid = zeros(2, B, 2, P)
    hk, hl, hm = zeros(3, B, HCAP)
    has_seed, fb = zeros(2, B, dt=torch.bool)
    full = lambda v: torch.full((B,), v, dtype=I64, device=dev)
    return SearchState(
        rid=torch.arange(B, device=dev) - B, lens=full(1), has_seed=has_seed,
        lane_it=lane_it, sk=sk, sl=sl, sm1=sm1, sm2=sm2,
        key=torch.full((B, cfg.acap), INT32_MAX, dtype=torch.int32,
                       device=dev),
        seqc=full(2), stack_n=stack_n, w=w, bid=bid, meta=_pack_meta(w, w),
        hk=hk, hl=hl, hm=hm, n_hits=n_hits, best_score=best_score,
        best_cnt=best_cnt, max_diff=max_diff, done=~fb, fb=fb,
        it=torch.zeros((), dtype=I64, device=dev),
        pslot=pslot, pkey=full(INT32_MAX), pk=pk, pl=pl, pm1=pm1, pm2=pm2)


class _SwitchArgs(ctypes.Structure):
    """The launch arguments of `ibwa_lane_switch`, field for field the
    struct IbwaSwitchArgs of csrc/lane_switch.cu: the 30 state tensors,
    the chunk's outputs and count of reads left, the per-read arrays and
    planes, then shapes and the constants of a root entry."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in FIELDS]
        + [(name, ctypes.c_void_p) for name in (
            "out_hm", "out_hk", "out_hl", "out_nh", "out_fb", "remaining",
            "read_lens", "read_max_diff", "read_has_seed", "read_bad",
            "big_w", "big_bid", "big_meta")]
        + [("seq_len", ctypes.c_int64)]
        + [(name, ctypes.c_int) for name in (
            "B", "N", "P", "acap", "hcap", "s_mm", "s_gapo", "s_gape",
            "max_gapo", "max_gape", "max_seq", "state_m")])


class _Chunk:
    """One chunk of N reads streaming through B persistent lanes: the
    lane state, the per-read planes and the output rows (engine_jax.
    _run_search_persistent's carry).

    big: the chunk's (w, bid, meta) planes int64[N, 2, P] (`big_planes`);
    lens / max_diff0 int64[N], has_seed / bad bool[N], all on fm's
    device."""

    def __init__(self, cfg: EngineConfig, fm: DeviceFmPair, big, lens,
                 max_diff0, has_seed, bad, n_lanes: int):
        self.cfg, self.fm, self.big = cfg, fm, tuple(big)
        self.lens, self.max_diff0 = lens, max_diff0
        self.has_seed, self.bad = has_seed, bad
        self.N, self.B = lens.shape[0], n_lanes
        dev = fm.device
        # outputs are indexed by rid mod Npad: a lane's rid stays congruent
        # to the lane mod B, so every lane owns distinct rows, and a lane
        # with nothing to flush rewrites its row unchanged (no dropped
        # scatter)
        self.npad = -(-self.N // self.B) * self.B
        self.out_h = [torch.zeros(self.npad, HCAP, dtype=I64, device=dev)
                      for _ in range(3)]      # hm, hk, hl
        self.out_nh = torch.zeros(self.npad, dtype=I64, device=dev)
        self.out_fb = torch.zeros(self.npad, dtype=torch.bool, device=dev)
        # the FB_* code of each lane's read and of each flushed read: the
        # plain switch and step keep them, the phased kernels do not
        self.cause = torch.zeros(self.B, dtype=I64, device=dev)
        self.out_cause = torch.zeros(self.npad, dtype=I64, device=dev)
        self.st = _empty_lanes(cfg, self.B, dev)
        self._bind_counters(torch.tensor([self.N, 0], dtype=I64,
                                         device=dev))

    def _bind_counters(self, sync: torch.Tensor) -> None:
        """The reads not yet flushed and the step count as the two words
        of one tensor, int64[2], which the kernels update in place, so
        that a phase ends in one copy to the host."""
        self.sync = sync
        self.remaining, self.st.it = sync[0], sync[1]

    def counters(self) -> tuple[int, int]:
        """(reads not yet flushed, steps so far): the sync with the
        device, one copy of `sync` on a CUDA device, where `switch` and
        `search_steps` update both words in place.  The plain switch and
        step rebind their counters and leave `sync` behind."""
        if self.fm.device.type == "cuda":
            left, steps = self.sync.tolist()
            return left, steps
        return int(self.remaining), int(self.st.it)

    def clone(self) -> "_Chunk":
        """A copy that shares the per-read inputs with `self` and no
        tensor that a switch or a step writes."""
        new = copy.copy(self)
        new.st = clone_state(self.st)
        new.out_h = [t.clone() for t in self.out_h]
        new.out_nh, new.out_fb = self.out_nh.clone(), self.out_fb.clone()
        new.cause, new.out_cause = self.cause.clone(), self.out_cause.clone()
        new._bind_counters(torch.stack([self.remaining, self.st.it]))
        return new

    def switch(self) -> None:
        """The switch phase: flush the finished lanes' hits to their
        reads' output rows and load their next read (or park them).

        CPU tensors: `switch_plain`.  CUDA tensors: one launch of the
        kernel `csrc/lane_switch.cu`, which updates the lane state, the
        output rows and the count of reads left in place."""
        dev = self.fm.device
        if dev.type == "cpu":
            return self.switch_plain()
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        self._launch_switch(torch.cuda.current_stream(dev).cuda_stream)

    def switch_plain(self) -> None:
        """Plain version of `switch` (it rebinds the state's fields and
        `remaining` to new tensors)."""
        st, N = self.st, self.N
        fin = st.done | st.fb
        valid = (st.rid >= 0) & (st.rid < N) & fin
        orow = torch.remainder(st.rid, self.npad)
        for out, src in zip(self.out_h, (st.hm, st.hk, st.hl)):
            out[orow] = torch.where(valid[:, None], src, out[orow])
        self.out_nh[orow] = torch.where(valid, st.n_hits, self.out_nh[orow])
        self.out_fb[orow] = torch.where(valid, st.fb, self.out_fb[orow])
        self.out_cause[orow] = torch.where(valid, self.cause,
                                           self.out_cause[orow])
        self.cause = torch.where(fin, 0, self.cause)
        self.remaining = self.remaining - valid.sum()
        st.rid = torch.where(fin, st.rid + self.B, st.rid)
        load = fin & (st.rid < N)
        park = fin & (st.rid >= N)
        crid = torch.clamp(st.rid, 0, N - 1)
        _load_lanes(self.cfg, st, load, crid, self.lens, self.has_seed,
                    self.max_diff0, self.big, self.fm.seq_len)
        st.done = torch.where(fin, park | (load & self.bad[crid]), st.done)
        st.fb = torch.where(fin, False, st.fb)

    def _launch_switch(self, stream: int) -> None:
        """Check the tensors the kernel is given and launch
        `ibwa_lane_switch` on them."""
        cfg, dev, N = self.cfg, self.fm.device, self.N
        B = _check_state("switch", cfg, self.st, dev)
        P = cfg.L + cfg.SL + 2
        named = {
            "out_hm": (self.out_h[0], I64, (self.npad, HCAP)),
            "out_hk": (self.out_h[1], I64, (self.npad, HCAP)),
            "out_hl": (self.out_h[2], I64, (self.npad, HCAP)),
            "out_nh": (self.out_nh, I64, (self.npad,)),
            "out_fb": (self.out_fb, torch.bool, (self.npad,)),
            "remaining": (self.remaining, I64, ()),
            "read_lens": (self.lens, I64, (N,)),
            "read_max_diff": (self.max_diff0, I64, (N,)),
            "read_has_seed": (self.has_seed, torch.bool, (N,)),
            "read_bad": (self.bad, torch.bool, (N,)),
            "big_w": (self.big[0], I64, (N, 2, P)),
            "big_bid": (self.big[1], I64, (N, 2, P)),
            "big_meta": (self.big[2], I64, (N, 2, P))}
        for name, (t, dtype, shape) in named.items():
            _check_tensor("switch", name, t, dev, dtype, shape)
        if B != self.B or N < 1 or cfg.acap < 2:
            raise ValueError(f"switch: {B} lanes for a chunk of {self.B}, "
                             f"{N} reads, ACAP {cfg.acap}")
        args = _SwitchArgs(
            **{name: getattr(self.st, name).data_ptr() for name in FIELDS},
            **{name: t.data_ptr() for name, (t, _, _) in named.items()},
            seq_len=self.fm.seq_len, B=B, N=N, P=P, acap=cfg.acap, hcap=HCAP,
            s_mm=cfg.s_mm, s_gapo=cfg.s_gapo, s_gape=cfg.s_gape,
            max_gapo=cfg.max_gapo, max_gape=cfg.max_gape, max_seq=MAX_SEQ,
            state_m=STATE_M)
        rc = kernels.lib().ibwa_lane_switch(ctypes.byref(args), stream)
        kernels.check(rc, "lane_switch")
        kernels.launches["lane_switch"] += 1


def _phased_loop(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens, max_diff0,
                 has_seed, seed_seqs, bad, n_lanes: int, plain: bool):
    """The persistent search as a loop of phases (arguments and result as
    `run_search_persistent`): a switch phase, SWITCH_K steps, one look at
    the two counters.  `plain`: every stage in its plain version whatever
    the device, else as the stage's entry point routes it (the phased
    kernels on a card keep no fallback cause: cause None)."""
    widths = big_planes_plain if plain else big_planes
    ch = _Chunk(cfg, fm, widths(cfg, fm, seqs, lens, has_seed, seed_seqs),
                lens, max_diff0, has_seed, bad, n_lanes)
    kept = plain or fm.device.type == "cpu"
    while True:
        if plain:
            ch.switch_plain()
            for _ in range(SWITCH_K):
                ch.st = _search_step(cfg, fm, seqs, ch.st, ch.cause)
            left, steps = int(ch.remaining), int(ch.st.it)
        else:
            ch.switch()
            ch.st = search_steps(cfg, fm, seqs, ch.st, SWITCH_K,
                                 cause=ch.cause if kept else None)
            left, steps = ch.counters()  # sync
        if left <= 0 or steps >= MAX_ITERS * 8:
            break
    N = ch.N
    out_fb = ch.out_fb[:N] | (left > 0)  # iteration bound: all fall back
    hits = torch.stack(ch.out_h, dim=-1)[:N]
    cause = (torch.where(out_fb & (ch.out_cause[:N] == 0), FB_BOUND,
                         ch.out_cause[:N]) if kept else None)
    return hits, ch.out_nh[:N], out_fb, steps, cause


def run_search_phased(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens,
                      max_diff0, has_seed, seed_seqs, bad, n_lanes: int):
    """The persistent search as engine_jax._run_search_persistent runs it:
    every SWITCH_K steps a switch phase flushes the finished lanes' hits
    and loads their next read, then one sync with the host.  Arguments and
    result as `run_search_persistent`; beyond `n_hits` a read's hit row
    holds the stale words of its lane.  On CPU tensors this is the plain
    version of `search_chunk`; on CUDA tensors every phase is one
    `lane_switch` and one `search_steps` launch, and the result's cause is
    None (those kernels keep none)."""
    return _phased_loop(cfg, fm, seqs, lens, max_diff0, has_seed, seed_seqs,
                        bad, n_lanes, plain=False)


def run_search_plain(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens,
                     max_diff0, has_seed, seed_seqs, bad, n_lanes: int):
    """Plain version of `search_chunk` with `big_planes_plain` before it,
    on any device: the phased loop over the plain width pass, switch and
    step.  What the kernels are held against on the card."""
    return _phased_loop(cfg, fm, seqs, lens, max_diff0, has_seed, seed_seqs,
                        bad, n_lanes, plain=True)


def masked_hits(hits, n_hits, fb):
    """The part of a search's hit planes that is its result: the rows of
    the reads not routed to the host, below their hit count; the rest
    zeroed.  hits int64[N, HCAP, 3]."""
    keep = ((torch.arange(hits.shape[1], device=hits.device)[None, :]
             < n_hits[:, None]) & ~fb[:, None])
    return torch.where(keep[:, :, None], hits, 0)


def chunk_schedule(iters, bad, n_lanes: int, switch_k: int,
                   bound: int = MAX_ITERS * 8) -> tuple[int, np.ndarray]:
    """The phased loop over a chunk, from each read's own iterations: its
    step count, and which reads it flushes before its iteration bound.

    iters int[N]: the iteration of read r (1-based, counted from its load)
    in which its `done` / `fb` flag is set; bad bool[N]: reads that are
    done when loaded (their `iters` is not read).  Lane b takes reads b,
    b + n_lanes, ...; a read loaded at clock t is flushed by the first
    switch that sees its flag, at t + switch_k * max(1, ceil(iters /
    switch_k)), where the lane's next read is loaded.  The loop runs the
    steps of the phase whose switch flushed the last read, and no phase
    from `bound` steps on: a read whose flush would fall there is never
    flushed, and the loop ends at the bound.  Returns (steps, flushed
    bool[N])."""
    j = np.where(np.asarray(bad), 0, np.asarray(iters, dtype=np.int64))
    phases = np.maximum(1, -(-j // switch_k))
    pad = -len(j) % n_lanes
    flush = (np.cumsum(np.concatenate([phases, np.zeros(pad, np.int64)])
                       .reshape(-1, n_lanes), axis=0).reshape(-1)[:len(j)]
             * switch_k)
    t_end = -(-bound // switch_k) * switch_k
    flushed = flush < t_end
    if not flushed.all():
        return t_end, flushed
    return int(flush.max()) + switch_k, flushed


def chunk_steps(iters, bad, n_lanes: int, switch_k: int,
                bound: int = MAX_ITERS * 8) -> int:
    """The step count of the phased loop over a chunk (`chunk_schedule`'s
    first half)."""
    return chunk_schedule(iters, bad, n_lanes, switch_k, bound)[0]


class _ChunkArgs(ctypes.Structure):
    """The launch arguments of `ibwa_search_chunk`, field for field the
    struct IbwaChunkArgs of csrc/search_chunk.cu: the chunk's outputs,
    counters and stage clocks, the per-read arrays and planes, the
    `_SearchCfg`, a read's iteration cap, the read count and a cap on the
    grid."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "out_hm", "out_hk", "out_hl", "out_nh", "out_fb", "out_it",
            "out_cause", "counters", "prof", "read_lens", "read_max_diff",
            "read_has_seed", "read_bad", "big_w", "big_bid", "big_meta")]
        + [("c", _SearchCfg), ("it_cap", ctypes.c_int64),
           ("N", ctypes.c_int), ("max_blocks", ctypes.c_int)])


# search_chunk's counters, as its source lists them
COUNTERS = ("taken", "flushed", "longest_lane", "iterations", "rows",
            *FB_CAUSES[:4], "e_fetches")
N_COUNTERS = len(COUNTERS)
# the step's stages the profiling mode clocks, as search_step.cuh's kSt*
STAGES = ("decode", "occ4", "hits", "e_chain", "children", "prefetch",
          "commit")
N_STAGES = len(STAGES)


def _it_cap() -> int:
    """The phased loop's iteration bound, rounded up to a phase: no read
    runs further (K8's cap on a read's iterations)."""
    return -(-(MAX_ITERS * 8) // SWITCH_K) * SWITCH_K


def _chunk_args(cfg: EngineConfig, fm: DeviceFmPair, seqs, big, lens,
                max_diff0, has_seed, bad, outs: dict, max_blocks: int = 0):
    """Check the tensors a K8 launch is given and build its `_ChunkArgs`;
    `outs` maps the output fields to their tensors (zero on entry)."""
    dev, N = fm.device, lens.shape[0]
    P = cfg.L + cfg.SL + 2
    named = {
        "read_lens": (lens, I64, (N,)),
        "read_max_diff": (max_diff0, I64, (N,)),
        "read_has_seed": (has_seed, torch.bool, (N,)),
        "read_bad": (bad, torch.bool, (N,)),
        "big_w": (big[0], I64, (N, 2, P)),
        "big_bid": (big[1], I64, (N, 2, P)),
        "big_meta": (big[2], I64, (N, 2, P))}
    for name, (t, dtype, shape) in named.items():
        _check_tensor("search_chunk", name, t, dev, dtype, shape)
    if seqs.shape[0] != N or N < 1:
        raise ValueError(f"search_chunk: {N} reads, {seqs.shape[0]} rows of "
                         "bases")
    return _ChunkArgs(
        **{name: t.data_ptr() for name, (t, _, _) in named.items()},
        **{name: (t.data_ptr() if t is not None else None)
           for name, t in outs.items()},
        c=_search_cfg("search_chunk", cfg, fm, seqs, split_ok=True),
        it_cap=_it_cap(), N=N, max_blocks=max_blocks)


def _launch_search_chunk(cfg: EngineConfig, fm: DeviceFmPair, seqs, big,
                         lens, max_diff0, has_seed, bad, stream: int,
                         mode: int = 1, max_blocks: int = 0):
    """Allocate K8's outputs and launch `ibwa_search_chunk` on them.
    `mode` 1 is the step the engine runs; 0 is the same step without the
    next pop's rows asked for ahead, and 2 the same with its stages'
    clocks kept, which only a measurement calls for.  `max_blocks` > 0
    caps the grid (the tests' and the profile's), else it is every block
    the card holds.

    Returns (out_h int64[3, N, HCAP] as (meta, k, l) planes, n_hits
    int64[N], fb bool[N], it int32[N], cause int32[N], counters
    int64[N_COUNTERS]) and, in mode 2, the stage clocks int64[lanes,
    N_STAGES] after them."""
    dev, N = fm.device, lens.shape[0]
    out_h = torch.zeros(3, N, HCAP, dtype=I64, device=dev)   # hm, hk, hl
    outs = {"out_hm": out_h[0], "out_hk": out_h[1], "out_hl": out_h[2],
            "out_nh": torch.zeros(N, dtype=I64, device=dev),
            "out_fb": torch.zeros(N, dtype=torch.bool, device=dev),
            "out_it": torch.zeros(N, dtype=torch.int32, device=dev),
            "out_cause": torch.zeros(N, dtype=torch.int32, device=dev),
            "counters": torch.zeros(N_COUNTERS, dtype=I64, device=dev),
            "prof": None}
    if mode == 2:
        lanes = search_chunk_shape(cfg, fm, seqs, big, lens, max_diff0,
                                   has_seed, bad, mode, max_blocks)["lanes"]
        outs["prof"] = torch.zeros(lanes, N_STAGES, dtype=I64, device=dev)
    args = _chunk_args(cfg, fm, seqs, big, lens, max_diff0, has_seed, bad,
                       outs, max_blocks)
    name = "search_chunk_sharded" if args.c.shards.n else "search_chunk"
    rc = kernels.lib().ibwa_search_chunk(ctypes.byref(args), mode, stream)
    kernels.check(rc, name)
    kernels.launches[name] += 1
    got = (out_h, outs["out_nh"], outs["out_fb"], outs["out_it"],
           outs["out_cause"], outs["counters"])
    return got + (outs["prof"],) if mode == 2 else got


def search_chunk_shape(cfg: EngineConfig, fm: DeviceFmPair, seqs, big, lens,
                       max_diff0, has_seed, bad, mode: int = 1,
                       max_blocks: int = 0) -> dict:
    """The launch `_launch_search_chunk` makes on these inputs, launching
    nothing: blocks an SM (the occupancy the card reports at this arena
    size), SMs, blocks, lanes and shared bytes a block."""
    args = _chunk_args(cfg, fm, seqs, big, lens, max_diff0, has_seed, bad,
                       {}, max_blocks)
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib().ibwa_search_chunk_shape(
        ctypes.byref(args), mode, out), "search_chunk_shape")
    per_sm, sms, grid, smem = list(out)
    return {"blocks_per_sm": per_sm, "sms": sms, "blocks": grid,
            "lanes": grid * 4, "smem": smem}


class _ChunkFirstArgs(ctypes.Structure):
    """The launch arguments of `ibwa_search_chunk_first`, field for field
    the struct IbwaChunkFirstArgs of csrc/search_chunk_first.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "out_hm", "out_hk", "out_hl", "out_nh", "out_fb", "counters",
            "read_lens", "read_max_diff", "read_has_seed", "read_bad",
            "big_w", "big_bid", "big_meta")]
        + [("c", _SearchCfg), ("t_end", ctypes.c_int64)]
        + [(name, ctypes.c_int) for name in ("B", "N", "switch_k")]
        + [("prof", ctypes.c_void_p)])


def _launch_search_chunk_first(cfg: EngineConfig, fm: DeviceFmPair, seqs,
                               big, lens, max_diff0, has_seed, bad,
                               n_lanes: int, stream: int, mode: int = 1):
    """K8's first version (`csrc/search_chunk_first.cu`: lane b takes
    reads b, b + n_lanes, ...), which nothing but a measurement beside the
    redesign launches; `mode` as `_launch_search_chunk`'s.  Returns
    (out_h, n_hits, fb, counters int64[5]: reads left, steps, the longest
    lane's iterations, all iterations, FM rows), the step count the
    kernel's own clock, and in mode 2 the stage clocks int64[n_lanes,
    N_STAGES] after them."""
    dev, N = fm.device, lens.shape[0]
    out_h = torch.zeros(3, N, HCAP, dtype=I64, device=dev)
    out_nh = torch.zeros(N, dtype=I64, device=dev)
    out_fb = torch.zeros(N, dtype=torch.bool, device=dev)
    counters = torch.zeros(5, dtype=I64, device=dev)
    counters[:1].fill_(N)
    prof = (torch.zeros(n_lanes, N_STAGES, dtype=I64, device=dev)
            if mode == 2 else None)
    cfg_args = _chunk_args(cfg, fm, seqs, big, lens, max_diff0, has_seed,
                           bad, {})
    args = _ChunkFirstArgs(
        out_hm=out_h[0].data_ptr(), out_hk=out_h[1].data_ptr(),
        out_hl=out_h[2].data_ptr(), out_nh=out_nh.data_ptr(),
        out_fb=out_fb.data_ptr(), counters=counters.data_ptr(),
        **{name: getattr(cfg_args, name) for name in (
            "read_lens", "read_max_diff", "read_has_seed", "read_bad",
            "big_w", "big_bid", "big_meta")},
        c=cfg_args.c, t_end=_it_cap(), B=n_lanes, N=N, switch_k=SWITCH_K,
        prof=prof.data_ptr() if prof is not None else None)
    rc = kernels.lib().ibwa_search_chunk_first(ctypes.byref(args), mode,
                                               stream)
    kernels.check(rc, "search_chunk_first")
    kernels.launches["search_chunk_first"] += 1
    got = (out_h, out_nh, out_fb, counters)
    return got + (prof,) if mode == 2 else got


def search_chunk(cfg: EngineConfig, fm: DeviceFmPair, seqs, big, lens,
                 max_diff0, has_seed, bad):
    """The whole persistent search of a chunk over its width planes `big`
    (`big_planes`), in ONE launch of the kernel `csrc/search_chunk.cu` (its
    sharded instantiation, B8, when the table is split): every lane the
    card holds takes reads from a queue.  CUDA tensors only (the plain
    version is the phased loop, `run_search_phased`).  THE THREE PLANES OF
    `big` ARE UPDATED IN PLACE: a lane works on its read's rows where they
    are, so a second search needs them computed again.

    Returns `_launch_search_chunk`'s (out_h, n_hits, fb, it, cause,
    counters), all on the card: nothing here waits for the kernel.  Beyond
    `n_hits` a hit row is zero; `it` is each read's own iteration count,
    from which `chunk_schedule` gives the phased loop's step count."""
    dev = fm.device
    if dev.type != "cuda":
        raise ValueError(f"search_chunk: unsupported device {dev}")
    return _launch_search_chunk(
        cfg, fm, seqs, big, lens, max_diff0, has_seed, bad,
        torch.cuda.current_stream(dev).cuda_stream)


def launch_search(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens,
                  max_diff0, has_seed, seed_seqs, bad, n_lanes: int):
    """The first half of `run_search_persistent`: start the search of a
    chunk and return (hits, n_hits, fb, steps or it, cause, n_lanes) for
    `collect_search`.

    CUDA tensors: `big_planes` (one launch) and `search_chunk` (one
    launch), whose outputs these are, `it` its reads' iteration counts on
    the card; nothing here waits for the card.  CPU tensors: the phased
    loop, `run_search_phased`, done when this returns, with its steps."""
    dev = fm.device
    if dev.type == "cpu":
        return (*run_search_phased(cfg, fm, seqs, lens, max_diff0, has_seed,
                                   seed_seqs, bad, n_lanes), n_lanes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    big = big_planes(cfg, fm, seqs, lens, has_seed, seed_seqs)
    out_h, n_hits, fb, it, cause, _ = search_chunk(
        cfg, fm, seqs, big, lens, max_diff0, has_seed, bad)
    return out_h.permute(1, 2, 0), n_hits, fb, it, cause, n_lanes


def finish_chunk(hits, n_hits, fb, it, cause, n_lanes: int):
    """K8's outputs as the phased loop over `n_lanes` lanes gives them
    (`run_search_persistent`'s result): its step count from the reads' own
    iterations (`chunk_schedule`; the copy of `it` to the host waits for
    the kernel), and where the loop's iteration bound cuts it, every read
    to the host search and the reads it would not have flushed with no
    hits and no cause; then FB_BOUND for every read at the host without
    one."""
    steps, flushed = chunk_schedule(it.cpu().numpy(),
                                    np.zeros(it.shape[0], bool), n_lanes,
                                    SWITCH_K, MAX_ITERS * 8)
    cause = cause.to(I64)
    if not flushed.all():
        keep = torch.from_numpy(flushed).to(n_hits.device)
        n_hits = torch.where(keep, n_hits, 0)
        cause = torch.where(keep, cause, 0)
        fb = torch.ones_like(fb)
    cause = torch.where(fb & (cause == 0), FB_BOUND, cause)
    return hits, n_hits, fb, steps, cause


def collect_search(launched):
    """The second half of `run_search_persistent`: finish a
    `launch_search` (on CUDA tensors `finish_chunk`, whose copy to the host
    is the chunk's only sync).  Returns (hits, n_hits, fb, steps, cause) as
    `run_search_persistent`."""
    if torch.is_tensor(launched[3]):
        return finish_chunk(*launched)
    return launched[:5]


def run_search_persistent(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens,
                          max_diff0, has_seed, seed_seqs, bad,
                          n_lanes: int):
    """Persistent-lane scheduler (engine_jax._run_search_persistent) over
    n_lanes lanes: lane b takes reads b, b + B, ...; a lane whose read is
    done, or routed to the host search, flushes its hits and loads its
    next read.  That schedule gives the result's step count; on a card the
    search itself runs on every lane the card holds (`search_chunk`).

    seqs uint8[N, 2, L], seed_seqs uint8[N, 2, SL], lens / max_diff0
    int64[N], has_seed / bad bool[N], all on fm's device.  Returns (hits
    int64[N, HCAP, 3] as (meta, k, l), n_hits int64[N], fb bool[N],
    steps, cause int64[N], each read's FB_* code); `hits[r, n_hits[r]:]`
    is not part of the result.

    `launch_search` then `collect_search`.  CPU tensors: the phased loop,
    `run_search_phased`.  CUDA tensors: `big_planes` (one launch),
    `search_chunk` (one launch), then one copy of the reads' iteration
    counts to the host, the only sync."""
    return collect_search(launch_search(cfg, fm, seqs, lens, max_diff0,
                                        has_seed, seed_seqs, bad, n_lanes))


def clone_state(st: SearchState) -> SearchState:
    """A copy that shares no tensor with `st` (a CUDA step updates its
    state in place, and the plain step the hit planes)."""
    return SearchState(**{name: getattr(st, name).clone()
                          for name in FIELDS})


def _plain_chunk(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens, max_diff0,
                 has_seed, seed_seqs, bad, n_lanes: int) -> _Chunk:
    """A chunk over the planes of the plain width pass: where the runs
    start that the kernels are held against."""
    return _Chunk(cfg, fm, big_planes_plain(cfg, fm, seqs, lens, has_seed,
                                            seed_seqs),
                  lens, max_diff0, has_seed, bad, n_lanes)


def switch_cases(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens, max_diff0,
                 has_seed, seed_seqs, bad, n_lanes: int
                 ) -> list[tuple[str, _Chunk]]:
    """Chunks to hold `_Chunk.switch` against the plain switch on: (name,
    chunk as it stands just before a switch phase), from one run of the
    persistent search with the plain width pass, switch and step (inputs
    as `run_search_persistent`; N > n_lanes, so that lanes reload).

      `first`: the lanes before their first read, every lane loads;
      `mid`: the first later phase in which some lanes have finished and
      others have not; every fifth lane still searching is marked for the
      host search (fb), as a capacity overflow would leave it;
      `park`: the first phase in which a finished lane has no read left;
      `last`: the switch that flushes the chunk's last read, the other
      lanes parked already;
      `bad`: `first` over reads of which every third has too many Ns, so
      its lane loads it finished;
      `none`: `mid` with no lane finished: nothing may change;
      `all`: `mid` with every lane finished at once;
      `tail`: `first` over fewer reads than lanes (three quarters), the
      other lanes park at once."""
    ch = _plain_chunk(cfg, fm, seqs, lens, max_diff0, has_seed, seed_seqs,
                      bad, n_lanes)
    cases = {"first": ch.clone()}
    while True:
        ch.switch_plain()
        for _ in range(SWITCH_K):
            ch.st = _search_step(cfg, fm, seqs, ch.st)
        st = ch.st
        fin = st.done | st.fb
        left = int(ch.remaining - (fin & (st.rid < ch.N)).sum())
        if "mid" not in cases and bool(fin.any()) and not bool(fin.all()):
            mid = ch.clone()
            busy = torch.nonzero(~fin)[::5, 0]
            mid.st.fb[busy] = True
            cases["mid"] = mid
        if "park" not in cases and bool((fin & (st.rid < ch.N)
                                         & (st.rid + ch.B >= ch.N)).any()):
            cases["park"] = ch.clone()
        if left <= 0 or int(st.it) >= MAX_ITERS * 8:
            cases["last"] = ch.clone()
            break
    missing = {"mid", "park"} - set(cases)
    if missing:
        raise ValueError(f"switch_cases: the run never reached {missing}")

    with_bad = cases["first"].clone()
    with_bad.bad = bad.clone()
    with_bad.bad[::3] = True
    none = cases["mid"].clone()
    none.st.done = torch.zeros_like(none.st.done)
    none.st.fb = torch.zeros_like(none.st.fb)
    every = cases["mid"].clone()
    every.st.done = torch.ones_like(every.st.done)
    n_tail = n_lanes - n_lanes // 4
    tail = _Chunk(cfg, fm, [b[:n_tail].contiguous() for b in ch.big],
                  lens[:n_tail].contiguous(), max_diff0[:n_tail].contiguous(),
                  has_seed[:n_tail].contiguous(), bad[:n_tail].contiguous(),
                  n_lanes)
    cases.update(bad=with_bad, none=none, all=every, tail=tail)
    return [(name, cases[name]) for name in (
        "first", "mid", "park", "last", "bad", "none", "all", "tail")]


def step_cases(cfg: EngineConfig, fm: DeviceFmPair, seqs, lens, max_diff0,
               has_seed, seed_seqs, bad, n_lanes: int,
               phases: tuple[int, ...] = (0, 2, 5)
               ) -> list[tuple[str, EngineConfig, torch.Tensor, SearchState]]:
    """States to hold `search_steps` against the plain step on: (name,
    config, seqs, state) from one run of the persistent search with the
    plain width pass, switch and step over the chunk (inputs as
    `run_search_persistent`).

    `phase<p>`: the lanes as switch phase p left them, before its
    SWITCH_K steps (phase 0: every lane at the root of its first read;
    later ones: lanes mid-search, finished, reloaded and parked).  From
    the last of them, states a search reaches too rarely to wait for, or
    never, each a few steps away from an edge of the step:
      `hovf`: the hit planes full, so the next hit goes to the host;
      `seq_ovf`: the push counter three short of the seqno field;
      `arena`: three free arena slots left (the rest hold entries of the
      worst key, never popped before the real ones);
      `dup`: every lane's popped entry turned into a gapped hit of an
      interval its hit planes already hold;
      `n_bases`: the width planes zeroed (no D(i) pruning) and every
      third base of the reads an N, so exact-extension chains run into
      bases that are no base;
      `iter_cap`: a config whose step budget ends inside the phase."""
    ch = _plain_chunk(cfg, fm, seqs, lens, max_diff0, has_seed, seed_seqs,
                      bad, n_lanes)
    cases = []
    for p in range(max(phases) + 1):
        ch.switch_plain()
        if p in phases:
            cases.append((f"phase{p}", cfg, seqs, clone_state(ch.st)))
        for _ in range(SWITCH_K):
            ch.st = _search_step(cfg, fm, seqs, ch.st)
    base = cases[-1][3]
    rows = torch.arange(n_lanes, device=fm.device)

    hovf = clone_state(base)
    hovf.n_hits = torch.full_like(base.n_hits, HCAP)
    seq_ovf = clone_state(base)
    seq_ovf.seqc = torch.full_like(base.seqc, MAX_SEQ - 3)

    arena = clone_state(base)
    free = arena.key == INT32_MAX
    fill = (free & (torch.cumsum(free.to(I64), dim=1) > 3)
            & ~free.all(dim=1, keepdim=True))   # an empty arena stays so
    arena.key = torch.where(fill, INT32_MAX - 1, arena.key)
    arena.stack_n = arena.stack_n + fill.sum(dim=1)

    dup = clone_state(base)   # the pop and its arena slot: i = 0, gapo = 1
    dup.pm1 = base.pm1 & ~(0x1FFF << 3)
    dup.pm2 = torch.full_like(base.pm2, 1 << 8)
    dup.sm1[rows, dup.pslot] = wrap_i32(dup.pm1).to(torch.int32)
    dup.sm2[rows, dup.pslot] = dup.pm2.to(torch.int32)
    dup.hk[:, 0], dup.hl[:, 0] = dup.pk, dup.pl
    dup.n_hits = torch.clamp(base.n_hits, min=1)

    n_bases = clone_state(base)
    n_bases.w = torch.zeros_like(base.w)
    n_bases.bid = torch.zeros_like(base.bid)
    n_bases.meta = _pack_meta(n_bases.w, n_bases.bid)
    seqs_n = seqs.clone()
    seqs_n[:, :, 1::3] = 4

    capped = dataclasses.replace(cfg, iter_cap=int(base.lane_it.max()) + 3)
    return cases + [
        ("hovf", cfg, seqs, hovf), ("seq_ovf", cfg, seqs, seq_ovf),
        ("arena", cfg, seqs, arena), ("dup", cfg, seqs, dup),
        ("n_bases", cfg, seqs_n, n_bases),
        ("iter_cap", capped, seqs, clone_state(base))]


def batch_config(seqs: list[np.ndarray], opt: GapOpt, seq_len: int,
                 device_type: str = "cpu"):
    """The search parameters of a read batch on a device of
    `device_type` and its per-read lengths and diff budgets (int64[n]):
    bwa_cal_sa_reg_gap's preamble (bwtaln.c:80-100)."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    batch_opt = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        batch_opt.max_diff = cal_maxdiff(int(lens.max()), thres=opt.fnr)
        md_by_len = {int(n): cal_maxdiff(int(n), thres=opt.fnr)
                     for n in np.unique(lens)}
        max_diff = np.array([md_by_len[int(n)] for n in lens],
                            dtype=np.int64)
    else:
        max_diff = np.full(len(seqs), batch_opt.max_diff, dtype=np.int64)
    if batch_opt.max_diff < batch_opt.max_gapo:
        batch_opt.max_gapo = batch_opt.max_diff
    L = int(max(8, (int(lens.max()) + 7) // 8 * 8))
    cfg = make_config(L, int(max_diff.max()), batch_opt, seq_len=seq_len,
                      device_type=device_type)
    return cfg, lens, max_diff


def devices_of(spec) -> list[torch.device]:
    """The devices a device argument names: a torch.device or a name, a
    list of them, or a comma list of names ("cuda:0,cuda:1"); "cuda"
    without an index is every visible card, as the JAX engine takes
    jax.devices().  A card may be named more than once."""
    if isinstance(spec, str):
        names = [n.strip() for n in spec.split(",") if n.strip()]
    elif isinstance(spec, torch.device):
        names = [spec]
    else:
        names = list(spec)
    out = []
    for name in names:
        dev = torch.device(name)
        if dev.type == "cuda" and dev.index is None:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError("no CUDA device is visible")
            out += [torch.device("cuda", i) for i in range(count)]
        else:
            out.append(dev)
    if not out:
        raise ValueError(f"no device named in {spec!r}")
    return out


def entry_streams(dfms: list[DeviceFmPair]) -> list:
    """A stream for each of several entries on cards, so that two entries
    on one card run side by side; a single entry, or one on the CPU, runs
    on the current stream (None)."""
    return [torch.cuda.Stream(device=d.device)
            if len(dfms) > 1 and d.device.type == "cuda" else None
            for d in dfms]


@contextlib.contextmanager
def on_stream(st):
    """`st` and its card current; nothing where `st` is None."""
    if st is None:
        yield
        return
    with torch.cuda.device(st.device), torch.cuda.stream(st):
        yield


def first_host_share(device_type: str) -> float:
    """The host share of an engine's first batch on a device of
    `device_type`: IBWA_HOST_FRAC where it is set (a fixed share), else
    CARD_HOST_FRAC_INIT on a card and HOST_FRAC_INIT on the CPU."""
    return float(os.environ.get("IBWA_HOST_FRAC", CARD_HOST_FRAC_INIT
                                if device_type == "cuda" else HOST_FRAC_INIT))


class TorchAlnEngine:
    """Batched device search with native-host overflow fallback and the
    hybrid host share (engine_jax.JaxAlnEngine over torch devices).

    `device` names one device or several (`devices_of`).  Several: each
    chunk is PERSIST_N reads per entry and entry d searches its contiguous
    PERSIST_N slice (engine_jax.py:1061-1110 and mesh.py's `dp` split;
    the tail at its own size, entries past its end idle), each entry's
    launches on a stream of its own, every entry's chunk launched before
    any is collected, and the chunks collected and decoded in read order.
    With `n_idx` > 1 the devices are groups of n_idx (make_mesh_2d's
    order): a group is one entry, whose table is split by rows over the
    group (`shard_pair`, B8) and whose chunks run on the group's first
    device.  Otherwise every entry holds its own copy of the table, the
    same card named twice too.

    `spans` records the engine's spans (a `spans.Recorder`; one of its own
    where none is given): `aln.engine_init` with `aln.table_build` and
    `aln.table_upload`; a batch's `aln.pack`, `aln.launch` (with
    `kernels.load` on a card), `aln.collect` and `aln.decode` a chunk,
    `aln.host_wait`, and on the pool's thread `aln.host_search` a
    host-share job and `aln.fallback_search` an overflow job."""

    def __init__(self, fms: tuple[FmIndex, FmIndex], device, n_idx: int = 1,
                 spans: Recorder | None = None):
        self.fms = fms
        self.spans = spans if spans is not None else Recorder()
        # `batches`: one record a batch (its reads, host share, overflow
        # fallback, its split by cause, and arena size), in the order the
        # batches came; `fallback_by_cause` the split over all batches;
        # `h2d_bytes` / `d2h_bytes` what the table upload and the packing
        # copy to cards / the collection copies back, `chunks` launched
        self.stats = {"device_reads": 0, "fallback_reads": 0,
                      "host_reads": 0, "iterations": 0,
                      "fallback_by_cause": dict.fromkeys(FB_CAUSES, 0),
                      "batches": [], "h2d_bytes": 0, "d2h_bytes": 0,
                      "chunks": 0}
        with self.spans.span("aln.engine_init"):
            devs = devices_of(device)
            if n_idx < 1 or len(devs) % n_idx:
                raise ValueError(f"{len(devs)} devices do not make groups "
                                 f"of n_idx={n_idx}")
            groups = [devs[i:i + n_idx] for i in range(0, len(devs), n_idx)]
            with self.spans.span("aln.table_build"):
                base = build_device_pair(fms[0], fms[1], "cpu")
            # the first entry on the CPU keeps the table it was built in (no
            # copy of a table that may be gigabytes); every other is a copy
            with self.spans.span("aln.table_upload"):
                self.dfms = [shard_pair(base, g) if n_idx > 1
                             else base if i == 0 and g[0].type == "cpu"
                             else pair_to(base, g[0])
                             for i, g in enumerate(groups)]
                self.streams = entry_streams(self.dfms)
            self.dfm, self.device = self.dfms[0], self.dfms[0].device
            self.stats["h2d_bytes"] = sum(
                t.nbytes for d in self.dfms for t in (
                    *(d.shards or (d.blocks,)), d.L2, d.l2diff, d.primary)
                if t.device.type == "cuda")
        self.host_frac = first_host_share(self.device.type)
        # an explicit env share is FIXED (no adaptation)
        self._frac_fixed = "IBWA_HOST_FRAC" in os.environ
        # one worker: native jobs (host share, then overflow fallback) run
        # one at a time on one host thread, beside the device search
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def align_batch(self, seqs: list[np.ndarray], rseqs: list[np.ndarray],
                    opt: GapOpt) -> list[list[Hit]]:
        """bwa_cal_sa_reg_gap semantics over a read batch (bwtaln.c:80-140);
        per-read hit lists identical to engine_ref.align_batch."""
        if not seqs:
            return []
        n_reads = len(seqs)
        cfg, lens, max_diff = batch_config(seqs, opt, self.dfm.seq_len,
                                           self.device.type)
        L, SL = cfg.L, cfg.SL
        out: list[list[Hit] | None] = [None] * n_reads

        # ---- hybrid: a share of the batch goes straight to the native
        # search in the background pool while the device runs the rest
        if self.host_frac >= 0.999:
            n_host = n_reads
        else:
            n_host = (int(n_reads * self.host_frac) if n_reads > HYBRID_MIN
                      else 0)
        host_lo = n_reads - n_host
        bno = len(self.stats["batches"])
        t_start = time.perf_counter()

        host_jobs = []
        for lo in range(host_lo, n_reads, HOST_CHUNK):
            hi = min(lo + HOST_CHUNK, n_reads)
            host_jobs.append((lo, self._pool.submit(
                self._native_job, "aln.host_search", bno, seqs[lo:hi],
                rseqs[lo:hi], opt)))

        # ---- vectorized input packing of the device share, uploaded at
        # once to each device that launches chunks: an upload from pageable
        # memory waits for the stream, so one between two chunks would wait
        # for the chunk before
        with self.spans.span("aln.pack", bno):
            packed = _pack_reads(seqs[:host_lo], rseqs[:host_lo],
                                 lens[:host_lo], max_diff[:host_lo], L, SL,
                                 opt.seed_len)
            host_arrays = (*packed, lens[:host_lo], max_diff[:host_lo])
            inputs = {}
            for dfm in self.dfms:
                if dfm.device not in inputs:
                    inputs[dfm.device] = [torch.from_numpy(a).to(dfm.device)
                                          for a in host_arrays]
                    if dfm.device.type == "cuda":
                        self.stats["h2d_bytes"] += sum(a.nbytes
                                                       for a in host_arrays)
            for dfm, st in zip(self.dfms, self.streams):
                if st is not None:
                    st.wait_stream(torch.cuda.current_stream(dfm.device))

        # ---- every chunk of the device share, on every entry, is launched
        # before the first is read back (engine_jax.py:1061-1102), so the
        # cards run on while the host downloads and decodes; eager torch
        # has no compiled shapes: the tail chunk runs at its own size (no
        # padding reads), on no more lanes than reads
        n_dev = len(self.dfms)
        pending = []
        with self.spans.span("aln.launch", bno):
            if any(d.device.type == "cuda" for d in self.dfms):
                with self.spans.span("kernels.load"):
                    kernels.lib()
            for lo in range(0, host_lo, PERSIST_N * n_dev):
                hi = min(lo + PERSIST_N * n_dev, host_lo)
                parts = []
                for d in range(min(n_dev, -(-(hi - lo) // PERSIST_N))):
                    a, b = (lo + d * PERSIST_N,
                            min(lo + (d + 1) * PERSIST_N, hi))
                    sq, ssq, hs, bad, dl, md = inputs[self.dfms[d].device]
                    with on_stream(self.streams[d]):
                        parts.append((a, d, launch_search(
                            cfg, self.dfms[d], sq[a:b], dl[a:b], md[a:b],
                            hs[a:b], ssq[a:b], bad[a:b],
                            n_lanes=min(DEV_BATCH, b - a))))
                    self.stats["chunks"] += 1
                pending.append(parts)

        fb_jobs = []
        n_fb = 0
        by_cause = np.zeros(len(FB_CAUSES) + 1, np.int64)
        for parts in pending:
            chunk_steps_max = 0
            for lo, d, launched in parts:
                with self.spans.span("aln.collect", bno), \
                        on_stream(self.streams[d]):
                    harr, n_hits, fb, steps, cause = collect_search(launched)
                    if harr.device.type == "cuda":   # launched[3]: `it`
                        self.stats["d2h_bytes"] += sum(
                            t.nbytes for t in (launched[3], harr, n_hits, fb,
                                               cause))
                    harr = harr.cpu().numpy()
                    nh = n_hits.cpu().numpy()
                    fb = fb.cpu().numpy()
                    cause = cause.cpu().numpy()
                chunk_steps_max = max(chunk_steps_max, steps)
                by_cause += np.bincount(cause[fb], minlength=len(by_cause))
                chunk_fb = np.nonzero(fb)[0]
                if len(chunk_fb):
                    idxs = [lo + int(b) for b in chunk_fb]
                    n_fb += len(idxs)
                    fb_jobs.append((idxs, self._pool.submit(
                        self._native_job, "aln.fallback_search", bno,
                        [seqs[i] for i in idxs], [rseqs[i] for i in idxs],
                        opt)))
                with self.spans.span("aln.decode", bno):
                    _decode(harr, nh, fb, opt, out, lo)
            # the devices' longest search, as engine_jax.py:1104-1108
            self.stats["iterations"] += chunk_steps_max

        t_dev = time.perf_counter() - t_start
        self.stats["device_reads"] += host_lo - n_fb
        self.stats["fallback_reads"] += n_fb
        self.stats["host_reads"] += n_host
        with self.spans.span("aln.host_wait", bno):
            for idxs, fut in fb_jobs:
                for i, h in zip(idxs, fut.result()):
                    out[i] = h
            for lo, fut in host_jobs:
                for i, h in enumerate(fut.result()):
                    out[lo + i] = h
        self._balance(bno, n_reads, n_host, n_fb, host_lo, t_dev)
        self.stats["host_frac"] = round(self.host_frac, 3)
        causes = dict(zip(FB_CAUSES, by_cause[1:].tolist()))
        for name, n in causes.items():
            self.stats["fallback_by_cause"][name] += n
        self.stats["batches"].append({
            "reads": n_reads, "host_reads": n_host, "fallback_reads": n_fb,
            "host_share": n_host / n_reads, "acap": cfg.acap,
            "iter_cap": cfg.iter_cap, "fallback_by_cause": causes})
        return out  # type: ignore[return-value]

    def _balance(self, bno: int, n_reads: int, n_host: int, n_fb: int,
                 host_lo: int, t_dev: float) -> None:
        """Rate-based balance: size the next batch's host share so that
        the pool's work, the host share and the overflow, fits the
        devices' wall `t_dev` of batch `bno`; the pool's time a read is
        both kinds of job's over both kinds of read.  Down to no share
        where the overflow alone fills the wall; an env share is fixed.
        A batch whose pool ran nothing measures no host rate and leaves
        the share as it is: a card at no share stays there until a batch
        overflows (no start share above 0 searched faster on a card)."""
        host_busy = (self.spans.total("aln.host_search", bno)
                     + self.spans.total("aln.fallback_search", bno))
        if self._frac_fixed or not host_lo or host_busy <= 0:
            return
        per_read = host_busy / (n_host + n_fb)
        want = t_dev / per_read - n_fb
        f_star = min(max(want / n_reads, 0.0), 0.85)
        self.host_frac = 0.5 * self.host_frac + 0.5 * f_star

    def _native_job(self, name: str, bno: int, seqs, rseqs, opt: GapOpt):
        """`native_align_batch` on the pool's thread, in the span `name`
        of batch `bno`."""
        with self.spans.span(name, bno):
            return native_align_batch(self.fms, seqs, rseqs, opt)


def _pack_reads(seqs, rseqs, lens, max_diff, L: int, SL: int,
                seed_len: int):
    """Pack reads into the device layout: (sq uint8[n, 2, L], ssq
    uint8[n, 2, SL] seed suffixes, has_seed bool[n], bad bool[n] — more
    N bases than the read's diff budget)."""
    n = len(seqs)
    cat = np.concatenate(seqs) if n else np.zeros(0, np.uint8)
    catr = np.concatenate(rseqs) if n else np.zeros(0, np.uint8)
    starts = np.zeros(n, dtype=np.int64)
    if n:
        starts[1:] = np.cumsum(lens[:-1])
    sq = np.full((n, 2, L), 4, dtype=np.uint8)
    lmask = np.arange(L)[None, :] < lens[:, None]
    sq[:, 0][lmask] = cat
    sq[:, 1][lmask] = catr
    hs = lens > seed_len
    sidx = (starts + lens - SL)[:, None] + np.arange(SL)[None, :]
    sidx = np.clip(sidx, 0, max(len(cat) - 1, 0))
    ssq = np.full((n, 2, SL), 4, dtype=np.uint8)
    if len(cat):
        ssq[:, 0] = cat[sidx]
        ssq[:, 1] = catr[sidx]
    ssq[~hs] = 4
    nN = (np.add.reduceat((cat > 3).astype(np.int64), starts)
          if n else np.zeros(0, np.int64))
    return sq, ssq, hs, nN > max_diff


def pack_chunk(cfg: EngineConfig, seqs, rseqs, lens, max_diff,
               seed_len: int, device) -> tuple:
    """The read arguments of `run_search_persistent` / `step_cases` for
    one chunk, on `device`: (seqs, lens, max_diff0, has_seed, seed_seqs,
    bad)."""
    sq, ssq, hs, bad = _pack_reads(seqs, rseqs, lens, max_diff, cfg.L,
                                   cfg.SL, seed_len)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (sq, lens, max_diff, hs, ssq, bad))


def _decode(harr, nh, fb, opt: GapOpt, out, lo: int) -> None:
    """Device hit planes -> per-read Hit lists (vectorized unpack)."""
    nh_arr = np.where(fb, 0, nh.astype(np.int64))
    valid = np.arange(harr.shape[1])[None, :] < nh_arr[:, None]
    vh = harr[valid]                       # [T, 3] read-major
    meta = vh[:, 0]
    nmm, gapo, gape = meta & 0xFF, (meta >> 8) & 0xFF, (meta >> 16) & 0xFF
    flat = np.stack(
        [nmm, gapo, gape, (meta >> 24) & 1, vh[:, 1], vh[:, 2],
         nmm * opt.s_mm + gapo * opt.s_gapo + gape * opt.s_gape],
        axis=-1).tolist()
    fbl = fb.tolist()
    start = 0
    for b, n in enumerate(nh_arr.tolist()):
        end = start + n
        if not fbl[b]:
            out[lo + b] = [Hit(*c) for c in flat[start:end]]
        start = end


def native_align_batch(fms, seqs, rseqs, opt):
    """bwa_cal_sa_reg_gap over a batch via the C++ search (one host
    thread) — a jax-free copy of engine_jax.native_align_batch, whose
    module imports jax.  The device engine's fallback and the `native`
    engine."""
    if not seqs:
        return []
    max_len = max(len(s) for s in seqs)
    batch_opt = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        batch_opt.max_diff = cal_maxdiff(max_len, thres=opt.fnr)
    if batch_opt.max_diff < batch_opt.max_gapo:
        batch_opt.max_gapo = batch_opt.max_diff
    if opt.fnr > 0.0:
        md = np.array([cal_maxdiff(len(s), thres=opt.fnr) for s in seqs],
                      dtype=np.int32)
    else:
        md = np.full(len(seqs), batch_opt.max_diff, dtype=np.int32)
    sl = np.array([opt.seed_len if opt.seed_len < len(s) else INT32_MAX
                   for s in seqs], dtype=np.int32)
    harr, hn = native.match_gap_batch(fms[0], fms[1], seqs, rseqs, md, sl,
                                      batch_opt)
    hn_arr = np.asarray(hn, dtype=np.int64)
    okl = (hn_arr >= 0).tolist()
    nh = np.maximum(hn_arr, 0)
    valid = np.arange(harr.shape[1])[None, :] < nh[:, None]
    vh = harr[valid]  # [T, 4] read-major, uint32
    meta = vh[:, 0].astype(np.int64)
    flat = np.stack(
        [meta & 0xFF, (meta >> 8) & 0xFF, (meta >> 16) & 0xFF,
         (meta >> 24) & 1, vh[:, 1].astype(np.int64),
         vh[:, 2].astype(np.int64),
         vh[:, 3].astype(np.int32).astype(np.int64)], axis=-1).tolist()
    out = []
    start = 0
    for i, n in enumerate(nh.tolist()):
        end = start + n
        if okl[i]:
            out.append([Hit(*c) for c in flat[start:end]])
        else:  # per-read hit capacity overflow: exact re-run
            out.append(engine_ref.align_batch(
                fms, [seqs[i]], [rseqs[i]], opt)[0])
        start = end
    return out
