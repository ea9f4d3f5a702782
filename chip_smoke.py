"""Smoke test of ibwa_tpu_torch on one CUDA card: builds the kernels,
checks each against its plain PyTorch version, and drives every path of
the port end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: a CUDA card is required (there is no CPU path)
  2. build: csrc/*.cu with nvcc for sm_90a (one nvcc per source, all
     started together) and the native host library with g++, both into
     build/ibwa_tpu_torch/
  3. kernel vs plain version, bitwise, at the paths' shapes, each timed
     beside its plain version: K1 stack_update at B=1024 x ACAP 256 and
     1024; K2 occ4_pair / occ1_pair over the aln path's block table; K6
     width_pass on the smoke chunk (2,048 reads: w / bid / meta planes);
     the search step (search_step.cu, whose stages are K2's and K1's
     device code) on states of a real search of the smoke reads and on
     states at every capacity edge (`engine.step_cases`), 1,024 lanes x
     ACAP 256 and 1024, 1 step and SWITCH_K steps per launch, all 30 state
     fields; K7 lane_switch on every chunk of `engine.switch_cases` (first
     load, mid-search, parking, the last flush, bad reads, no lane or every
     lane finished, fewer reads than lanes), 1,024 lanes x ACAP 256 and
     1024, all 30 state fields, the 5 output arrays and the count of reads
     left; K8 search_chunk (one launch per chunk; its step and switch
     stages are the device code of the two before) on the smoke chunk
     against the plain loop and against the loop of the phased kernels,
     against the latter also on the `bad`, `tail` and `all` inputs of
     `engine.switch_cases` and at ACAP 1024, with and without its
     prefetch: hit counts, fallback flags, the step count and the hits
     below each count; K3
     chase and K4 chase_mw (W=4) on the probe's three tables; K5 lf_walk
     on 131,072 random rows plus the edge rows, at block intervals 32, 64
     and 128
  4. the paths, each with the launch counts set to 0 just before it and
     read just after:
     a. the dependent-gather probe (`bench_chase.probe`) on three tables
        made on the card: 500,000 x 128 words (256 MB, the TPU probe's
        shape), 1,000,000 x 8 words (32 MB, the smoke table's shape:
        read at random it is met in HBM, the L2 keeps ~8-16 MB of it) and
        64,000,000 x 8 words (2 GB: a human-scale block table)
     b. the SA walker: `DeviceWalker.resolve` on 2,097,152 random
        (strand, row) pairs of the smoke index, equal to the native
        host `sa_lookup` (K5's launches on its path are sampe's, 4d)
     c. `aln`: a 32 Mbp repeat-structured genome (indexed by the port's
        `index` and cached under .bench/smoke/), 16,384 simulated 100 bp
        reads; `ibwa_tpu_torch aln` native, device-only (IBWA_HOST_FRAC=0)
        and hybrid, three rounds in turns, each rate as its median and
        range; in every round each device .sai must be byte-identical to
        `--engine native`, and both device paths must launch width_pass
        and search_chunk and no other kernel, device-only one of each per
        chunk; then the profile of one warm 2,048-read chunk (bare wall,
        launches, device busy share, device time by kind, the lanes'
        iterations) beside the loop of the phased kernels on the same
        chunk, and the prefetch of the step on and off
     d. 131,072 pairs of 100 bp from the smoke genome: one whole aln batch
        (both ends, 262,144 reads, 128 chunks) device-only through
        `TorchAlnEngine.align_batch`, every chunk launched under sync debug
        mode "error" before the first is read back, with its peak device
        memory, in turns with the one-by-one order (hits equal); then
        `aln --device cuda` on each end, `sampe -R` with K5 walking the SA
        rows on the card and with `--engine native` (host walks) on all
        the pairs, SAM byte-equal, the device run traced, launching
        lf_walk and nothing else and leaving no row to the host walks;
        the rates on the first 32,768 pairs, three rounds of the two in
        turns, untraced, SAM byte-equal in every round; and `samse` on
        end 1, one line per read
     Every kernel must have launched on its path; the step and the switch
     run there as stages of search_chunk, K1's and K2's occ4 code as
     stages of the step, and K2's occ1 code as a stage of width_pass,
     whose launches they carry.
  5. the result lines: the card, the kernel table, and the contract line

Every line of the log after the card is known names the card and its power
limit.

`bound_ms` of the kernel table is the least time the card could take for
the call: the larger of the bytes the call must move over 3.35 TB/s and
its integer operations over 67 Tops/s (the card's non-tensor-core rate);
for the data-dependent kernels it counts the rows this run fetched (for
lf_walk each distinct table row once, `walk_footprint`).  The chained
kernels (chase, lf_walk, search_step, search_chunk, width_pass) also get a
latency bound: their dependent fetches times the one-warp step the probe
measured.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import pathlib
import random
import re
import statistics
import subprocess
import sys
import time

SEED = 20261016
N_READS = 16384
READ_LEN = 100
N_PAIRS = 131_072               # half of one sampe batch (sampe.BATCH)
RATE_PAIRS = 32_768             # the pairs sampe's rates are read on
ROUNDS = 3                      # of every host-clock rate, in turns
B_LANES = 1024
WALK_PAIRS = 2_097_152          # 16 dispatches of the walker
PROBE_STEPS, PROBE_DELTA = 256, 2048
PROBE_LANES = [32, 256, 1024]   # 32: one warp, the fetch latency itself
PROBE_TABLES = [("a", 500_000, 128),      # the TPU probe's shape, 256 MB
                ("b", 1_000_000, 8),      # the smoke table's shape, 32 MB
                ("c", 64_000_000, 8)]     # human scale, 2 GB
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".bench" / "smoke"


CARD = ""   # the card's name and power limit, as nvidia-smi gives them


def log(msg: str) -> None:
    """A line of the log; once the card is known, every line names it and
    its power limit beside the numbers it carries."""
    print(f"[smoke{' ' + CARD if CARD else ''}] {msg}", flush=True)


def spread(values) -> str:
    """Median and range of repeated readings: one reading of a host-clock
    rate proves nothing on a machine whose host clock moves between
    calls."""
    v = sorted(values)
    return (f"median {statistics.median(v):.1f} (min {v[0]:.1f}, max "
            f"{v[-1]:.1f}, {len(v)} readings)")


def device_us(prof, reps: int) -> dict:
    """{kernel name: (device us, launches)} per call, from a profiler
    trace of `reps` equal calls.

    A trace can miss a few of its first launches (late in a long process
    more often; neither a pause nor a throwaway launch at its start
    prevents it), so a name's time is (mean time of the launches seen) x
    (launches per call, rounded up), not its total / reps."""
    import torch
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0:
            per_call = math.ceil(e.count / reps - 1e-9)
            out[e.key] = (e.self_device_time_total / e.count * per_call,
                          per_call)
    if sum(us for us, _ in out.values()) <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def timed_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) per call of fn over `reps` calls, after one
    warm-up call.  Device ms is the summed time of the kernels one call
    runs (torch.profiler, `device_us`); call ms is the CUDA-event span of
    the calls, which at small sizes is set by the host launching them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(us for us, _ in device_us(prof, reps).values())
    return dev_us / 1e3, call_ms


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the integer rate, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_stack(dev) -> dict:
    """K1 against stack_update_plain on random planes (ties, full rows,
    inactive lanes) at B=1024 and both arena sizes."""
    import numpy as np
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import stack_kernel as sk
    row = {}
    for acap in (256, 1024):
        case = sk.random_case(np.random.default_rng(SEED + acap), B_LANES,
                              acap)
        args = sk.case_tensors(case, dev)
        want = sk.stack_update_plain(*args)
        got = sk.stack_update(*[a.clone() for a in args])
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"stack_update ACAP={acap}: kernel != plain "
                                 f"(max abs err {err})")
        scratch = [a.clone() for a in args]
        ms, call_ms = timed_ms(lambda: sk.stack_update(*scratch), 200)
        plain_ms, plain_call_ms = timed_ms(
            lambda: sk.stack_update_plain(*args), 50)
        log(f"K1 stack_update B={B_LANES} ACAP={acap}: bitwise equal; "
            f"device ms/call kernel {ms:.5f}, plain {plain_ms:.5f}; "
            f"call ms kernel {call_ms:.5f}, plain {plain_call_ms:.5f}")
        if acap == 256:   # the main path's arena (make_config, 32 Mbp)
            # must move: the step's inputs, the whole key plane (free-slot
            # ranks and the argmin need every slot), the popped entry of
            # the 4 payload planes, <= 10 child slots + the freed one in
            # all 5 planes, and the 8 per-lane outputs
            slots = B_LANES * 4 * (4 + 5 * (sk.NCH + 1))
            moved = nbytes(*args[:10]) + slots + B_LANES * (1 + 7 * 8)
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **bound(moved, 4 * B_LANES * acap), "library_ms": None}
    kernels.reset_launches()
    return row


def check_occ(fm, dev) -> dict:
    """K2 against its plain versions over `fm`'s table at random and edge
    bounds, at the step's shape (B lanes) and the width pass's (2 x 2048)."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.fm import device as fd
    rng = np.random.default_rng(SEED)
    n = fm.seq_len
    prim = fm.primary.tolist()
    edges = [0, 1, 2, 63, 64, 65, n - 1, n, prim[0], prim[0] + 1,
             prim[1], prim[1] + 1]
    rows = {}
    for m in (B_LANES, 4096):
        k = rng.integers(0, n + 1, m)
        k[:len(edges)] = edges
        l = rng.integers(0, n + 1, m)
        l[-len(edges):] = edges
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        strand, kq, lq = t(rng.integers(0, 2, m)), t(k), t(l)
        c = t(rng.integers(0, 4, m))
        for name, kern, plain, n_in in (
                ("occ4_pair", lambda: fd.occ4_pair(fm, strand, kq, lq),
                 lambda: fd.occ4_pair_plain(fm, strand, kq, lq), 3),
                ("occ1_pair", lambda: fd.occ1_pair(fm, strand, kq, lq, c),
                 lambda: fd.occ1_pair_plain(fm, strand, kq, lq, c), 4)):
            out = kern()
            err = max_abs_err([out], [plain()])
            if err:
                raise AssertionError(f"{name} m={m}: kernel != plain "
                                     f"(max abs err {err})")
            ms, call_ms = timed_ms(kern, 200)
            plain_ms, plain_call_ms = timed_ms(plain, 50)
            log(f"K2 {name} m={m} intv={fm.intv}: bitwise equal; "
                f"device ms/call kernel {ms:.5f}, plain {plain_ms:.5f}; "
                f"call ms kernel {call_ms:.5f}, plain {plain_call_ms:.5f}")
            if m == B_LANES:
                # must move: the queries, one table row per (query,
                # bound), the counts; ~6 integer ops per word and base
                row_bytes = 4 * (4 + fm.wpb)
                moved = n_in * 8 * m + 2 * m * row_bytes + nbytes(out)
                n_c = 4 if name == "occ4_pair" else 1
                rows[name] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms,
                              **bound(moved, 2 * m * fm.wpb * n_c * 6),
                              "library_ms": None}
    kernels.reset_launches()
    return rows


def smoke_chunk(fms, fq, dev) -> dict:
    """The first PERSIST_N reads of the smoke corpus as the engine takes a
    chunk: its config, the read lists, and `run_search_persistent`'s read
    arguments on the card."""
    from ibwa_tpu_torch.align import engine, pipeline
    from ibwa_tpu_torch.align.opts import GapOpt
    opt = GapOpt()
    reads = pipeline._load(str(fq), opt)[:engine.PERSIST_N]
    seqs, rseqs = [r.seq for r in reads], [r.rseq for r in reads]
    cfg, lens, md = engine.batch_config(seqs, opt, fms[0].seq_len)
    return {"cfg": cfg, "opt": opt, "seqs": seqs, "rseqs": rseqs,
            "args": engine.pack_chunk(cfg, seqs, rseqs, lens, md,
                                      opt.seed_len, dev)}


def check_search_step(fm, chunk: dict) -> dict:
    """The search-step kernel against the plain step on the card: every
    case of `engine.step_cases` over the smoke chunk, at ACAP 256 and
    1024, 1 step and SWITCH_K steps per launch, all 30 state fields
    bitwise.  Timed on the mid-search state at SWITCH_K steps."""
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    args = chunk["args"]
    fields = lambda st: [getattr(st, f) for f in engine.FIELDS]

    def plain(cfg, seqs, st, n):
        for _ in range(n):
            st = engine._search_step(cfg, fm, seqs, st)
        return st

    row = {}
    for acap in (256, 1024):
        cfg0 = dataclasses.replace(chunk["cfg"], acap=acap)
        cases = engine.step_cases(cfg0, fm, *args, n_lanes=B_LANES)
        for name, cfg, seqs, st in cases:
            for n in (1, engine.SWITCH_K):
                want = plain(cfg, seqs, engine.clone_state(st), n)
                got = engine.search_steps(cfg, fm, seqs,
                                          engine.clone_state(st), n)
                torch.cuda.synchronize()
                err = max_abs_err(fields(got), fields(want))
                if err:
                    bad = [f for f in engine.FIELDS if max_abs_err(
                        [getattr(got, f)], [getattr(want, f)])]
                    raise AssertionError(
                        f"search_step ACAP={acap} case {name} n={n}: kernel "
                        f"!= plain step in {bad} (max abs err {err})")
        log(f"search_step B={B_LANES} ACAP={acap}: all {len(engine.FIELDS)} "
            f"fields bitwise equal to the plain step on "
            f"{[c[0] for c in cases]} at 1 and {engine.SWITCH_K} steps")
        # ---- times, on the lanes mid-search
        name, cfg, seqs, st = cases[1]
        reps = 20
        ms = {}
        for n in (1, engine.SWITCH_K):
            pool = iter([engine.clone_state(st) for _ in range(2 * reps + 1)])
            ms[n], _ = timed_ms(lambda: engine.search_steps(
                cfg, fm, seqs, next(pool), n), reps)
        pool = iter([engine.clone_state(st) for _ in range(5)])
        plain_ms, _ = timed_ms(
            lambda: plain(cfg, seqs, next(pool), engine.SWITCH_K), 2)
        # what these SWITCH_K steps must move, from the counters they
        # advanced: per lane-step two FM rows, a read base, two meta
        # words, the freed key and the next pop's entry; five words per
        # pushed child; per recorded hit its three words and one strand's
        # w / bid / meta row in and out; and per launch the state once in
        # (key rows, scalars) and out (scalars).  The E-chain's rows and
        # bases are left out: the counters do not show how many there were.
        after = engine.search_steps(cfg, fm, seqs, engine.clone_state(st),
                                    engine.SWITCH_K)
        lane_steps = int((after.lane_it - st.lane_it).sum())
        pushes = int((after.seqc - st.seqc).sum())
        hits = int((after.n_hits - st.n_hits).sum())
        P = cfg.L + cfg.SL + 2
        moved = (lane_steps * (2 * 4 * (4 + fm.wpb) + 1 + 2 * 8 + 4 + 4 * 4)
                 + pushes * 5 * 4 + hits * (3 * 8 + 2 * 3 * P * 8)
                 + B_LANES * (acap * 4 + 2 * 15 * 8))
        ops = lane_steps * (2 * fm.wpb * 4 * 6 + 400 + 4 * acap)
        b = bound(moved, ops)
        log(f"search_step B={B_LANES} ACAP={acap} on {name}: device ms per "
            f"launch {ms[1]:.5f} at 1 step, {ms[engine.SWITCH_K]:.5f} at "
            f"{engine.SWITCH_K} steps ({lane_steps} lane-steps, {pushes} "
            f"pushes, {hits} hits); {engine.SWITCH_K} plain steps "
            f"{plain_ms:.5f}; bound {b['bound_ms']:.5f} ({b['bound_by']}, "
            f"{moved} bytes)")
        if acap == 256:   # the main path's arena
            row = {"max_abs_err": 0, "ms": ms[engine.SWITCH_K],
                   "plain_ms": plain_ms, **b, "library_ms": None,
                   "ms_1_step": ms[1], "steps_per_launch": engine.SWITCH_K}
    kernels.reset_launches()
    return row


def check_width_pass(fm, chunk: dict) -> dict:
    """K6 against `big_planes_plain` on the smoke chunk: the w / bid / meta
    planes of its 2,048 reads, bitwise."""
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    cfg = chunk["cfg"]
    seqs, lens, _, has_seed, seed_seqs, _ = chunk["args"]
    run = lambda: engine.big_planes(cfg, fm, seqs, lens, has_seed, seed_seqs)
    plain = lambda: engine.big_planes_plain(cfg, fm, seqs, lens, has_seed,
                                            seed_seqs)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        bad = [n for n, g, w in zip(("w", "bid", "meta"), got, want)
               if max_abs_err([g], [w])]
        raise AssertionError(f"width_pass: kernel != plain in {bad} (max abs "
                             f"err {err})")
    ms, call_ms = timed_ms(run, 20)
    plain_ms, plain_call_ms = timed_ms(plain, 2)
    # must move: the three planes out, the bases, lengths and flags in, and
    # two table rows per base that is one (an N or a position beyond the
    # read fetches nothing); ~6 integer ops per word of a row and ~40 more
    # per base
    pos = torch.arange(cfg.L, device=lens.device)
    main = (seqs < 4) & (pos[None, None, :] < lens[:, None, None])
    seed = (seed_seqs < 4) & has_seed[:, None, None]
    fetches = int(main.sum()) + int(seed.sum())
    longest = int(main.sum(dim=2).max())
    moved = (nbytes(*got) + nbytes(seqs, seed_seqs, lens, has_seed)
             + fetches * 2 * 4 * (4 + fm.wpb))
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(moved, fetches * (2 * fm.wpb * 6 + 40)),
           "library_ms": None, "_longest": longest}
    log(f"K6 width_pass N={lens.shape[0]} L={cfg.L} SL={cfg.SL} "
        f"intv={fm.intv}: w / bid / meta bitwise equal; {fetches} bases "
        f"fetched, longest chain {longest}; device ms/call kernel {ms:.5f}, "
        f"plain {plain_ms:.5f}; call ms kernel {call_ms:.5f}, plain "
        f"{plain_call_ms:.5f}; bound {row['bound_ms']:.5f} "
        f"({row['bound_by']}, {moved} bytes)")
    kernels.reset_launches()
    return row


def check_lane_switch(fm, chunk: dict) -> tuple[dict, dict]:
    """K7 against the plain switch on the card: every chunk of
    `engine.switch_cases` over the smoke reads, at ACAP 256 and 1024: all
    30 state fields, the 5 output arrays and the count of reads left,
    bitwise.  Timed on `first`, where all 1,024 lanes load.  Returns the
    table row and the cases at ACAP 256 by name."""
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine

    def tensors(ch):
        return ([getattr(ch.st, f) for f in engine.FIELDS] + ch.out_h
                + [ch.out_nh, ch.out_fb, ch.remaining])

    names = [*engine.FIELDS, "out_hm", "out_hk", "out_hl", "out_nh",
             "out_fb", "remaining"]
    row, cases256 = {}, {}
    for acap in (256, 1024):
        cfg = dataclasses.replace(chunk["cfg"], acap=acap)
        cases = engine.switch_cases(cfg, fm, *chunk["args"], n_lanes=B_LANES)
        if acap == 256:
            cases256 = dict(cases)
        seen = []
        for name, ch in cases:
            want, got = ch.clone(), ch.clone()
            want.switch_plain()
            got.switch()
            torch.cuda.synchronize()
            err = max_abs_err(tensors(got), tensors(want))
            if err:
                bad = [n for n, g, w in zip(names, tensors(got),
                                            tensors(want))
                       if max_abs_err([g], [w])]
                raise AssertionError(
                    f"lane_switch ACAP={acap} case {name}: kernel != plain "
                    f"switch in {bad} (max abs err {err})")
            if got.counters() != (int(want.remaining), int(want.st.it)):
                raise AssertionError(f"lane_switch ACAP={acap} case {name}: "
                                     "the sync words differ")
            fin = ch.st.done | ch.st.fb
            flush = fin & (ch.st.rid >= 0) & (ch.st.rid < ch.N)
            load = fin & (ch.st.rid + ch.B < ch.N)
            seen.append(f"{name} (flush {int(flush.sum())}, load "
                        f"{int(load.sum())}, park {int((fin & ~load).sum())})")
        log(f"lane_switch B={B_LANES} ACAP={acap}: {len(names)} tensors "
            f"bitwise equal to the plain switch on {', '.join(seen)}")
        # ---- times, on the first switch of the chunk: every lane loads
        first = cases[0][1]
        reps = 20
        pool = iter([first.clone() for _ in range(2 * reps + 1)])
        ms, call_ms = timed_ms(lambda: next(pool).switch(), reps)
        pool = iter([first.clone() for _ in range(5)])
        plain_ms, plain_call_ms = timed_ms(
            lambda: next(pool).switch_plain(), 2)
        # must move, per loading lane: its three width rows in and out, the
        # key row and the two root slots of four planes out, the read's
        # scalars in and the lane's out; per lane its flags and read index
        P = cfg.L + cfg.SL + 2
        moved = (B_LANES * (2 * 3 * 2 * P * 8 + acap * 4 + 8 * 4
                            + (8 + 8 + 1 + 1) + (14 * 8 + 3))
                 + B_LANES * (8 + 2))
        b = bound(moved, B_LANES * (3 * 2 * P + acap))
        log(f"lane_switch B={B_LANES} ACAP={acap} on first (all lanes "
            f"load): device ms/call kernel {ms:.5f}, plain {plain_ms:.5f}; "
            f"call ms kernel {call_ms:.5f}, plain {plain_call_ms:.5f}; bound "
            f"{b['bound_ms']:.5f} ({b['bound_by']}, {moved} bytes)")
        if acap == 256:   # the main path's arena
            row = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **b,
                   "library_ms": None}
    kernels.reset_launches()
    return row, cases256


def kernel_ms(prof, reps: int, name: str) -> float:
    """Device ms per call of the kernels whose name holds `name`."""
    return sum(us for key, (us, _) in device_us(prof, reps).items()
               if name in key) / 1e3


def launch_chunk(cfg, fm, args, n_lanes: int, mode: int):
    """`engine.search_chunk` on width planes of its own (the kernel updates
    them in place), in the kernel's `mode`: 1 as the engine runs it, 0
    without the step's rows asked ahead."""
    import torch
    from ibwa_tpu_torch.align import engine
    seqs, lens, md, hs, ssq, bad = args
    big = engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
    return engine._launch_search_chunk(
        cfg, fm, seqs, big, lens, md, hs, bad, n_lanes,
        torch.cuda.current_stream().cuda_stream, mode)


def time_search_chunk(cfg, fm, args, reps: int, mode: int) -> float:
    """Device ms of one `search_chunk` launch on the chunk `args`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n_lanes = min(B_LANES, args[1].shape[0])
    launch_chunk(cfg, fm, args, n_lanes, mode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch_chunk(cfg, fm, args, n_lanes, mode)
        torch.cuda.synchronize()
    return kernel_ms(prof, reps, "search_chunk_kernel")


def check_search_chunk(fm, chunk: dict, switch_cases: dict) -> dict:
    """K8 against its plain version, the phased loop, on the card.  Against
    the plain loop (`engine.run_search_plain`, which shares no device code
    with it): the smoke chunk, 2,048 reads on 1,024 lanes, as the main path
    gives it.  Against the loop of the phased kernels
    (`engine.run_search_phased`): the same chunk at ACAP 256 and 1024, and
    the read inputs of the `bad`, `tail` and `all` cases of
    `engine.switch_cases`.  Each with and without the step's rows asked
    ahead: hit counts, fallback flags, the step count and the hits below
    each count, bitwise.  Timed on the smoke chunk beside both loops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    cfg0, args0 = chunk["cfg"], chunk["args"]

    def hold(name, cfg, args, n_lanes, want):
        lens = args[1]
        for mode in (1, 0):
            out_h, nh, fb, counters = launch_chunk(cfg, fm, args, n_lanes,
                                                   mode)
            left, steps = counters.tolist()[:2]
            got = (engine.masked_hits(out_h.permute(1, 2, 0), nh, fb), nh,
                   fb.to(torch.int64))
            ref = (engine.masked_hits(*want[:3]), want[1],
                   want[2].to(torch.int64))
            err = max_abs_err(got, ref)
            if err or left != 0 or steps != want[3]:
                bad_in = [n for n, g, w in zip(("hits", "n_hits", "fb"), got,
                                               ref) if max_abs_err([g], [w])]
                raise AssertionError(
                    f"search_chunk case {name} mode={mode}: kernel != its "
                    f"plain version in {bad_in} (max abs err {err}); steps "
                    f"{steps} vs {want[3]}, reads left {left}")
        return (f"{name} ({lens.shape[0]} reads, {n_lanes} lanes, steps "
                f"{want[3]}, fallback {int(want[2].sum())})")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        want = engine.run_search_plain(cfg0, fm, *args0, n_lanes=B_LANES)
        torch.cuda.synchronize()
    plain_all = device_us(prof, 1)
    seen = [hold("smoke against the plain loop", cfg0, args0, B_LANES, want),
            hold("smoke", cfg0, args0, B_LANES, engine.run_search_phased(
                cfg0, fm, *args0, n_lanes=B_LANES))]
    for name in ("bad", "tail", "all"):
        ch = switch_cases[name]
        args = (args0[0][:ch.N].contiguous(), ch.lens, ch.max_diff0,
                ch.has_seed, args0[4][:ch.N].contiguous(), ch.bad)
        seen.append(hold(name, cfg0, args, B_LANES, engine.run_search_phased(
            cfg0, fm, *args, n_lanes=B_LANES)))
    cfg1k = dataclasses.replace(cfg0, acap=1024)
    seen.append(hold("ACAP 1024", cfg1k, args0, B_LANES,
                     engine.run_search_phased(cfg1k, fm, *args0,
                                              n_lanes=B_LANES)))
    log(f"search_chunk: n_hits, fb, steps and the hits below n_hits bitwise "
        f"equal to the plain loop and to the phased kernels' loop, with and "
        f"without the rows asked ahead, on {'; '.join(seen)}")

    # ---- nothing in the call waits for the card: torch raises on any op
    # that would, whatever the host's load
    seqs, lens, md, hs, ssq, bad = args0
    big = engine.big_planes(cfg0, fm, seqs, lens, hs, ssq)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    counters = engine.search_chunk(cfg0, fm, seqs, big, lens, md, hs, bad,
                                   B_LANES)[3]
    call_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.set_sync_debug_mode("default")
    left, steps, longest, total, rows = counters.tolist()

    # ---- times on the smoke chunk: the kernel, the phased kernels' loop,
    # the plain loop
    reps = 10
    ms = time_search_chunk(cfg0, fm, args0, reps, 1)
    ms_1k = time_search_chunk(cfg1k, fm, args0, 4, 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            engine.run_search_phased(cfg0, fm, *args0, n_lanes=B_LANES)
        torch.cuda.synchronize()
    phased = {k: kernel_ms(prof, 2, k) for k in (
        "lane_switch_kernel", "search_steps_kernel")}
    plain_ms = sum(us for us, _ in plain_all.values()) / 1e3
    plain_n = sum(n for _, n in plain_all.values())
    # must move, from this run's counters: the FM rows the steps needed
    # (the occ4 bounds' and the E-chain's); per lane iteration a read base
    # and two meta words; per recorded hit its three words and one strand's
    # w / bid / meta row in and out; per read its four scalars in and two
    # out.  The arena never leaves the SM.  The operations are an estimate:
    # per row its counts of four bases, per iteration the pass over the key
    # row and some 400 integer operations of the step's own, which nothing
    # in the run counts; the bytes' time is above theirs either way.
    P = cfg0.L + cfg0.SL + 2
    n = lens.shape[0]
    hits = int(want[1][~want[2]].sum())
    moved = (rows * 4 * (4 + fm.wpb) + total * (1 + 2 * 8)
             + hits * (3 * 8 + 2 * 3 * P * 8) + n * (18 + 9))
    ops = rows * fm.wpb * 4 * 6 + total * (400 + 4 * cfg0.acap)
    b = bound(moved, ops)
    phases = steps // engine.SWITCH_K
    log(f"search_chunk N={n} B={B_LANES} ACAP={cfg0.acap}: device ms per "
        f"launch {ms:.5f} (ACAP 1024: {ms_1k:.5f}); the call returned in "
        f"{call_us:.0f} us and waited for nothing (sync debug mode); lanes' "
        f"iterations: longest {longest}, mean {total / B_LANES:.1f}, all "
        f"{total}, FM rows needed {rows}; "
        f"{ms * 1e3 / longest:.4f} us per iteration of the longest lane; the "
        f"phased kernels' loop of the same chunk, {phases} phases: "
        f"lane_switch {phased['lane_switch_kernel']:.5f} + search_step "
        f"{phased['search_steps_kernel']:.5f} ms; the plain loop "
        f"{plain_ms:.5f} ms in {plain_n} launches; bound {b['bound_ms']:.5f} "
        f"({b['bound_by']}, {moved} bytes, operations estimated)")
    kernels.reset_launches()
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None,
            "phased_kernels_ms": sum(phased.values()), "_longest": longest}


def check_chase(tables: dict, dev) -> dict:
    """K3 and K4 (W=4) against chase_plain, bitwise on idx and acc, at
    B in {256, 1024} on each table, K3 also at the walker's 131,072 lanes
    on the 2 GB table and at one warp (32).  The table row of each kernel
    is timed at B=1024 on the 2 GB table, every call on chains of its own
    (a repeated chain would find its 8 MB of rows in the L2 cache)."""
    import torch
    from ibwa_tpu_torch import bench_chase as bc
    from ibwa_tpu_torch import kernels
    rows = {}
    for label, table in tables.items():
        n_rows, roww = table.shape

        def run(name, idx0):
            if name == "chase":
                return bc.chase(table, idx0, PROBE_STEPS, n_rows)
            return bc.chase_mw(table, idx0, PROBE_STEPS, n_rows, 4)

        lanes = [32, 256, 1024] + ([131072] if label == "c" else [])
        for B in lanes:
            starts = bc.start_rows(n_rows, B, 64 if B == 1024 else 1, dev)
            turn = itertools.count()
            fresh = lambda: starts[next(turn) % len(starts)]
            want = bc.chase_plain(table, starts[0], PROBE_STEPS, n_rows)
            for name in ("chase", "chase_mw") if B in (256, 1024) \
                    else ("chase",):
                got = run(name, starts[0])
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                if err:
                    raise AssertionError(
                        f"{name} table {label} B={B}: kernel != plain "
                        f"(max abs err {err})")
                if label != "c" or B != 1024:
                    continue
                ms, _ = timed_ms(lambda: run(name, fresh()), 20)
                plain_ms, _ = timed_ms(lambda: bc.chase_plain(
                    table, fresh(), PROBE_STEPS, n_rows), 3)
                # must move: every fetched row once, idx in, 2 out
                moved = B * PROBE_STEPS * roww * 4 + 3 * B * 4
                rows[name] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms,
                              **bound(moved, 3 * B * PROBE_STEPS),
                              "library_ms": None}
                log(f"{'K3' if name == 'chase' else 'K4'} {name} table "
                    f"{label} B={B} steps={PROBE_STEPS}: device ms/call "
                    f"kernel {ms:.5f}, plain {plain_ms:.5f}, bound "
                    f"{rows[name]['bound_ms']:.5f} "
                    f"({rows[name]['bound_by']})")
        log(f"K3/K4 table {label} ({n_rows} x {roww} words): bitwise equal "
            f"to chase_plain at B={lanes}")
    kernels.reset_launches()
    return rows


def walk_edges(fms) -> tuple:
    """Rows on and next to sampled slots, and the primary rows, on both
    strands."""
    import numpy as np
    intv, n = fms[0].sa_intv, fms[0].seq_len
    edge = [base + d for base in (0, intv, 7 * intv, n // intv * intv)
            for d in (-1, 0, 1) if 0 <= base + d <= n]
    edge += [fms[0].primary, fms[1].primary, n]
    rows = np.array(edge * 2, dtype=np.uint32)
    strand = np.array([0] * len(edge) + [1] * len(edge), dtype=np.uint32)
    return strand, rows


def walk_footprint(fm, calls, mask: int, lanes: int) -> dict:
    """What the LF walks of `calls` (a list of (strand, rows) int64
    tensors on fm's device, each cut into dispatches of `lanes`) must
    fetch, found by the plain step on the card: their LF steps, the
    distinct table rows they read (each must come from memory at least
    once, and need not come more than once), and the sum over dispatches
    of each one's longest walk (a dispatch lasts at least its longest
    chain of dependent fetches)."""
    import torch
    from ibwa_tpu_torch.fm import walk
    seen = torch.zeros(fm.blocks.shape[0], dtype=torch.bool,
                       device=fm.device)
    shift = fm.intv.bit_length() - 1
    steps = chain = 0
    for strand, k in calls:
        add = torch.zeros_like(k)
        active = (k & mask) != 0
        while bool(active.any()):
            # the row lf_step_plain reads (device._gather_block)
            ka = torch.clamp(k - (k > fm.primary[strand]).to(torch.int64),
                             max=fm.seq_len - 1)
            row = strand * fm.n_blk + torch.clamp(ka >> shift,
                                                  max=fm.n_blk - 1)
            seen[row[active]] = True
            k = torch.where(active, walk.lf_step_plain(fm, strand, k), k)
            add += active.to(torch.int64)
            active &= (k & mask) != 0
        steps += int(add.sum())
        chain += sum(int(add[lo:lo + lanes].max())
                     for lo in range(0, len(add), lanes))
    return {"steps": steps, "rows": int(seen.sum()), "chain": chain,
            "row_bytes": fm.blocks.shape[1] * fm.blocks.element_size()}


def walk_bound(n: int, fp: dict, wpb: int) -> dict:
    """K5's bound on n lanes: each lane's strand and row read and its
    (steps, row) written as u32, each distinct table row fetched once;
    ~6 integer operations per word of a row and ~20 more per step."""
    return bound(16 * n + fp["rows"] * fp["row_bytes"],
                 fp["steps"] * (6 * wpb + 20))


def check_walk(fms, dev) -> dict:
    """K5 against lf_walk_plain, bitwise on (add, kfin), for 131,072 random
    (strand, row) pairs plus the edge rows, at block intervals 32, 64 and
    128; timed at 64, the default table."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.fm import walk
    from ibwa_tpu_torch.fm.device import build_device_pair
    rng = np.random.default_rng(SEED)
    es, ek = walk_edges(fms)
    rows = np.concatenate([rng.integers(0, fms[0].seq_len + 1, 131072), ek])
    strand = np.concatenate([rng.integers(0, 2, 131072), es])
    t = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)
    ts, tk = t(strand), t(rows)
    mask = fms[0].sa_intv - 1
    row = {}
    for intv in (32, 128, 64):
        fm = build_device_pair(fms[0], fms[1], dev, intv=intv)
        want = walk.lf_walk_plain(fm, ts, tk, mask)
        got = walk.lf_walk(fm, ts, tk, mask)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"lf_walk intv={intv}: kernel != plain "
                                 f"(max abs err {err})")
        if intv == 64:
            ms, call_ms = timed_ms(lambda: walk.lf_walk(fm, ts, tk, mask), 20)
            plain_ms, _ = timed_ms(
                lambda: walk.lf_walk_plain(fm, ts, tk, mask), 2)
            fp = walk_footprint(fm, [(ts, tk)], mask, len(rows))
            steps = int(got[0].sum())
            if fp["steps"] != steps or fp["chain"] != int(got[0].max()):
                raise AssertionError(f"walk_footprint {fp} against the "
                                     f"kernel's {steps} steps")
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   **walk_bound(len(rows), fp, fm.wpb),
                   "library_ms": None, "_longest": int(got[0].max())}
            log(f"K5 lf_walk n={len(rows)} intv=64: bitwise equal; {steps} "
                f"steps in all, {fp['rows']} distinct table rows of "
                f"{fm.blocks.shape[0]} read, longest walk "
                f"{int(got[0].max())}; device ms/call kernel {ms:.5f}, plain "
                f"{plain_ms:.5f}; call ms kernel {call_ms:.5f}; bound "
                f"{row['bound_ms']:.5f} ({row['bound_by']})")
        else:
            log(f"K5 lf_walk n={len(rows)} intv={intv}: bitwise equal")
        del fm
    kernels.reset_launches()
    return row


def run_probe(tables: dict) -> list[dict]:
    """The probe's report on each table; fails on any parity miss."""
    from ibwa_tpu_torch import bench_chase as bc
    records = []
    for label, table in tables.items():
        lanes = PROBE_LANES + ([131072] if label == "c" else [])
        records += bc.probe(table, lanes, [4], PROBE_STEPS, PROBE_DELTA,
                            reps=3, plain_mw=False, label=label)
    bad = [r for r in records if not r["parity"]]
    if bad:
        raise AssertionError(f"probe parity failed: {bad}")
    return records


def run_walker(fms, dev) -> None:
    """DeviceWalker.resolve on WALK_PAIRS random pairs against the native
    host SA walk on the same pairs."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import native
    from ibwa_tpu_torch.fm.walk import DeviceWalker
    rng = np.random.default_rng(SEED + 1)
    rows = rng.integers(0, fms[0].seq_len + 1, WALK_PAIRS).astype(np.uint32)
    strand = rng.integers(0, 2, WALK_PAIRS).astype(np.uint32)
    walker = DeviceWalker(fms[0], fms[1], dev)
    walker.resolve(strand[:1024], rows[:1024])          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = walker.resolve(strand, rows)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.empty(WALK_PAIRS, dtype=np.uint32)
    for s in (0, 1):
        f = fms[s]
        sel = strand == s
        want[sel] = native.sa_lookup(f._interleaved, f.primary, f.L2,
                                     f.seq_len, f.sa_intv, f.sa, rows[sel])
    host_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"DeviceWalker.resolve differs from the host "
                             f"sa_lookup on {bad}/{WALK_PAIRS} pairs")
    log(f"walker: {WALK_PAIRS} pairs in {-(-WALK_PAIRS // walker.lanes)} "
        f"dispatches equal to the native sa_lookup; wall DeviceWalker."
        f"resolve {dev_s:.3f} s ({WALK_PAIRS / dev_s:.0f} rows/s), native "
        f"sa_lookup {host_s:.3f} s ({WALK_PAIRS / host_s:.0f} rows/s)")


def make_inputs() -> tuple[pathlib.Path, pathlib.Path]:
    """Genome (`simulate.make_genome`, 32 Mbp), its index, and the reads,
    all from SEED; cached under .bench/smoke/."""
    from ibwa_tpu_torch import cli, simulate
    WORK.mkdir(parents=True, exist_ok=True)
    fa = WORK / f"genome_{SEED}.fa"
    fq = WORK / f"reads_{SEED}_{N_READS}.fq"
    if pathlib.Path(str(fa) + ".bwt").exists() and fq.exists():
        return fa, fq
    t0 = time.perf_counter()
    rng = random.Random(SEED)
    seq = simulate.make_genome(rng)
    with open(fa, "w") as f:
        f.write(">smoke_chr\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(fq, "w") as f:
        for i in range(N_READS):
            pos = rng.randrange(0, len(seq) - READ_LEN)
            s = list(seq[pos:pos + READ_LEN])
            for j in range(len(s)):
                if rng.random() < 0.01:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.5:
                s = [comp[ch] for ch in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * READ_LEN}\n")
    log(f"genome {len(seq)} bp + {N_READS} reads made in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rc = cli.main(["index", str(fa)])
    if rc != 0:
        raise AssertionError(f"index exited {rc}")
    log(f"indexed in {time.perf_counter() - t0:.1f} s")
    return fa, fq


def run_cli(cmd: str, args: list[str], out: pathlib.Path
            ) -> tuple[float, str]:
    """`ibwa_tpu_torch <cmd> ... -f out` in-process, as a user calls it:
    (wall seconds of the whole command, its stderr)."""
    from ibwa_tpu_torch import cli
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main([cmd, *args, "-f", str(out)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{cmd} {args} exited {rc}:\n{err.getvalue()}")
    return wall, err.getvalue()


def run_aln(args: list[str], out: pathlib.Path) -> dict:
    """`ibwa_tpu_torch aln ... -f out` in-process; returns its stats line
    plus the wall seconds of the whole command."""
    wall, err = run_cli("aln", args, out)
    lines = [ln for ln in err.splitlines() if ln.startswith("[aln] stats ")]
    if not lines:
        raise AssertionError(f"aln printed no stats:\n{err}")
    stats = json.loads(lines[-1][len("[aln] stats "):])
    stats["wall_s"] = wall
    return stats

def profile_chunk(fms, fm, chunk: dict) -> None:
    """One warm 2,048-read chunk of the device search, as the engine runs
    it (width pass, one `search_chunk` launch, one copy of the counters):
    bare wall, then under the profiler its launches and device time by
    kind; beside it, in the same process, the loop of the phased kernels on
    the same chunk with the host clock around each of a phase's calls; the
    step's prefetch on and off in turns; and the native search of the same
    reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    n = len(chunk["seqs"])
    cfg, args = chunk["cfg"], chunk["args"]
    run = lambda: engine.run_search_persistent(cfg, fm, *args,
                                               n_lanes=B_LANES)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits, nh, fb, steps = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in (hits, nh, fb):
        t.cpu()
    download = time.perf_counter() - t0

    # the loop of the phased kernels, by hand, with the host clock around
    # each of a phase's calls
    seqs, lens, max_diff0, has_seed, seed_seqs, bad = args
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ch = engine._Chunk(cfg, fm, engine.big_planes(cfg, fm, seqs, lens,
                                                  has_seed, seed_seqs),
                       lens, max_diff0, has_seed, bad, B_LANES)
    host_s = {"switch": 0.0, "search_steps": 0.0, "sync": 0.0}
    left, phases = n, 0
    while left > 0:
        t = [time.perf_counter()]
        ch.switch()
        t.append(time.perf_counter())
        ch.st = engine.search_steps(cfg, fm, seqs, ch.st, engine.SWITCH_K)
        t.append(time.perf_counter())
        left, phased_steps = ch.counters()
        t.append(time.perf_counter())
        for i, name in enumerate(host_s):
            host_s[name] += t[i + 1] - t[i]
        phases += 1
    phased_wall = time.perf_counter() - t0
    if phased_steps != steps:
        raise AssertionError(f"steps: search_chunk {steps}, phased loop "
                             f"{phased_steps}")
    host_us = {k: round(v / phases * 1e6, 1) for k, v in host_s.items()}

    kernels.reset_launches()
    reps = 10   # a trace can drop a few of its first records (device_us)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
            torch.cuda.synchronize()
    counts = {k: v // reps for k, v in kernels.launches.items()}
    if set(counts) != set(ALN_KERNELS) or any(
            counts[k] != 1 for k in ALN_KERNELS):
        raise AssertionError(f"a chunk is one launch of each of "
                             f"{ALN_KERNELS}, not {counts}")
    kinds = {"search_chunk": ("search_chunk_kernel",),
             "width_pass": ("width_pass_kernel",),
             "phased kernels": ("search_steps_kernel", "lane_switch_kernel"),
             "K2 occ": ("occ_pair_kernel",),
             "K1 stack_update": ("stack_update_kernel",),
             "torch index/gather/scatter": ("index", "gather", "scatter"),
             "copies": ("memcpy", "memset")}
    dev_us = {k: 0.0 for k in (*kinds, "torch elementwise/reduce")}
    seen = dict.fromkeys(dev_us, 0)
    for key, (us, launches) in device_us(prof, reps).items():
        kind = next((k for k, pats in kinds.items()
                     if any(pat in key.lower() for pat in pats)),
                    "torch elementwise/reduce")
        dev_us[kind] += us
        seen[kind] += launches
    n_launch = sum(seen.values())
    total_us = sum(dev_us.values())
    if n_launch > MAX_LAUNCHES_PER_CHUNK:
        raise AssertionError(
            f"{n_launch} launches in a chunk, more than "
            f"{MAX_LAUNCHES_PER_CHUNK}: torch ops are back between a chunk's "
            f"upload and its download ({seen})")

    # the step's prefetch: on, off, off, on, every launch on planes of its
    # own
    pf = [time_search_chunk(cfg, fm, args, 6, mode) for mode in (1, 0, 0, 1)]

    t0 = time.perf_counter()
    engine.native_align_batch(fms, chunk["seqs"], chunk["rseqs"],
                              chunk["opt"])
    native_s = time.perf_counter() - t0
    shares = ", ".join(f"{k} {v / total_us:.4f}" for k, v in dev_us.items())
    per_launch = ", ".join(
        f"{k} {dev_us[k] / max(seen[k], 1):.1f}" for k in ALN_KERNELS)
    log(f"chunk profile ({n} reads, warm): bare wall {wall:.5f} s for "
        f"{steps} steps of the phased loop's clock, {n / wall:.1f} reads/s, "
        f"and {download:.5f} s to download hits, n_hits and fb; fallback "
        f"{int(fb.sum())}; under the profiler, per run of ten, {n_launch} "
        f"launches in the chunk, of them {counts} (the profiler saw {seen}); "
        f"device time {total_us / 1e6:.5f} s = {total_us / 1e6 / wall:.4f} "
        f"of the bare wall; by kind: {shares}; us per launch: {per_launch}; "
        f"search_chunk device ms with the prefetch on / off / off / on: "
        f"{' / '.join(f'{v:.5f}' for v in pf)}")
    log(f"the phased kernels' loop on the same chunk: wall {phased_wall:.5f} "
        f"s for {phases} phases ({n / phased_wall:.1f} reads/s), host us per "
        f"phase in switch / search_steps / the sync: {host_us}; native "
        f"search of the same reads {native_s:.4f} s "
        f"({n / native_s:.0f} reads/s)")


def run_aln_paths(fa, fq) -> tuple[dict, dict]:
    """`aln` native, device-only and hybrid, ROUNDS rounds of the three in
    turns (the order reversed every other round); in every round both
    device .sai must be byte-identical to the native one, and the
    device-only run's launches, steps and fallback the same.  Returns the
    launch counts of the device-only and the hybrid runs."""
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.io import sai
    names = ("native", "device_only", "hybrid")
    args = {"native": ["--engine", "native"], "device_only":
            ["--device", "cuda"], "hybrid": ["--device", "cuda"]}
    sais = {name: WORK / f"{name}.sai" for name in names}
    res = {name: [] for name in names}
    launches = {}
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            if name == "device_only":
                os.environ["IBWA_HOST_FRAC"] = "0"
            kernels.reset_launches()
            try:
                res[name].append(run_aln([str(fa), str(fq), *args[name]],
                                         sais[name]))
            finally:
                os.environ.pop("IBWA_HOST_FRAC", None)
            got = dict(kernels.launches)
            if name != "native" and launches.setdefault(name, got) != got:
                raise AssertionError(f"aln {name} round {r} launched {got}, "
                                     f"round 0 {launches[name]}")
        want = sais["native"].read_bytes()
        for name in names[1:]:
            if sais[name].read_bytes() != want:
                raise AssertionError(f"round {r}: {name} .sai differs from "
                                     f"--engine native")
    counters = {(r["device_reads"], r["fallback_reads"], r["iterations"])
                for r in res["device_only"]}
    if len(counters) != 1:
        raise AssertionError(f"device-only reads / fallback / steps differ "
                             f"between rounds: {counters}")
    n_hit = sum(1 for hits in sai.iter_sai(str(sais["native"])) if hits)
    if not N_READS * 0.9 <= n_hit <= N_READS:
        raise AssertionError(f"only {n_hit}/{N_READS} reads have hits")
    for name, runs in res.items():
        r = runs[0]
        dev_reads = r.get("device_reads", 0)
        fb = r.get("fallback_reads", 0)
        log(f"aln {name}, {ROUNDS} rounds: reads/s of search wall "
            f"{spread([x['reads'] / x['search_s'] for x in runs])}; end to "
            f"end {spread([x['reads'] / x['wall_s'] for x in runs])}; device "
            f"reads {dev_reads}, overflow fallback {fb} "
            f"({fb / max(dev_reads + fb, 1):.4f}), host share "
            f"{r.get('host_reads', 0)}, steps {r.get('iterations', 0)}")
    log(f".sai byte-identical to --engine native (device-only, hybrid) in "
        f"each of {ROUNDS} rounds; {n_hit}/{N_READS} reads with hits; "
        f"launches device-only {launches['device_only']}, hybrid "
        f"{launches['hybrid']}")
    return launches["device_only"], launches["hybrid"]


def make_pairs(fa) -> tuple[pathlib.Path, pathlib.Path]:
    """N_PAIRS pairs of READ_LEN bp from the smoke genome, made as
    bench.py makes its sampe pairs (insert gauss(320, 40), at least
    2 x READ_LEN + 10; 1% substitutions by a random base; mate 1 forward,
    mate 2 reverse-complemented), from SEED + 2 with numpy; cached under
    .bench/smoke/."""
    import numpy as np
    fqs = tuple(WORK / f"pairs_{SEED + 2}_{N_PAIRS}_{e}.fq" for e in (1, 2))
    if all(fq.exists() for fq in fqs):
        return fqs
    t0 = time.perf_counter()
    with open(fa, "rb") as f:
        f.readline()
        genome = np.frombuffer(f.read().replace(b"\n", b""), dtype=np.uint8)
    rng = np.random.default_rng(SEED + 2)
    isz = np.maximum(2 * READ_LEN + 10,
                     rng.normal(320, 40, N_PAIRS).astype(np.int64))
    pos = (rng.random(N_PAIRS) * (len(genome) - isz)).astype(np.int64)
    col = np.arange(READ_LEN)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    mates = (genome[pos[:, None] + col],
             comp[genome[(pos + isz - 1)[:, None] - col]])
    qual = b"+\n" + b"I" * READ_LEN + b"\n"
    for fq, mate in zip(fqs, mates):
        sub = rng.random(mate.shape) < 0.01
        mate[sub] = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, int(sub.sum()))]
        with open(fq, "wb") as f:
            f.write(b"".join(b"@p%d\n%s\n%s" % (i, row.tobytes(), qual)
                             for i, row in enumerate(mate)))
    log(f"{N_PAIRS} pairs made in {time.perf_counter() - t0:.1f} s")
    return fqs


def check_dispatch_ahead(fms, fqs, dev) -> None:
    """Fault C1 on the card: one whole aln batch (pipeline.BATCH_SIZE
    reads: both ends of the pairs) device-only through
    `TorchAlnEngine.align_batch`.  Every chunk's `launch_search` runs under
    sync debug mode "error" (torch raises on any wait for the card), and
    all of them come before the first `collect_search`; the peak of device
    memory the batch takes.  Then, in turns with it (ahead, one by one,
    one by one, ahead), the same batch with each chunk waited for as soon
    as it is launched, the order before the repair: the hits must be the
    same; the wall from the first launch to the last read-back of the
    counters, and of the whole call."""
    import torch
    from ibwa_tpu_torch.align import engine, pipeline
    from ibwa_tpu_torch.align.opts import GapOpt
    opt = GapOpt()
    reads = [r for fq in fqs for r in pipeline._load(str(fq), opt)]
    if len(reads) != pipeline.BATCH_SIZE:
        raise AssertionError(f"{len(reads)} reads, not one whole batch")
    seqs, rseqs = [r.seq for r in reads], [r.rseq for r in reads]
    launch, collect = engine.launch_search, engine.collect_search
    calls = []

    def launch_ahead(*a, **k):
        calls.append(("launch", time.perf_counter()))
        torch.cuda.set_sync_debug_mode("error")
        try:
            return launch(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def launch_wait(*a, **k):
        calls.append(("launch", time.perf_counter()))
        launched = launch(*a, **k)
        torch.cuda.synchronize()
        return launched

    def collect_rec(launched):
        got = collect(launched)
        calls.append(("collect", time.perf_counter()))
        return got

    os.environ["IBWA_HOST_FRAC"] = "0"
    eng = engine.TorchAlnEngine(fms, dev)
    walls = {"ahead": [], "one_by_one": []}
    want = None
    try:
        for mode in ("ahead", "one_by_one", "one_by_one", "ahead"):
            engine.launch_search = (launch_ahead if mode == "ahead"
                                    else launch_wait)
            engine.collect_search = collect_rec
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = eng.align_batch(seqs, rseqs, opt)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            kinds = [c[0] for c in calls]
            n = kinds.count("launch")
            if n != -(-len(seqs) // engine.PERSIST_N):
                raise AssertionError(f"{n} chunks launched")
            if mode == "ahead" and kinds != ["launch"] * n + ["collect"] * n:
                raise AssertionError("a chunk was read back before every "
                                     "chunk of the batch was launched")
            walls[mode].append((calls[-1][1] - calls[0][1], wall))
            hits = [[dataclasses.astuple(h) for h in r] for r in out]
            if want is None:
                want = hits
                log(f"C1: {len(seqs)} reads ({n} chunks) device-only: every "
                    f"launch made under sync debug mode 'error', all before "
                    f"the first read-back; device memory {base} bytes "
                    f"before the batch, peak {peak} ({peak - base} for the "
                    f"batch); stats {eng.stats}")
            elif hits != want:
                raise AssertionError(f"C1: the {mode} order gave other hits")
    finally:
        engine.launch_search, engine.collect_search = launch, collect
        os.environ.pop("IBWA_HOST_FRAC", None)
        eng.close()
    for mode, w in walls.items():
        log(f"C1 {mode}: first launch to last counters read "
            f"{' / '.join(f'{a:.4f}' for a, _ in w)} s, whole align_batch "
            f"{' / '.join(f'{b:.4f}' for _, b in w)} s "
            f"({' / '.join(f'{len(seqs) / b:.1f}' for _, b in w)} reads/s); "
            f"hits equal")


def sampe_run(args: list[str], out: pathlib.Path, device: bool
              ) -> tuple[float, list[tuple], dict]:
    """One `sampe` run: (wall s, the prefill lines' numbers, launches).
    The device route must launch lf_walk and nothing else, prefill every
    batch and leave no row to the host walks; the native route launches
    nothing."""
    from ibwa_tpu_torch import kernels
    kernels.reset_launches()
    wall, err = run_cli("sampe", args, out)
    got = dict(kernels.launches)
    batches = [tuple(float(x) for x in m.groups())
               for m in PREFILL_LINE.finditer(err)]
    if not device:
        if got or batches:
            raise AssertionError(f"sampe --engine native launched {got}")
        return wall, batches, got
    if set(got) != {"lf_walk"} or got["lf_walk"] <= 0:
        raise AssertionError(f"sampe on the card launched {got}, not "
                             f"lf_walk alone")
    if not batches or any(b[0] <= 0 or b[2] or b[3] for b in batches):
        raise AssertionError(f"a batch's SA walks were not all prefilled "
                             f"on the card:\n{err}")
    return wall, batches, got


PREFILL_LINE = re.compile(
    r"\[sai2sam_pe\] prefill (\d+) rows in (\d+) dispatches, (\d+) rows "
    r"of (\d+) intervals left to the host walks, ([\d.]+) s")


def first_reads(fq: pathlib.Path, n: int, out: pathlib.Path) -> None:
    with open(fq, "rb") as f:
        out.write_bytes(b"".join(itertools.islice(f, 4 * n)))


def run_sampe_phase(fa, fqs, warp_us: float) -> dict:
    """`aln --device cuda` on both ends of the pairs; `sampe -R` on all
    of them with the SA walks on the card (K5 prefilling each batch) and
    with `--engine native` (host walks), SAM byte-equal, the device run
    traced for K5's time on sampe's own rows and the rows it walked
    recorded for K5's bound; then the rates, ROUNDS rounds of the two
    routes in turns on the first RATE_PAIRS pairs, untraced, SAM
    byte-equal in every round; then `samse` on end 1: one line per read.
    Returns K5's row of the kernel table from this path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.fm import walk
    sais = [WORK / f"pairs_{e}.sai" for e in (1, 2)]
    for fq, out in zip(fqs, sais):
        kernels.reset_launches()
        st = run_aln([str(fa), str(fq), "--device", "cuda"], out)
        log(f"aln --device cuda {fq.name}: {st['reads'] / st['search_s']:.1f} "
            f"reads/s of search wall, {st['reads'] / st['wall_s']:.1f} end "
            f"to end; device reads {st['device_reads']}, fallback "
            f"{st['fallback_reads']}, host share {st['host_reads']}; "
            f"launches {dict(kernels.launches)}")
    routes = {"native": ["-R", "--engine", "native"],
              "device": ["-R", "--device", "cuda"]}
    args = [str(fa), *map(str, sais), *map(str, fqs)]
    sam = {name: WORK / f"pairs_{name}.sam" for name in routes}

    # all the pairs: the SAM, K5's launches and time, and the rows it walks
    native_s, _, _ = sampe_run(routes["native"] + args, sam["native"], False)
    calls, resolve = [], walk.DeviceWalker.resolve

    def recorded(self, strand, rows):
        calls.append((self, np.array(strand), np.array(rows)))
        return resolve(self, strand, rows)

    walk.DeviceWalker.resolve = recorded
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced_s, prefill, launches = sampe_run(
                routes["device"] + args, sam["device"], True)
    finally:
        walk.DeviceWalker.resolve = resolve
    want = sam["native"].read_bytes()
    if sam["device"].read_bytes() != want:
        raise AssertionError("sampe SAM with K5's walks differs from the "
                             "host walks'")
    recs = [ln.split(b"\t") for ln in want.splitlines() if ln[:1] != b"@"]
    mapped = sum(1 for f in recs if not int(f[1]) & 4)
    if len(recs) != 2 * N_PAIRS or mapped < N_PAIRS:
        raise AssertionError(f"sampe: {len(recs)} records, {mapped} mapped")
    mean_us = [e.self_device_time_total / e.count
               for e in prof.key_averages()
               if "lf_walk_kernel" in e.key and e.count]
    if not mean_us:
        raise AssertionError("the trace saw no lf_walk launch")
    k5_ms = mean_us[0] * launches["lf_walk"] / 1e3
    walker = calls[0][0]
    if any(c[0] is not walker for c in calls):
        raise AssertionError("one db, so one walker")
    t = lambda a: torch.from_numpy(a.astype(np.int64)).to(walker.fm.device)
    fp = walk_footprint(walker.fm, [(t(s), t(r)) for _, s, r in calls],
                        walker.sa_intv - 1, walker.lanes)
    wpb = walker.fm.wpb
    del calls, walker
    rows = sum(int(b[0]) for b in prefill)
    bd = walk_bound(rows, fp, wpb)
    lat_ms = fp["chain"] * warp_us / 1e3
    per_batch = " + ".join(f"{int(b[0])} rows in {int(b[1])} dispatches, "
                           f"{b[4]:.4f} s" for b in prefill)
    log(f"sampe -R on {N_PAIRS} pairs: SAM byte-equal between K5's walks "
        f"and the host walks ({len(want)} bytes, {len(recs)} records, "
        f"{mapped} mapped); host walks {native_s:.3f} s; K5's walks under "
        f"the profiler {traced_s:.3f} s (no rate: traced), the prefill "
        f"{per_batch}, no row left to the host walks; K5 "
        f"{launches['lf_walk']} launches, device ms "
        f"{k5_ms:.5f}; its walks {fp['steps']} LF steps "
        f"({fp['steps'] / rows:.2f} a row) over {fp['rows']} distinct table "
        f"rows of {fp['row_bytes']} B, the longest walk of each dispatch "
        f"summed {fp['chain']}; byte bound {bd['bound_ms']:.5f} "
        f"({bd['bound_by']}), latency bound {fp['chain']} x {warp_us:.3f} us "
        f"= {lat_ms:.5f} ms")

    # the rates: the first RATE_PAIRS pairs, ROUNDS rounds in turns
    sub_fq = [WORK / f"rate_pairs_{e}.fq" for e in (1, 2)]
    sub_sai = [WORK / f"rate_pairs_{e}.sai" for e in (1, 2)]
    for fq, sfq, sai_ in zip(fqs, sub_fq, sub_sai):
        first_reads(fq, RATE_PAIRS, sfq)
        run_aln([str(fa), str(sfq), "--device", "cuda"], sai_)
    args = [str(fa), *map(str, sub_sai), *map(str, sub_fq)]
    walls = {name: [] for name in routes}
    pre_s, want = [], None
    for r in range(ROUNDS):
        for name in routes if r % 2 == 0 else list(routes)[::-1]:
            wall, batches, _ = sampe_run(routes[name] + args, sam[name],
                                         name == "device")
            walls[name].append(wall)
            if batches:
                pre_s.append(sum(b[4] for b in batches))
        sams = {name: sam[name].read_bytes() for name in routes}
        if sams["device"] != sams["native"]:
            raise AssertionError(f"round {r}: sampe SAM with K5's walks "
                                 f"differs from the host walks'")
        if want is not None and sams["native"] != want:
            raise AssertionError(f"round {r}: sampe SAM differs from round 0")
        want = sams["native"]
    n = 2 * RATE_PAIRS
    share = [p / w for p, w in zip(pre_s, walls["device"])]
    log(f"sampe -R on the first {RATE_PAIRS} pairs, {ROUNDS} rounds in "
        f"turns, no profiler: SAM byte-equal in every round; reads/s with "
        f"K5's walks {spread([n / w for w in walls['device']])}, with the "
        f"host walks {spread([n / w for w in walls['native']])}; the "
        f"prefill {' / '.join(f'{p:.4f}' for p in pre_s)} s = "
        f"{' / '.join(f'{x:.4f}' for x in share)} of the run")
    out = WORK / "pairs_1.samse.sam"
    wall, _ = run_cli("samse", [str(fa), str(sais[0]), str(fqs[0])], out)
    lines = out.read_bytes().splitlines()
    head = sum(1 for ln in lines if ln[:1] == b"@")
    if len(lines) - head != N_PAIRS or head < 2:
        raise AssertionError(f"samse: {len(lines)} lines, {head} of header, "
                             f"for {N_PAIRS} reads")
    log(f"samse on end 1: exit 0, {head} header lines + {N_PAIRS} records, "
        f"{N_PAIRS / wall:.1f} reads/s end to end ({wall:.3f} s)")
    return {"launches": launches["lf_walk"], "sampe_ms": k5_ms,
            "sampe_rows": rows, "sampe_steps": fp["steps"],
            "sampe_rows_fetched": fp["rows"], "sampe_bound_ms": bd["bound_ms"],
            "sampe_bound_by": bd["bound_by"], "sampe_latency_bound_ms": lat_ms}


SOURCES = {
    "search_step": ("ibwa_tpu_torch/csrc/search_step.cu",
                    "ibwa_tpu/align/engine_jax.py:243"),
    "stack_update": ("ibwa_tpu_torch/csrc/stack_update.cu",
                     "ibwa_tpu/align/stack_kernel.py:115"),
    "occ4_pair": ("ibwa_tpu_torch/csrc/occ.cu", "ibwa_tpu/fm/device.py:334"),
    "occ1_pair": ("ibwa_tpu_torch/csrc/occ.cu", "ibwa_tpu/fm/device.py:430"),
    "chase": ("ibwa_tpu_torch/csrc/chase.cu", "scripts/bench_chase.py:168"),
    "chase_mw": ("ibwa_tpu_torch/csrc/chase.cu",
                 "scripts/bench_chase.py:258"),
    "lf_walk": ("ibwa_tpu_torch/csrc/lf_walk.cu", "ibwa_tpu/fm/walk.py:78"),
    "width_pass": ("ibwa_tpu_torch/csrc/width_pass.cu",
                   "ibwa_tpu/align/engine_jax.py:164"),
    "lane_switch": ("ibwa_tpu_torch/csrc/lane_switch.cu",
                    "ibwa_tpu/align/engine_jax.py:775"),
    "search_chunk": ("ibwa_tpu_torch/csrc/search_chunk.cu",
                     "ibwa_tpu/align/engine_jax.py:888"),
}
# kernels whose device code runs on the aln path as a stage of another
# kernel's launch (their own entries stay, for the check and the plain
# versions)
WITHIN = {"stack_update": "search_step", "occ4_pair": "search_step",
          "occ1_pair": "width_pass", "search_step": "search_chunk",
          "lane_switch": "search_chunk"}
# the kernels a chunk of aln launches, once each, and the most launches of
# any kind (allocations, uploads, the counters' copy, downloads included) a
# chunk may make between its upload and its download
ALN_KERNELS = ("width_pass", "search_chunk")
MAX_LAUNCHES_PER_CHUNK = 40


def host_kernel(name: str) -> str:
    """The kernel whose launches carry `name`'s device code on the aln
    path: `name` itself, or the end of its chain in WITHIN."""
    while name in WITHIN:
        name = WITHIN[name]
    return name


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this check runs on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    global CARD
    CARD = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build: nvcc and g++ side by side
    from ibwa_tpu_torch import kernels, native
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.load)
        kernels.lib()
        info = kernels.build_info
        log(f"kernels built in {info['seconds']:.1f} s -> {info['path']}")
        host_lib.result()
    log(f"native host library ready; both builds {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"\d+([a-z_]+_kernel)(?:I(\w+?)EEv)?", line)
            entry = f"{found.group(1)}<{found.group(2) or ''}>" if found \
                else line.split("'")[1][-40:]
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry}: {line.split(' : ')[-1].strip()}")

    # ---- 3. kernel vs plain version (K2 and K5 need the aln path's index)
    fa, fq = make_inputs()
    from ibwa_tpu_torch import bench_chase
    from ibwa_tpu_torch.fm.device import build_device_pair
    from ibwa_tpu_torch.fm.fmindex import FmIndex
    from ibwa_tpu_torch.index.builder import load_index
    fms = (FmIndex(load_index(str(fa), 0)), FmIndex(load_index(str(fa), 1)))
    fm = build_device_pair(fms[0], fms[1], dev)
    chunk = smoke_chunk(fms, fq, dev)
    stamp = lambda what: log(f"{what} done at "
                             f"{time.perf_counter() - t_start:.0f} s")
    stamp("inputs")
    rows = {"stack_update": check_stack(dev), **check_occ(fm, dev),
            "width_pass": check_width_pass(fm, chunk)}
    stamp("K1, K2, K6 checks")
    rows["search_step"] = check_search_step(fm, chunk)
    stamp("search_step check")
    rows["lane_switch"], switch_cases = check_lane_switch(fm, chunk)
    stamp("lane_switch check")
    rows["search_chunk"] = check_search_chunk(fm, chunk, switch_cases)
    stamp("search_chunk check")
    del switch_cases
    tables = {label: bench_chase.make_table_device(n, w, SEED, dev)
              for label, n, w in PROBE_TABLES}
    rows.update(check_chase(tables, dev))
    rows["lf_walk"] = check_walk(fms, dev)
    log(f"kernel checks done at {time.perf_counter() - t_start:.0f} s")

    # ---- 4a. the probe
    kernels.reset_launches()
    records = run_probe(tables)
    launches = dict(kernels.launches)
    del tables
    torch.cuda.empty_cache()
    (WORK / "probe.json").write_text(json.dumps(
        {"device": smi, "results": records}, indent=1))
    # the latency bound of the chained kernels: a lane's fetches are
    # dependent, so a launch takes at least (steps of its longest chain) x
    # (one warp's marginal time per step on that table)
    warp_us = {r["table"]: r["marginal_us_per_step"] for r in records
               if r["variant"] == "chase" and r["lanes"] == 32}
    longest = rows["lf_walk"].pop("_longest")
    rows["lf_walk"]["latency_bound_ms"] = longest * warp_us["b"] / 1e3
    # a search step's occ4 rows depend on the pop the step before left, and
    # the E-chain's occ1 rows on them: 1 to E_UNROLL dependent fetches
    from ibwa_tpu_torch.align import engine
    step_lat = rows["search_step"]["steps_per_launch"] * warp_us["b"] / 1e3
    rows["search_step"]["latency_bound_ms"] = step_lat
    # a base's two rows depend on the interval the base before left
    chain = rows["width_pass"].pop("_longest")
    rows["width_pass"]["latency_bound_ms"] = chain * warp_us["b"] / 1e3
    log(f"width_pass latency bound: longest chain {chain} bases x one "
        f"dependent fetch {rows['width_pass']['latency_bound_ms']:.5f} ms")
    log(f"one-warp dependent fetch, us/step: {warp_us}; latency bounds: "
        f"K3/K4 table c {PROBE_STEPS} steps "
        f"{PROBE_STEPS * warp_us['c'] / 1e3:.5f} ms; K5 longest walk "
        f"{longest} steps on the smoke table's shape "
        f"{longest * warp_us['b'] / 1e3:.5f} ms; search_step "
        f"{engine.SWITCH_K} steps x 1 to {engine.E_UNROLL} dependent fetches "
        f"{step_lat:.5f} to {engine.E_UNROLL * step_lat:.5f} ms")
    # a chunk launch is as long as its slowest lane
    lane = rows["search_chunk"].pop("_longest")
    rows["search_chunk"]["latency_bound_ms"] = lane * warp_us["b"] / 1e3
    log(f"search_chunk latency bound: the longest lane's {lane} iterations "
        f"x 1 to {engine.E_UNROLL} dependent fetches "
        f"{lane * warp_us['b'] / 1e3:.5f} to "
        f"{engine.E_UNROLL * lane * warp_us['b'] / 1e3:.5f} ms")

    # ---- 4b. the walker on random rows (its launches on its path are
    # sampe's, 4d)
    run_walker(fms, dev)
    stamp("probe and walker")

    # ---- 4c. aln
    aln_launches, hybrid_launches = run_aln_paths(fa, fq)
    for path, counts in (("device-only", aln_launches),
                         ("hybrid", hybrid_launches)):
        for name in ALN_KERNELS:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{path} path ({counts})")
        if set(counts) - set(ALN_KERNELS):
            raise AssertionError(f"the {path} path launched kernels that "
                                 f"are stages of others there: {counts}")
    chunks = -(-N_READS // engine.PERSIST_N)
    if aln_launches != dict.fromkeys(ALN_KERNELS, chunks):
        raise AssertionError(f"device-only aln of {N_READS} reads is "
                             f"{chunks} chunks, one launch of each kernel "
                             f"per chunk, not {aln_launches}")
    profile_chunk(fms, fm, chunk)
    launches.update(aln_launches)
    stamp("aln")

    # ---- 4d. a whole aln batch dispatched ahead (C1), then sampe and
    # samse on the pairs
    fqs = make_pairs(fa)
    check_dispatch_ahead(fms, fqs, dev)
    stamp("C1 check")
    del fms, fm, chunk
    torch.cuda.empty_cache()
    sampe_row = run_sampe_phase(fa, fqs, warp_us["b"])
    launches["lf_walk"] = sampe_row.pop("launches")
    rows["lf_walk"].update(sampe_row)
    for name in WITHIN:
        launches[name] = launches.get(host_kernel(name), 0)
    for name in rows:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on its "
                                 f"path ({launches})")
    log(f"launches on the paths: {launches}; all phases "
        f"{time.perf_counter() - t_start:.0f} s")

    # ---- 5. result lines
    table = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
              "replaces": SOURCES[name][1], "launches": launches[name], **r,
              **({"within": WITHIN[name]} if name in WITHIN else {})}
             for name, r in rows.items()]
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
