"""Smoke test of ibwa_tpu_torch on one CUDA card: builds the kernels,
checks each against its plain PyTorch version, and drives every path of
the port end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --large-table GBP   # phase 4h alone, at GBP Gbp
    python3 chip_smoke.py --input-routes      # phase 4k alone
    python3 chip_smoke.py --tall-table        # phase 4l alone

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
     left; K8 search_chunk (one launch per chunk, every lane the card
     holds taking reads from a queue; its step and switch stages are the
     device code of the two before) on the smoke chunk against the plain
     loop and against the loop of the phased kernels, against the latter
     also on the `bad`, `tail` and `all` inputs of `engine.switch_cases`,
     at ACAP 1024 and on grids of 1, 33 and 132 blocks, with and without
     its prefetch: hit counts, fallback flags and causes, the step count
     (`engine.finish_chunk` from the reads' own iterations) and the hits
     below each count; its launch shape, its step loop's warp
     instructions in the SASS (`cuobjdump -sass`) for its operations and
     issue bounds; its first version (`search_chunk_first.cu`)
     against the plain loop and timed in turns with it at ACAP 256 and
     1024; `ibwa_tpu_torch.profile_step`'s stage clocks and lane counts of
     both; and the cap sweep (iter_cap 384, 1,536, 6,144 x ACAP 256,
     1,024 through `EngineConfig`: bitwise equal to the plain loop, every
     read kept on the card equal to the host search's hits, ms, fallback
     by cause, longest read); K3
     chase and K4 chase_mw (W=4) on the probe's three tables; K5 lf_walk
     (one persistent launch from SA intervals to SA values) on 131,072
     random rows plus the edge rows as intervals of width 1 and on 20,000
     random intervals of widths 1 to 256, at block intervals 32, 64 and
     128, and its first version (one thread a row, (add, kfin) out) on the
     random rows; on the random rows at 64 the two timed in turns
  4. the paths, each with the launch counts set to 0 just before it and
     read just after:
     a. the dependent-gather probe (`bench_chase.probe`) on three tables
        made on the card: 500,000 x 128 words (256 MB, the TPU probe's
        shape), 1,000,000 x 8 words (32 MB, the smoke table's shape:
        read at random it is met in HBM, the L2 keeps ~8-16 MB of it) and
        64,000,000 x 8 words (2 GB: a human-scale block table)
     b. the SA walker: `DeviceWalker.resolve` on 2,097,152 random
        (strand, row) pairs of the smoke index in one wave, equal to the
        native host `sa_lookup` (K5's launches on its path are sampe's, 4d)
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
        the pairs, SAM byte-equal, its intervals recorded, launching
        lf_walk and nothing else, once a wave, with 0 values refused by the
        walk cache and 0 host walks; K5 on the run's recorded intervals
        against its plain version and timed beside its first version's
        loop of 131,072-row dispatches, in turns; the rates on the first
        32,768 pairs, three rounds of the two in turns, untraced, SAM
        byte-equal in every round; the same pairs in 4 batches (sampe.BATCH
        lowered), SAM byte-equal to --engine native at that size, 0 host
        walks and 0 refused values in every batch; and `samse` on end 1,
        one line per read
     e. `bwasw`: K9 extend_dp (the redesign: a warp a job, the band's
        window on a ring in shared memory, four cells a lane) against its
        plain version, bitwise (its counters too, and the mode every job
        ran on), on tests/test_dp_device.py's job shapes, on jobs beyond
        the JAX package's caps (targets to 8,000, queries to 3,000) and on
        bands of 200 (several passes of the warp a row, on the rings) and
        700 (the second mode, the rows in global memory), the last two
        with its first version too, a sample of each against the host
        kernel; the launch's shape in each mode; 4,096 long reads
        of the smoke genome (400-999 bp, 2% substitutions, half
        reverse-complemented; one 10 Mbp chunk, four staged segments, a
        left and a right batch each), `bwasw --engine torch --device cuda`
        against `--engine native`, two rounds in turns, SAM byte-equal
        in each, rates as median and range, the stage split of each run;
        the torch route launches extend_dp and nothing else, once a batch,
        8 batches, and every job it leaves to the host is a counted gate,
        under-minimum or empty one; the native route launches nothing; the
        first torch run's batches recorded: K9 and its first version
        against the plain version on the first left and right batch, every
        batch timed with the redesign and the first version in turns (new,
        first, first, new; the two bitwise equal) beside its bounds (bytes,
        operations, and the longest job's rows x one row's chain, measured
        on one job for each design), and on the first left batch in the
        driver's job order against longest query first, in turns; the
        staged native driver against the sequential one on the first 1,024
        reads, SAM byte-equal (and to the CLI run's records of them), the
        core's section timers on in both
     f. several devices (B8; run after c, on the smoke chunk and reads):
        the block table split by rows into 2 and 4 ranges on this card
        (`shard_pair`, each range an allocation of its own); the sharded
        instantiations of width_pass and search_chunk against the flat
        ones (both step modes) and against their plain versions over the
        split table, bitwise, then timed in turns with the flat ones
        (flat, 2, 4, 4, 2, flat); `aln` device-only over `--device cuda:0`,
        `--device cuda:0,cuda:0` (two entries: reads split, a table and a
        stream each) and `--device cuda:0,cuda:0 --idx 2` (one entry over a
        split table), three rounds in turns, every .sai byte-equal to
        `--engine native`'s, one width pass and one chunk search launch per
        entry and chunk (the split run's through the sharded
        instantiations, whose launches B8's rows count); with several
        cards the same over cuda:0,cuda:1 (peer reads), else a line saying
        it was not run
     g. the scale configurations (`ibwa_tpu_torch/parity_scale.py`, full
        scale, through the port's CLI; run after e, with the launches of
        its commands counted on a line of their own): ecoli_seam (aln
        device-only, hybrid and native on 0x40000 + 16,384 pairs, two
        batches an end, .sai byte-equal, the hybrid's host share a batch;
        sampe -R with K5's walks and the host walks over two batches, SAM
        byte-equal, 0 host walks and 0 refused values a batch; samse on
        mate 1 over two batches, a record a read in read order),
        repeat_pe (a 32 Mbp repeat-rich genome: aln .sai byte-equal,
        sampe -R SAM byte-equal on SA intervals thousands of rows wide,
        K5 in waves of 1,048,576 rows bitwise equal to the run's one
        wave), iterative_remap (a 63 Mbp primary and an alternate
        reference of haplotypes with .remap CIGARs: four .sai byte-equal,
        the alternate's at ACAP 1024; sampe -R over the two dbs SAM
        byte-equal with ZR tags, a walker a db in DbSet order, lf_walk
        once a db, batch and wave; the two routes' rates, three rounds in
        turns) and aln_options (five option sets and mixed read lengths,
        .sai byte-equal, the gappy and nonstop sets at ACAP 1024); then K5
        on repeat_pe's recorded intervals against its plain version and
        the run's values, bitwise, timed beside its bounds, and the width
        pass and the chunk search timed on the CLI path (a profiler
        session around `aln`) at ACAP 1024 (the gappy set) and the card's
        (the default, `engine.caps`) on the same reads; every device
        `aln`'s overflow fallback by cause
     h. a large table (`ibwa_tpu_torch/index_3gbp.py` at 0.125 Gbp, run
        after g, with the launches of its commands counted on a line of
        their own): scripts/index_3gbp.py's 32-contig genome generated and
        indexed by the port in a child process (wall, peak RSS, artifact
        bytes); 16,384 pairs: aln device-only, hybrid and native on both
        ends (.sai byte-equal, one width pass and one chunk search a
        chunk, `engine.caps`' arena, the fallback share), the rates of
        end 1 in three rounds in turns, sampe -R with K5's walks against
        the host walks (SAM byte-equal, 0 host walks and 0 refused
        values, records on several contigs and above 2^26 in the packed
        text), the table's
        bytes and seconds and the card's peak memory of each command;
        then K5 on sampe's recorded intervals (`k5_on_run`), and K6 and
        K8 on the first 2,048 reads of end 1 over the 125 MB table bitwise
        against their plain versions and timed in turns with the smoke's
        32 Mbp chunk, beside their bounds (latency at table (c)'s step),
        K8's fallback split by cause, and the cap sweep on that chunk
        against the phased kernels' loop
     i. the port's bench (`ibwa_tpu_torch/bench.py`, run after h, with the
        launches of its commands counted on a line of their own): full
        scale, one round, on its own inputs (`bench.py`'s recipe, cached
        under .bench/bench_torch/full/): `aln` hybrid, device-only and
        native on 16,384 reads (.sai byte-equal), `sampe -R` K5 against
        the host walks on 50,000 pairs, `samse`, `bwasw` K9 against the
        host extensions on 1,500 long reads (SAM byte-equal); exit 0, the
        record's keys, `aln` launching width_pass and search_chunk alone,
        one each a chunk, and the counters equal to the bench's own count
     j. `aln` as two processes on the one card (`ibwa_tpu_torch/dist_aln.py`,
        run after i, the workers' launches counted on a line of their
        own): scripts/dist_aln.py's 40,000-read corpus (scripts/
        parity_scale.py's recipe, cached under .bench/dist_aln_torch/),
        two worker processes on cuda:0 over its two FASTQ shards and one
        over the whole FASTQ, device-only: exit 0, the merged .sai
        byte-equal to the one process's and that to --engine native's,
        every worker launching width_pass and search_chunk once a chunk
        of its reads and nothing else (its counters set to 0 at its
        `go`), this process launching nothing; the one round's aggregate
        rates of one and of two processes
     k. the input routes (`ibwa_tpu_torch/input_routes.py`, run after j,
        the launches of its commands counted on a line of their own): j's
        4.6 Mbp genome soft-masked (30% lower case) with 0.3% IUPAC codes
        and indexed by the port; 65,536 pairs of 100 bp from it, 5% of
        each end's reads with an N run: `aln` device-only against native
        on both ends, `samse` from both .sai, `sampe -R` K5 against the
        host walks; end 1 under `-q 20 -I` (offset-64 qualities with
        decaying tails) and `-B 5` (a 5-base barcode); BAM of 0x40000 +
        4,096 records under `-b` (two batches) and its first 32,768 under
        `-b -1` and `-b -2`; a primary and two alternates of haplotypes
        with `.remap` CIGARs, `aln` of 32,768 pairs against each and
        `sampe -R` over the three dbs (one walker a db in DbSet order);
        every device route byte-equal to the host route, reads on the
        card in each `aln`, K6 and K8 once a chunk, K5 once a db and wave,
        0 host walks and 0 refused values; then K5's u32 route above 2^31
        (both sampled arrays shifted, `DeviceWalker.from_table`) bitwise
        equal to the native host walk plus 2^31.  A line a route: reads,
        device reads, fallback by cause, launches, the native search's
        host threads, seconds
     l. the lifted tables (`ibwa_tpu_torch/tall_table.py`, run after k,
        the launches of its aln commands counted on a line of their own):
        the smoke's index with m rows of A put before each strand's BWT,
        `straddle` (m = 2^31 - 2^24: its rows cross 2^31) and `top`
        (seq_len' = 2^32 - 2, the most the index admits), no suffix array
        built; the smoke's 16,384 reads after three reads of A's (their
        exact hit spans the padding, 2^31 rows and more on top, beside
        hits of one mismatch): `aln` device-only, hybrid and native,
        .sai byte-equal, and on straddle `aln --idx 2` over the table
        split in two on this card; the hits at and above 2^31; the walker
        (K5) on the run's intervals of at most 256 rows and on 200,000
        random intervals at and above 2^31, bitwise equal to the native
        host walk, then timed beside its bounds (`k5_on_run`); K6 and K8
        on the first 2,048 reads bitwise against their plain versions,
        the occ bounds the plain versions fetched at and above 2^31
        counted, timed in turns with the smoke's chunk; K8 at ACAP 1024
        and iter_cap 6,144 against the phased kernels, every read it keeps
        (the probes among them) decoded equal to the host search's hits;
        on straddle the split table's K6 and K8 bitwise against the flat
        ones.  Every count at and above 2^31 must be above 0
     Every line of a native rate (4c, 4g, 4i, 4j) names the host threads
     of the native search it ran with (`native.get_threads()`: the CLI's
     `-t`, default 1; one in the bench).
     Every kernel must have launched on its path; the step and the switch
     run there as stages of search_chunk, K1's and K2's occ4 code as
     stages of the step, and K2's occ1 code as a stage of width_pass,
     whose launches they carry.
  5. the result lines: the card, the kernel table (B8 as the rows
     width_pass_sharded and search_chunk_sharded), and the contract line

Every line of the log after the card is known names the card and its power
limit.

`bound_ms` of the kernel table is the least time the card could take for
the call: the larger of the bytes the call must move over 3.35 TB/s and
its integer operations over the card's 32-bit integer rate: 64 a clock an
SM (add, subtract, compare, min, max on compute capability 9.0, the CUDA
C++ Programming Guide's table of arithmetic instruction throughput) times
the SMs times `nvidia-smi --query-gpu=clocks.max.sm`, read in the run
(~16.7 Tops/s at 132 SMs and 1,980 MHz);
for the data-dependent kernels it counts the rows this run fetched (for
lf_walk each distinct table row and sampled word once, `walk_footprint`,
on the intervals `sampe` gave it).  The chained
kernels (chase, lf_walk, search_step, search_chunk, width_pass) also get a
latency bound: their dependent fetches times the one-warp step the probe
measured.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
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
AB_READS = 1024                 # bwasw's staged-sequential A/B (a quarter
                                # of the reads, for the smoke's time)
BWASW_ROUNDS = 2                # of bwasw's rates, in turns: two, so
                                # that the whole smoke stays inside its
                                # call's time
B_LANES = 1024
WALK_PAIRS = 2_097_152          # one wave of the walker
OLD_DISPATCH = 131_072          # rows a dispatch of K5's first version
MANY_BATCHES = 4                # sampe batches of the RATE_PAIRS run
N_LONG = 4096                   # bwasw's long reads: one 10 Mbp chunk, four
                                # staged segments of 1,024 reads
EXT_OPS_PER_CELL = 18           # K9's integer operations a cell: the host
                                # loop's body (core.cpp, ibwa_extend_aln)
                                # counted, its own loop counter left out
PROBE_STEPS, PROBE_DELTA = 256, 2048
PROBE_LANES = [32, 256, 1024]   # 32: one warp, the fetch latency itself
PROBE_TABLES = [("a", 500_000, 128),      # the TPU probe's shape, 256 MB
                ("b", 1_000_000, 8),      # the smoke table's shape, 32 MB
                ("c", 64_000_000, 8)]     # human scale, 2 GB
TRACE_TRIES, TRACE_PAUSE_S = 4, 0.25   # profiler sessions, and the pause
                                       # before each one after the first
HBM_BYTES_PER_S = 3.35e12
HIGH = 1 << 31                  # table rows and values from here on need
                                # all 32 bits of a bwtint_t (4l)
INT32_OPS_PER_CLOCK_SM = 64
INT_OPS_PER_S = INT32_OPS_PER_CLOCK_SM * 132 * 1.98e9   # set in main()
WARP_ISSUE_PER_CLOCK_SM = 4     # warp instructions: one a scheduler
WARP_ISSUE_PER_S = WARP_ISSUE_PER_CLOCK_SM * 132 * 1.98e9   # set in main()
EXT_FLOOR_SHARE = 0.9           # of a batch's least time (latency
                                # estimate, issue time): a K9 reading under
                                # it is a broken one
EXT_SLEEP_CYCLES = 20_000_000   # ~10 ms of the card ahead of K9's timed
                                # launches, while the host queues them
EXT_READS = ("new", "first", "first", "new", "new", "first")   # in turns
EXT_GRIDS = (1, 2, 3, 4, 6)     # blocks an SM K9's grid is timed at
MESH_IDX = (2, 4)               # row ranges the smoke splits the table in
MESH_TURNS = ("flat", 2, 4, 4, 2, "flat")   # B8's timing order
LARGE_GBP = 0.125               # 4h's genome: a 125 MB block table, 2.5x
                                # the L2 (0.25 Gbp until phase 4k came:
                                # `--large-table 0.25` runs it alone)
TABLE_TURNS = ("table", "smoke", "smoke", "table", "table", "smoke")
FIRST_TURNS = ("new", "first", "first", "new")   # K8 and its first version
PROFILE_LANES = (132, 264, 528, 1056, 2048)      # profile_step --mode lanes
SWEEP = [(acap, cap) for acap in (256, 1024)     # K8's caps on the card
         for cap in (384, 1536, 6144)]
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
    return out if sum(us for us, _ in out.values()) > 0 else {}


def traced(body, reps: int) -> dict:
    """`device_us` of a profiler session around body(), which makes `reps`
    equal calls.  On the H100 machine a trace loses the records made in a
    short window about every 10 s, up to three back-to-back sessions in a
    row (`python3 -m ibwa_tpu_torch.profiler_probe`), so a session that
    saw nothing is made again after a pause, up to TRACE_TRIES sessions in
    all; {} if none saw anything, and the caller then times with CUDA
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, TRACE_TRIES + 1):
        if attempt > 1:
            time.sleep(TRACE_PAUSE_S)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        out = device_us(prof, reps)
        if out:
            return out
        log(f"the profiler saw no device time in session {attempt} of "
            f"{TRACE_TRIES}")
    return {}


def event_ms(fn, reps: int) -> float:
    """ms per call of fn over `reps` calls: the CUDA-event span of the
    calls, which at small sizes is set by the host launching them."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) per call of fn over `reps` calls, after one
    warm-up call.  Device ms is the summed time of the kernels one call
    runs (torch.profiler, `traced`); call ms is `event_ms`, which stands
    in for device ms where the profiler saw nothing."""
    import torch
    fn()
    torch.cuda.synchronize()
    call_ms = event_ms(fn, reps)

    def body():
        for _ in range(reps):
            fn()

    dev = traced(body, reps)
    if not dev:
        log(f"device ms {call_ms:.5f} is the CUDA-event span of {reps} calls")
        return call_ms, call_ms
    return sum(us for us, _ in dev.values()) / 1e3, call_ms


def inputs(make, reps: int):
    """An iterator of fresh inputs, one for every call `timed_ms(fn, reps)`
    can make, for an fn that changes the input it is given."""
    return iter([make() for _ in range(1 + reps * (1 + TRACE_TRIES))])


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def int_ops_per_s(dev) -> tuple[float, float]:
    """The card's 32-bit integer rate: INT32_OPS_PER_CLOCK_SM x its SMs x
    its SM clock at most (`nvidia-smi --query-gpu=clocks.max.sm`); and its
    warp instruction issue rate, WARP_ISSUE_PER_CLOCK_SM in place of the
    integer operations."""
    import torch
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = INT32_OPS_PER_CLOCK_SM * sms * float(mhz) * 1e6
    issue = WARP_ISSUE_PER_CLOCK_SM * sms * float(mhz) * 1e6
    log(f"32-bit integer rate {rate / 1e12:.3f} Tops/s: "
        f"{INT32_OPS_PER_CLOCK_SM} a clock an SM x {sms} SMs x {mhz} MHz "
        f"(clocks.max.sm); warp instructions issued at most "
        f"{issue / 1e12:.4f} T/s ({WARP_ISSUE_PER_CLOCK_SM} a clock an SM)")
    return rate, issue


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
        if acap == 256:   # the CPU route's arena at 32 Mbp
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
    chunk: its config at the CPU route's caps (`cfg`: ACAP 256, iter_cap
    384, the shape the stage kernels' checks start from) and at the caps
    the engine takes on `dev` (`card_cfg`, `engine.caps`), the read lists,
    and `run_search_persistent`'s read arguments on the card (the same at
    both caps)."""
    from ibwa_tpu_torch.align import engine, pipeline
    from ibwa_tpu_torch.align.opts import GapOpt
    opt = GapOpt()
    reads = pipeline._load(str(fq), opt)[:engine.PERSIST_N]
    seqs, rseqs = [r.seq for r in reads], [r.rseq for r in reads]
    cfg, lens, md = engine.batch_config(seqs, opt, fms[0].seq_len)
    card_cfg = engine.batch_config(seqs, opt, fms[0].seq_len, dev.type)[0]
    return {"cfg": cfg, "card_cfg": card_cfg, "opt": opt, "seqs": seqs,
            "rseqs": rseqs, "fms": fms,
            "args": engine.pack_chunk(cfg, seqs, rseqs, lens, md,
                                      opt.seed_len, dev)}


def check_search_step(fm, chunk: dict, sass: dict) -> dict:
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
            pool = inputs(lambda: engine.clone_state(st), reps)
            ms[n], _ = timed_ms(lambda: engine.search_steps(
                cfg, fm, seqs, next(pool), n), reps)
        pool = inputs(lambda: engine.clone_state(st), 2)
        plain_ms, _ = timed_ms(
            lambda: plain(cfg, seqs, next(pool), engine.SWITCH_K), 2)
        # what these SWITCH_K steps must move, from the states they leave
        # (`step_work`): per lane-step two FM rows, a read base, two meta
        # words, the freed key and the next pop's entry; per E-chain fetch
        # two more rows and a base; five words per pushed child; per
        # recorded hit its three words and one strand's w / bid / meta row
        # in and out; and per launch the state once in (key rows, scalars)
        # and out (scalars).  Operations and issue: a lane-step that is not
        # its lane's last issues at least a completed step's instructions
        # (`sass_step_loop`'s min_step / min_int, K8's step loop: the same
        # search_step.cuh), the integer ones on 32 threads.
        work = step_work(cfg, fm, seqs, st, engine.SWITCH_K)
        lane_steps, pushes = work["lane_steps"], work["pushes"]
        hits, e_fetches = work["hits"], work["e_fetches"]
        P = cfg.L + cfg.SL + 2
        row_b = 4 * (4 + fm.wpb)
        moved = (lane_steps * (2 * row_b + 1 + 2 * 8 + 4 + 4 * 4)
                 + e_fetches * (2 * row_b + 1)
                 + pushes * 5 * 4 + hits * (3 * 8 + 2 * 3 * P * 8)
                 + B_LANES * (acap * 4 + 2 * 15 * 8))
        done = max(lane_steps - B_LANES, 0)
        ops = done * sass["new"]["min_int"] * 32
        b = bound(moved, ops)
        issue = issue_ms(done * sass["new"]["min_step"])
        log(f"search_step B={B_LANES} ACAP={acap} on {name}: device ms per "
            f"launch {ms[1]:.5f} at 1 step, {ms[engine.SWITCH_K]:.5f} at "
            f"{engine.SWITCH_K} steps ({lane_steps} lane-steps, {pushes} "
            f"pushes, {hits} hits, {e_fetches} E-chain fetches); "
            f"{engine.SWITCH_K} plain steps {plain_ms:.5f}; bound "
            f"{b['bound_ms']:.5f} ({b['bound_by']}, {moved} bytes, {ops} "
            f"operations); issue {issue:.5f} ms")
        if acap == 256:   # the CPU route's arena at 32 Mbp
            row = {"max_abs_err": 0, "ms": ms[engine.SWITCH_K],
                   "plain_ms": plain_ms, **b, "library_ms": None,
                   "issue_ms": issue, "e_fetches": e_fetches,
                   "lane_steps": lane_steps, "ms_1_step": ms[1],
                   "steps_per_launch": engine.SWITCH_K}
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
    moved, ops, fetches, longest = width_work(cfg, fm, got, chunk["args"])
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(moved, ops),
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
        pool = inputs(first.clone, reps)
        ms, call_ms = timed_ms(lambda: next(pool).switch(), reps)
        pool = inputs(first.clone, 2)
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
        if acap == 256:   # the CPU route's arena at 32 Mbp
            row = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **b,
                   "library_ms": None}
    kernels.reset_launches()
    return row, cases256


def kernel_ms(us: dict, name: str) -> float:
    """Device ms per call of the kernels whose name holds `name`, from a
    `traced` dict."""
    return sum(v for key, (v, _) in us.items() if name in key) / 1e3


def launch_chunk(cfg, fm, args, mode: int, big=None, max_blocks: int = 0):
    """`engine._launch_search_chunk` on width planes of its own (the kernel
    updates them in place; `big`, else made here), in the kernel's `mode`:
    1 as the engine runs it, 0 without the step's rows asked ahead;
    `max_blocks` > 0 caps its grid below the card's resident blocks."""
    import torch
    from ibwa_tpu_torch.align import engine
    seqs, lens, md, hs, ssq, bad = args
    if big is None:
        big = engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
    return engine._launch_search_chunk(
        cfg, fm, seqs, big, lens, md, hs, bad,
        torch.cuda.current_stream().cuda_stream, mode, max_blocks)


def launch_first(cfg, fm, args, mode: int, big=None, n_lanes=B_LANES):
    """K8's first version (`engine._launch_search_chunk_first`, kept to be
    timed beside the redesign) over `n_lanes` static lanes, as
    `launch_chunk`."""
    import torch
    from ibwa_tpu_torch.align import engine
    seqs, lens, md, hs, ssq, bad = args
    if big is None:
        big = engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
    return engine._launch_search_chunk_first(
        cfg, fm, seqs, big, lens, md, hs, bad, n_lanes,
        torch.cuda.current_stream().cuda_stream, mode)


def time_search_chunk(cfg, fm, args, reps: int, mode: int,
                      key: str = "search_chunk_kernel",
                      first: bool = False) -> float:
    """Device ms of one K8 launch on the chunk `args` (the kernel whose name
    holds `key`; `first`: the first version's launch, whose kernel is
    search_chunk_first_kernel); where the profiler sees nothing, the
    CUDA-event span of the launches alone, on planes made before."""
    import torch
    from ibwa_tpu_torch.align import engine
    launch = launch_first if first else launch_chunk
    if first:
        key = key.replace("search_chunk", "search_chunk_first")
    launch(cfg, fm, args, mode)
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            launch(cfg, fm, args, mode)

    ms = kernel_ms(traced(body, reps), key)
    if ms > 0:
        return ms
    seqs, lens, md, hs, ssq, bad = args
    planes = iter([engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
                   for _ in range(reps)])
    ms = event_ms(lambda: launch(cfg, fm, args, mode, next(planes)), reps)
    log(f"{key} device ms {ms:.5f} is the CUDA-event span of {reps} "
        f"launches")
    return ms


def cause_split(cause, fb) -> dict:
    """{FB_* name: reads} of the reads at the host."""
    import torch
    from ibwa_tpu_torch.align import engine
    counts = torch.bincount(cause[fb].cpu(), minlength=len(engine.FB_CAUSES)
                            + 1).tolist()
    return dict(zip(engine.FB_CAUSES, counts[1:]))


def hold_search_chunk(fm, name, cfg, args, n_lanes, want, modes=(1, 0)):
    """K8 on the chunk `args`, finished as the engine finishes it
    (`engine.finish_chunk`, the step count over `n_lanes` lanes), against
    `want`, a plain or phased loop's (hits, n_hits, fb, steps, cause), in
    each step mode of `modes`: hit counts, fallback flags, the step count,
    the hits below each count and, where `want` has them (the plain loop),
    the fallback causes, bitwise.  Returns a line that names the case, and
    the last launch's finished outputs, with its `it` and counters."""
    import torch
    from ibwa_tpu_torch.align import engine
    for mode in modes:
        out_h, nh, fb, it, cause, counters = launch_chunk(cfg, fm, args,
                                                          mode)
        hits, nh, fb, steps, cause = engine.finish_chunk(
            out_h.permute(1, 2, 0), nh, fb, it, cause, n_lanes)
        got = [engine.masked_hits(hits, nh, fb), nh, fb.to(torch.int64)]
        ref = [engine.masked_hits(*want[:3]), want[1],
               want[2].to(torch.int64)]
        if want[4] is not None:
            got.append(cause)
            ref.append(want[4])
        err = max_abs_err(got, ref)
        if err or steps != want[3]:
            bad_in = [n for n, g, w in zip(("hits", "n_hits", "fb", "cause"),
                                           got, ref) if max_abs_err([g], [w])]
            raise AssertionError(
                f"search_chunk case {name} mode={mode}: kernel != its "
                f"plain version in {bad_in} (max abs err {err}); steps "
                f"{steps} vs {want[3]}")
    text = (f"{name} ({args[1].shape[0]} reads, steps {want[3]} over "
            f"{n_lanes} lanes, fallback {int(want[2].sum())}"
            + (f" {cause_split(want[4], want[2])}" if want[4] is not None
               else "") + ")")
    return text, (hits, nh, fb, steps, cause, it, counters)


INT_SASS = ("IADD3", "IADD", "IMAD", "ISETP", "IMNMX", "VIMNMX", "VIADD",
            "LOP3", "LOP", "SHF", "SHL", "SHR", "SEL", "POPC", "FLO", "LEA",
            "PRMT", "BMSK", "BREV", "SGXT", "IABS", "ICMP")


def sass_cfg(body: str):
    """The instructions of one function's SASS and each one's successors:
    (list of (address, mnemonic), {address: [successor addresses]}).  A
    branch goes to its target, and on to the next instruction too when it
    has a predicate or only splits a divergent warp (BRA.DIV); EXIT and
    RET end a path unless predicated."""
    ins = [(int(a, 16), pred.strip(), op, rest) for a, pred, op, rest in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9.]*)([^;]*);", body)]
    succ = {}
    for k, (a, pred, op, rest) in enumerate(ins):
        base, nxt = op.split(".")[0], (ins[k + 1][0] if k + 1 < len(ins)
                                       else None)
        conditional = bool(pred) and pred != "@PT"
        out = []
        if base == "BRA":
            t = re.search(r"(0x[0-9a-f]+)", rest)
            out = [int(t.group(1), 16)] if t else []
            if conditional or ".DIV" in op:
                out.append(nxt)
        elif base not in ("EXIT", "RET") or conditional:
            out = [nxt]
        succ[a] = [x for x in out if x is not None]
    return [(a, op.split(".")[0]) for a, _, op, _ in ins], succ


def sass_step_loop(so: str, wpb: int) -> dict:
    """K8's step loop in the SASS of the built library (`cuobjdump -sass`),
    for the engine's instantiation (search_chunk_kernel<wpb, prefetch, no
    clocks>) and the first version's.  The step loop is the largest loop
    inside the read loop.  Two counts of its warp instructions, and of
    them the integer ones (INT_SASS): `step_loop`, every instruction of
    its body once (a static count: the branches a step skips and its
    inner loops' repeats both make it no bound), and `min_step`, the
    fewest a completed step issues, the shortest path from the loop's
    head through the arena pass's reduction (REDUX) to its backward
    branch, inner loops once (a lower bound of every step that does not
    end its read).  Raises where the dump or the loops are not found."""
    from ibwa_tpu_torch import kernels
    tool = pathlib.Path(kernels._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for design, pat in (
            ("new", rf"\S*search_chunk_kernelILi{wpb}ELb1ELb0E"),
            ("first", rf"\S*search_chunk_first_kernelILi{wpb}ELb1ELb0E")):
        body = next((f for f in re.split(r"\n\s*Function : ", text)
                     if re.match(pat, f)), "")
        ins, succ = sass_cfg(body)
        ops = dict(ins)
        loops = [(t, a) for a, nxt in succ.items() for t in nxt
                 if t <= a and ops[a] == "BRA"]
        inside = lambda x, y: x != y and y[0] <= x[0] and x[1] <= y[1]
        steps = [x for x in loops if loops and inside(
            x, max(loops, key=lambda y: y[1] - y[0]))]
        if not steps:
            raise AssertionError(f"K8's SASS ({design}): no step loop inside "
                                 f"a read loop in {pat} ({loops})")
        head, latch = max(steps, key=lambda x: x[1] - x[0])
        red = next((a for a, op in ins if head <= a <= latch
                    and op == "REDUX"), None)
        if red is None:
            raise AssertionError(f"K8's SASS ({design}): no REDUX in the "
                                 f"step loop")

        def shortest(src, dst, weight):   # forward edges only: a DAG
            best = {a: math.inf for a, _ in ins if src <= a <= dst}
            best[src] = weight(ops[src])
            for a in sorted(best):
                for t in succ[a]:
                    if a < t <= dst and best[a] + weight(ops[t]) < best[t]:
                        best[t] = best[a] + weight(ops[t])
            return best[dst]

        body_ops = [op for a, op in ins if head <= a <= latch]
        out[design] = {"step_loop": len(body_ops),
                       "int": sum(op in INT_SASS for op in body_ops),
                       "entry": len(ins)}
        for key, w in (("min_step", lambda op: 1),
                       ("min_int", lambda op: int(op in INT_SASS))):
            out[design][key] = int(shortest(head, red, w)
                                   + shortest(red, latch, w) - w(ops[red]))
    log(f"K8's SASS at intv {16 * wpb}: {out}")
    return out


def chunk_work(cfg, fm, want, counters: dict, sass: dict
               ) -> tuple[int, int, int, int]:
    """The bytes, the operations and the warp instructions a chunk search
    must take, from this run's counters (`engine.COUNTERS`) and K8's SASS
    (`sass_step_loop`): the FM rows the steps needed (the occ4 bounds' and
    the E-chain's) and a read base per E-chain fetch; per lane iteration a
    read base and two meta words; per recorded hit its three words and one
    strand's w / bid / meta row in and out; per read its four scalars in
    and four words out.  The arena never leaves the SM.  Every iteration
    but a read's last completes a step, which issues at least `min_step`
    warp instructions, `min_int` of them integer ones on 32 threads each:
    (operations, instructions) at least; and at most the step loop's
    static count an iteration (the last value)."""
    P = cfg.L + cfg.SL + 2
    n = want[1].shape[0]
    hits = int(want[1][~want[2]].sum())
    total = counters["iterations"]
    moved = (counters["rows"] * 4 * (4 + fm.wpb) + counters["e_fetches"]
             + total * (1 + 2 * 8) + hits * (3 * 8 + 2 * 3 * P * 8)
             + n * (18 + 9 + 8))
    done = max(total - n, 0)
    return (moved, done * sass["min_int"] * 32, done * sass["min_step"],
            total * sass["step_loop"])


def issue_ms(instructions: int) -> float:
    """The least time the card takes to issue `instructions` warp
    instructions, WARP_ISSUE_PER_CLOCK_SM a clock an SM."""
    return instructions / WARP_ISSUE_PER_S * 1e3


def step_work(cfg, fm, seqs, st, n: int) -> dict:
    """What n plain steps from the lane state `st` did, counted from the
    states they start from and leave: lane-steps, pushes, recorded hits,
    and the E-chain's fetches (a lane that steps on an E entry with at
    least two bases left whose first base extends: the chain's next base
    needs one occ1 pair, as the step's E_UNROLL loop fetches it)."""
    import torch
    from ibwa_tpu_torch.align import engine
    from ibwa_tpu_torch.u32 import MASK
    st = engine.clone_state(st)
    occ1 = engine._occ(fm)[1]
    out = dict.fromkeys(("lane_steps", "pushes", "hits", "e_fetches"), 0)
    for _ in range(n):
        e_a, e_i = (st.pm1 >> 2) & 1, (st.pm1 >> 3) & 0x1FFF
        crid = torch.clamp(st.rid, 0, seqs.shape[0] - 1)
        base = seqs[crid, e_a, torch.clamp(e_i - 1, 0, cfg.L - 1)].to(
            torch.int64)
        c = torch.clamp(base, max=3)
        o = occ1(fm, 1 - e_a, st.pk, st.pl, c)
        k2, l2 = (fm.L2[c] + o[:, 0] + 1) & MASK, (fm.L2[c] + o[:, 1]) & MASK
        brk = (torch.zeros_like(st.fb) if cfg.nonstop else
               (st.pkey >> 20) > st.best_score + cfg.s_mm)
        nxt = engine._search_step(cfg, fm, seqs, st)
        act = ((nxt.lane_it > st.lane_it) & (nxt.lane_it <= cfg.iter_cap)
               & ~brk)
        fetch = (act & ((st.pm1 & 3) == engine.STATE_E) & (e_i > 1)
                 & (base < 4) & (k2 <= l2))
        out["lane_steps"] += int((nxt.lane_it - st.lane_it).sum())
        out["pushes"] += int((nxt.seqc - st.seqc).sum())
        out["hits"] += int((nxt.n_hits - st.n_hits).sum())
        out["e_fetches"] += int(fetch.sum())
        st = nxt
    return out


def width_work(cfg, fm, got, args) -> tuple[int, int, int, int]:
    """What the width pass must take on a chunk: (bytes, operations, bases
    fetched, the longest chain).  The three planes out, the bases, lengths
    and flags in, and two table rows per base that is one (an N or a
    position beyond the read fetches nothing); ~6 integer ops per word of
    a row and ~40 more per base."""
    import torch
    seqs, lens, _, has_seed, seed_seqs, _ = args
    pos = torch.arange(cfg.L, device=lens.device)
    main = (seqs < 4) & (pos[None, None, :] < lens[:, None, None])
    seed = (seed_seqs < 4) & has_seed[:, None, None]
    fetches = int(main.sum()) + int(seed.sum())
    moved = (nbytes(*got) + nbytes(seqs, seed_seqs, lens, has_seed)
             + fetches * 2 * 4 * (4 + fm.wpb))
    return (moved, fetches * (2 * fm.wpb * 6 + 40), fetches,
            int(main.sum(dim=2).max()))


def check_search_chunk(fm, chunk: dict, switch_cases: dict, sass: dict
                       ) -> dict:
    """K8 against its plain version, the phased loop, on the card, every
    launch finished as the engine finishes it (`engine.finish_chunk`, the
    step count over B_LANES lanes).  Against the plain loop
    (`engine.run_search_plain`, whose stages are the plain step and
    switch; on a card it reaches K1 and K2 through their wrappers): the
    smoke chunk, 2,048 reads, at the caps the engine takes on the card
    (`card_cfg`, the main path's shape) and at the CPU route's, the
    fallback's causes too.  Against the loop of the phased kernels
    (`engine.run_search_phased`): the same chunk at ACAP 256 and 1024, on
    grids of 1, 33 and 132 blocks (the queue's order must not matter), and
    the read inputs of the `bad`, `tail` and `all` cases of
    `engine.switch_cases`.  With and without the step's rows asked ahead:
    hit counts, fallback flags, the step count and the hits below each
    count, bitwise.  Then the launch's shape; the first version
    (`csrc/search_chunk_first.cu`) against the plain loop, and timed in
    turns with the redesign at ACAP 256 and 1024 (FIRST_TURNS); the stage
    and lane profiles of both (`ibwa_tpu_torch.profile_step`); the cap
    sweep (`cap_sweep`).  The row of the kernel table (ms, the plain
    loop's, the bounds, the longest read) is the card's caps'; the same
    readings at ACAP 256 stand beside it (`acap256`) with the first
    version's."""
    import torch
    from ibwa_tpu_torch import kernels, profile_step
    from ibwa_tpu_torch.align import engine
    cfg0, args0, cfgc = chunk["cfg"], chunk["args"], chunk["card_cfg"]
    seqs, lens, md, hs, ssq, bad = args0
    hold = lambda *a, **k: hold_search_chunk(fm, *a, **k)[0]
    plain_run = lambda: engine.run_search_plain(cfg0, fm, *args0,
                                                n_lanes=B_LANES)
    plain_out = []
    # the plain loop's CUDA-event span, its ~300,000 launches from the host
    # included (under the profiler it takes ~90 s)
    plain_ms = event_ms(lambda: plain_out.append(plain_run()), 1)
    want = plain_out[-1]
    text, (_, _, _, _, cause, it, counters) = hold_search_chunk(
        fm, "smoke against the plain loop", cfg0, args0, B_LANES, want)
    card_plain_ms = event_ms(lambda: plain_out.append(
        engine.run_search_plain(cfgc, fm, *args0, n_lanes=B_LANES)), 1)
    card_want = plain_out[-1]
    card_text, (_, _, _, _, _, card_it, card_counters) = hold_search_chunk(
        fm, f"smoke at the card's caps (ACAP {cfgc.acap}, iter_cap "
        f"{cfgc.iter_cap}) against the plain loop", cfgc, args0, B_LANES,
        card_want)
    phased = engine.run_search_phased(cfg0, fm, *args0, n_lanes=B_LANES)
    seen = [text, card_text, hold("smoke", cfg0, args0, B_LANES, phased)]
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
    for blocks in (1, 33, 132):
        out_h, nh, fb, it_b, cause_b, _ = launch_chunk(cfg0, fm, args0, 1,
                                                       max_blocks=blocks)
        got = engine.finish_chunk(out_h.permute(1, 2, 0), nh, fb, it_b,
                                  cause_b, B_LANES)
        err = max_abs_err([engine.masked_hits(*got[:3]), *got[1:3], it_b,
                           got[4]],
                          [engine.masked_hits(*want[:3]), *want[1:3], it,
                           want[4]])
        if err or got[3] != want[3]:
            raise AssertionError(f"search_chunk on {blocks} blocks differs "
                                 f"from the card's own grid (max abs err "
                                 f"{err})")
        seen.append(f"a grid of {blocks} blocks")
    log(f"search_chunk: n_hits, fb, steps and the hits below n_hits bitwise "
        f"equal to the plain loop (the fallback's causes too) and to the "
        f"phased kernels' loop, with and without the rows asked ahead, on "
        f"{'; '.join(seen)}")
    c = dict(zip(engine.COUNTERS, counters.tolist()))
    shape = {acap: engine.search_chunk_shape(
        dataclasses.replace(cfg0, acap=acap), fm, seqs,
        engine.big_planes(cfg0, fm, seqs, lens, hs, ssq), lens, md, hs, bad)
        for acap in (256, 1024, cfgc.acap)}
    log(f"search_chunk's launch: {shape}")

    # ---- the first version against the plain loop, its own step count
    f_h, f_nh, f_fb, f_c = launch_first(cfg0, fm, args0, 1)
    err = max_abs_err([engine.masked_hits(f_h.permute(1, 2, 0), f_nh, f_fb),
                       f_nh, f_fb.to(torch.int64)],
                      [engine.masked_hits(*want[:3]), want[1],
                       want[2].to(torch.int64)])
    if err or f_c.tolist()[:2] != [0, want[3]]:
        raise AssertionError(f"search_chunk_first differs from the plain "
                             f"loop (max abs err {err}, counters {f_c})")
    first_longest = f_c.tolist()[2]

    # ---- nothing in the call waits for the card: torch raises on any op
    # that would, whatever the host's load
    big = engine.big_planes(cfg0, fm, seqs, lens, hs, ssq)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    engine.search_chunk(cfg0, fm, seqs, big, lens, md, hs, bad)
    call_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.set_sync_debug_mode("default")

    # ---- times on the smoke chunk in turns with the first version, the
    # phased kernels' loop, the plain loop
    turns = {}
    for acap, cfg, reps in ((256, cfg0, 10), (1024, cfg1k, 4)):
        for design in FIRST_TURNS:
            turns.setdefault(acap, {}).setdefault(design, []).append(
                time_search_chunk(cfg, fm, args0, reps, 1,
                                  first=design == "first"))
    mode0 = time_search_chunk(cfg0, fm, args0, 10, 0)
    card_turns = [time_search_chunk(cfgc, fm, args0, 4, 1) for _ in range(3)]
    med = {acap: {d: statistics.median(v) for d, v in t.items()}
           for acap, t in turns.items()}
    ms, card = med[256]["new"], statistics.median(card_turns)
    phased_run = lambda: engine.run_search_phased(cfg0, fm, *args0,
                                                  n_lanes=B_LANES)
    phased_us = traced(lambda: (phased_run(), phased_run()), 2)
    phased_ms = {k: kernel_ms(phased_us, k) for k in (
        "lane_switch_kernel", "search_steps_kernel")}
    if not phased_us:   # the loop's span, the host's waits included
        phased_ms = {"the loop's CUDA-event span": event_ms(phased_run, 2)}

    # ---- the profiles, before (the first version) and after
    stream = torch.cuda.current_stream().cuda_stream
    mhz = profile_step.sm_clock_mhz()
    stages = {
        "new": profile_step.profile_stages(cfg0, fm, args0, stream, mhz),
        "first": profile_step.profile_stages(cfg0, fm, args0, stream, mhz,
                                             first=True, n_lanes=B_LANES)}
    lanes = {"new": profile_step.time_lanes(cfg0, fm, args0, PROFILE_LANES),
             "first": profile_step.time_lanes(cfg0, fm, args0, PROFILE_LANES,
                                              first=True)}
    for design in ("first", "new"):
        st = stages[design]
        log(f"profile_step stages, {design}: {st['lanes']} lanes, "
            f"{st['iterations']} iterations, longest lane "
            f"{st['longest_lane']}, SM clock {mhz:.0f} MHz; clocks an "
            f"iteration (share): " + ", ".join(
                f"{k} {v['per_iteration']:.1f} ({v['share']:.3f})"
                for k, v in st["stages"].items()))
        log(f"profile_step lanes, {design}: device ms at (lanes, blocks): "
            + ", ".join(f"({n}, {b}) {t:.5f}" for n, b, t in lanes[design]))

    moved, ops, instructions, static = chunk_work(cfg0, fm, want, c,
                                                  sass["new"])
    b = bound(moved, ops)
    longest = int(it.max())
    cc = dict(zip(engine.COUNTERS, card_counters.tolist()))
    c_moved, c_ops, c_instr, c_static = chunk_work(cfgc, fm, card_want, cc,
                                                   sass["new"])
    bc = bound(c_moved, c_ops)
    c_longest = int(card_it.max())
    card_split = cause_split(card_want[4], card_want[2])
    log(f"search_chunk N={lens.shape[0]} ACAP={cfg0.acap} on "
        f"{shape[256]['lanes']} resident lanes ({shape[256]['blocks_per_sm']}"
        f" blocks an SM; ACAP 1024: {shape[1024]['lanes']}, "
        f"{shape[1024]['blocks_per_sm']}): device ms per launch in turns "
        f"{FIRST_TURNS} at ACAP 256 {turns[256]} (medians new "
        f"{ms:.5f}, first version {med[256]['first']:.5f}, "
        f"{med[256]['first'] / ms:.3f}x), at ACAP 1024 {turns[1024]} "
        f"({med[1024]['first'] / med[1024]['new']:.3f}x); without the rows "
        f"asked ahead {mode0:.5f}; the call returned in {call_us:.0f} us and "
        f"waited for nothing (sync debug mode); the longest read {longest} "
        f"iterations (the first version's longest lane {first_longest}), "
        f"the longest lane {c['longest_lane']}, all {c['iterations']}, FM "
        f"rows {c['rows']} ({c['e_fetches']} E-chain fetches); "
        f"{ms * 1e3 / longest:.4f} us per iteration of the longest read "
        f"(first: {med[256]['first'] * 1e3 / first_longest:.4f} of its "
        f"longest lane); fallback {int(want[2].sum())} "
        f"{cause_split(want[4], want[2])}; the phased kernels' loop "
        f"{' + '.join(f'{k} {v:.5f}' for k, v in phased_ms.items())} ms; the "
        f"plain loop's CUDA-event span {plain_ms:.5f} ms; bound "
        f"{b['bound_ms']:.5f} ({b['bound_by']}, {moved} bytes, {ops} "
        f"operations: {sass['new']['min_int']} integer instructions of a "
        f"completed step at least x 32 x the iterations that are not a "
        f"read's last); issue at least {issue_ms(instructions):.5f} ms "
        f"({instructions} warp instructions), the step loop's static count "
        f"{issue_ms(static):.5f} ms")
    log(f"search_chunk N={lens.shape[0]} at the card's caps (ACAP "
        f"{cfgc.acap}, iter_cap {cfgc.iter_cap}) on "
        f"{shape[cfgc.acap]['lanes']} resident lanes "
        f"({shape[cfgc.acap]['blocks_per_sm']} blocks an SM): device ms per "
        f"launch {' '.join(f'{x:.5f}' for x in card_turns)} (median "
        f"{card:.5f}, {card / ms:.3f}x ACAP 256's); the longest read "
        f"{c_longest} iterations, the longest lane {cc['longest_lane']}, "
        f"all {cc['iterations']}, FM rows {cc['rows']} ({cc['e_fetches']} "
        f"E-chain fetches); {card * 1e3 / c_longest:.4f} us per iteration of "
        f"the longest read; fallback {int(card_want[2].sum())} {card_split}; "
        f"the plain loop's CUDA-event span {card_plain_ms:.5f} ms; bound "
        f"{bc['bound_ms']:.5f} ({bc['bound_by']}, {c_moved} bytes, {c_ops} "
        f"operations); issue at least {issue_ms(c_instr):.5f} ms, the step "
        f"loop's static count {issue_ms(c_static):.5f} ms")
    sweep = cap_sweep(fm, chunk, "smoke", plain=True)
    kernels.reset_launches()
    return {"max_abs_err": 0, "caps": [cfgc.acap, cfgc.iter_cap],
            "ms": card, "plain_ms": card_plain_ms, **bc,
            "library_ms": None,
            "issue_ms": issue_ms(c_instr),
            "issue_static_ms": issue_ms(c_static), "turns_ms": card_turns,
            "longest_read": c_longest, "counters": cc,
            "fallback_by_cause": card_split,
            "acap256": {"ms": ms, "plain_ms": plain_ms, **b,
                        "issue_ms": issue_ms(instructions),
                        "issue_static_ms": issue_ms(static),
                        "longest_read": longest, "counters": c,
                        "fallback_by_cause": cause_split(want[4], want[2])},
            "phased_kernels_ms": sum(phased_ms.values()),
            "first_version_ms": med[256]["first"], "first_turns_ms": turns,
            "acap1024_ms": med[1024]["new"],
            "acap1024_first_version_ms": med[1024]["first"],
            "no_prefetch_ms": mode0, "shape": shape, "sass": sass,
            "first_longest_lane": first_longest,
            "stages": stages, "lanes_ms": lanes, "cap_sweep": sweep,
            "_longest": c_longest}


def cap_sweep(fm, chunk: dict, label: str, plain: bool,
              settings=SWEEP, must_keep=()) -> list[dict]:
    """K8 at every (ACAP, iter_cap) of `settings` (`EngineConfig` through
    `dataclasses.replace`; the module's defaults untouched) on a chunk:
    bitwise equal to the plain loop (`plain`; over one lane a read, which
    gives the same hits, flags and causes in the fewest steps) or to the
    phased kernels' loop at the same setting; every read it keeps on the
    card decoded (`engine._decode`) equal to `native_align_batch`'s hits
    for it; its device ms, its fallback split by cause and its longest
    read; every read of `must_keep` kept on the card.  One dict a
    setting."""
    import numpy as np
    from ibwa_tpu_torch.align import engine
    args, n = chunk["args"], len(chunk["seqs"])
    out = []
    for acap, cap in settings:
        cfg = dataclasses.replace(chunk["cfg"], iter_cap=cap, acap=acap)
        t0 = time.perf_counter()
        run = engine.run_search_plain if plain else engine.run_search_phased
        want = run(cfg, fm, *args, n_lanes=n)
        ref_s = time.perf_counter() - t0
        _, (hits, nh, fb, _, cause, it, _) = hold_search_chunk(
            fm, f"{label} iter_cap {cap} ACAP {acap}", cfg, args, n, want,
            modes=(1,))
        fb_np = fb.cpu().numpy()
        decoded = [None] * n
        engine._decode(hits.cpu().numpy(), nh.cpu().numpy(), fb_np,
                       chunk["opt"], decoded, 0)
        kept = np.nonzero(~fb_np)[0]
        host = engine.native_align_batch(
            chunk["fms"], [chunk["seqs"][i] for i in kept],
            [chunk["rseqs"][i] for i in kept], chunk["opt"])
        wrong = [int(i) for i, h in zip(kept, host) if decoded[i] != h]
        if fb_np[list(must_keep)].any():
            raise AssertionError(f"{label} iter_cap {cap} ACAP {acap}: "
                                 f"reads {list(must_keep)} are not all kept "
                                 f"on the card")
        if wrong:
            raise AssertionError(f"{label} iter_cap {cap} ACAP {acap}: "
                                 f"reads {wrong[:5]} kept on the card "
                                 f"decode to other hits than the host's")
        row = {"acap": acap, "iter_cap": cap,
               "ms": time_search_chunk(cfg, fm, args, 4, 1),
               "fallback": int(fb_np.sum()),
               "fallback_share": float(fb_np.mean()),
               "by_cause": cause_split(cause, fb),
               "longest_read": int(it.max()), "kept": len(kept),
               "kept_with_a_hit_at_or_above_2_31": sum(
                   any(h.k >= HIGH for h in decoded[i]) for i in kept),
               "reference": "plain loop" if plain else "phased kernels",
               "reference_s": ref_s}
        out.append(row)
        log(f"cap sweep, {label} chunk, iter_cap {cap} ACAP {acap}: bitwise "
            f"equal to the {row['reference']}'s ({ref_s:.1f} s), "
            f"{len(kept)} reads kept on the card, each equal to the host "
            f"search's hits ({row['kept_with_a_hit_at_or_above_2_31']} of "
            f"them with a hit at or above 2^31); device ms "
            f"{row['ms']:.5f}, longest read "
            f"{row['longest_read']}, fallback {row['fallback']} "
            f"({row['fallback_share']:.4f}) by cause {row['by_cause']}")
    return out


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


def walk_footprint(fm, strand, k, mask: int) -> dict:
    """What the LF walks from rows `k` of strands `strand` (int64 tensors
    on fm's device) must fetch, found by the plain step on the card: their
    LF steps, the distinct table rows they read and the distinct sampled
    words they end on (each must come from memory at least once, and need
    not come more than once), the longest walk (a persistent launch lasts
    at least that chain of dependent fetches), and the sum over the first
    version's dispatches of OLD_DISPATCH rows of each one's longest walk
    (each of them lasted at least that)."""
    import torch
    from ibwa_tpu_torch.fm import walk
    seen = torch.zeros(fm.blocks.shape[0], dtype=torch.bool,
                       device=fm.device)
    shift = fm.intv.bit_length() - 1
    add = torch.zeros_like(k)
    active = (k & mask) != 0
    while bool(active.any()):
        # the row lf_step_plain reads (device._gather_block)
        ka = torch.clamp(k - (k > fm.primary[strand]).to(torch.int64),
                         max=fm.seq_len - 1)
        row = strand * fm.n_blk + torch.clamp(ka >> shift, max=fm.n_blk - 1)
        seen[row[active]] = True
        k = torch.where(active, walk.lf_step_plain(fm, strand, k), k)
        add += active.to(torch.int64)
        active &= (k & mask) != 0
    slots = torch.unique(strand * (1 << 32) + (k >> mask.bit_length()))
    return {"steps": int(add.sum()), "rows": int(seen.sum()),
            "slots": len(slots), "longest": int(add.max()),
            "chain": sum(int(add[lo:lo + OLD_DISPATCH].max())
                         for lo in range(0, len(add), OLD_DISPATCH)),
            "row_bytes": fm.blocks.shape[1] * fm.blocks.element_size()}


def walk_bound(n_iv: int, n_rows: int, fp: dict, wpb: int,
               warp_us: float) -> dict:
    """K5's bounds on n_iv intervals of n_rows rows: each interval's
    strand and first row (u32) and its `off` entry (int64) read, a u32
    value a row written, each distinct table row and sampled word fetched
    once; ~6 integer operations per word of a row and ~20 more per step;
    and the latency of its longest walk at `warp_us` a dependent fetch."""
    moved = (16 * n_iv + 8 + 4 * n_rows + fp["rows"] * fp["row_bytes"]
             + 4 * fp["slots"])
    ops = fp["steps"] * (6 * wpb + 20)
    return {**bound(moved, ops),
            "bytes_bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": ops / INT_OPS_PER_S * 1e3,
            "latency_bound_ms": fp["longest"] * warp_us / 1e3}


def walk_case(walker, strand, ks, ls) -> dict:
    """One set of intervals on the card, as `DeviceWalker.resolve_intervals`
    uploads them: the intervals, `off`, and the rows expanded on the card
    for the first version (int64 strand and row, as it takes them)."""
    import numpy as np
    import torch
    dev = walker.fm.device
    off = np.zeros(len(ks) + 1, dtype=np.int64)
    np.cumsum(ls.astype(np.int64) - ks + 1, out=off[1:])
    iv = torch.from_numpy(np.stack([strand.astype(np.uint32),
                                    ks.astype(np.uint32)]).view(np.int32))
    iv, off_t = iv.to(dev), torch.from_numpy(off).to(dev)
    widths = off_t[1:] - off_t[:-1]
    rows = torch.arange(int(off[-1]), device=dev) - torch.repeat_interleave(
        off_t[:-1], widths)
    return {"iv": iv, "off": off_t, "n": int(off[-1]),
            "strand": torch.repeat_interleave(iv[0].to(torch.int64), widths),
            "k": torch.repeat_interleave(iv[1].to(torch.int64) & 0xFFFFFFFF,
                                         widths) + rows}


def old_dispatch_loop(fm, case: dict, mask: int, lanes: int) -> None:
    """K5's first version on a case's rows, as PR 2-6 ran it on `sampe`'s
    path: `lf_walk` on slices of `lanes` rows (the lookup, on the host,
    not included)."""
    from ibwa_tpu_torch.fm import walk
    for lo in range(0, case["n"], lanes):
        walk.lf_walk(fm, case["strand"][lo:lo + lanes],
                     case["k"][lo:lo + lanes], mask)


def time_walk(walker, case: dict, lanes: int, reps: int) -> dict:
    """Device ms per call, from CUDA events around `reps` calls after a
    warm-up, of the new K5 (one launch on the case's rows) and of the
    first version's loop of dispatches on the same rows, in turns (new,
    old, old, new) in one process; and of the plain version, one call.
    Events, not the profiler: a session can miss a single launch
    altogether (`traced`)."""
    import torch
    from ibwa_tpu_torch.fm import walk
    mask = walker.sa_intv - 1
    stream = torch.cuda.current_stream().cuda_stream
    args = (walker.fm, walker.sampled, case["iv"], case["off"], 0,
            case["n"], mask)
    calls = {"new": lambda: walk._launch_resolve(*args, stream),
             "old": lambda: old_dispatch_loop(walker.fm, case, mask, lanes)}

    times = {"new": [], "old": []}
    for name in ("new", "old", "old", "new"):
        event_ms(calls[name], 1)
        times[name].append(event_ms(calls[name], reps))
    return {"ms": statistics.mean(times["new"]),
            "old_ms": statistics.mean(times["old"]),
            "ms_readings": times["new"], "old_ms_readings": times["old"],
            "old_launches": -(-case["n"] // lanes),
            "plain_ms": event_ms(lambda: walk.resolve_intervals_plain(*args),
                                 1)}


def check_walk(fms, dev) -> dict:
    """K5 against its plain version, bitwise, at block intervals 32, 64
    and 128: on 131,072 random (strand, row) pairs plus the edge rows, as
    intervals of width 1, and on 20,000 random intervals of widths 1 to
    256 (the first version's (add, kfin) against lf_walk_plain on the
    random rows too); on the random rows at 64, the default table, the
    new kernel timed beside the first version's one dispatch, with the
    steps, the longest walk and the bounds."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.fm import walk
    from ibwa_tpu_torch.fm.device import build_device_pair
    rng = np.random.default_rng(SEED)
    es, ek = walk_edges(fms)
    rows = np.concatenate([rng.integers(0, fms[0].seq_len + 1, 131072), ek])
    strand = np.concatenate([rng.integers(0, 2, 131072), es])
    w = rng.integers(1, 257, 20000)
    wks = rng.integers(0, fms[0].seq_len + 1 - w)
    wide = (rng.integers(0, 2, 20000), wks, wks + w - 1)
    mask = fms[0].sa_intv - 1
    row = {}
    for intv in (32, 128, 64):
        walker = walk.DeviceWalker.from_table(
            build_device_pair(fms[0], fms[1], dev, intv=intv),
            (fms[0].sa, fms[1].sa), fms[0].sa_intv)
        fm = walker.fm
        stats = {}
        for label, (s_, k_, l_) in (("random rows", (strand, rows, rows)),
                                    ("random intervals", wide)):
            case = walk_case(walker, s_, k_, l_)
            want, _ = walk.resolve_intervals_plain(
                fm, walker.sampled, case["iv"], case["off"], 0, case["n"],
                mask)
            got, st = walk.lf_resolve(fm, walker.sampled, case["iv"],
                                      case["off"], 0, case["n"], mask)
            torch.cuda.synchronize()
            err = max_abs_err([got], [want])
            if err:
                raise AssertionError(f"K5 intv={intv} {label}: kernel != "
                                     f"plain (max abs err {err})")
            stats[label] = st.tolist()
            log(f"K5 lf_walk intv={intv} {label}: {case['n']} rows of "
                f"{case['iv'].shape[1]} intervals bitwise equal to the plain "
                f"version; queue {stats[label][0]}, {stats[label][1]} steps, "
                f"longest walk {stats[label][2]}")
        case = walk_case(walker, strand, rows, rows)
        add, kfin = walk.lf_walk(fm, case["strand"], case["k"], mask)
        err = max_abs_err((add, kfin),
                          walk.lf_walk_plain(fm, case["strand"], case["k"],
                                             mask))
        if err:
            raise AssertionError(f"K5's first version intv={intv}: kernel != "
                                 f"plain (max abs err {err})")
        if intv == 64:
            t = time_walk(walker, case, case["n"], 20)
            plain_ms = t["plain_ms"]
            fp = walk_footprint(fm, case["strand"], case["k"], mask)
            if [fp["steps"], fp["longest"]] != stats["random rows"][1:]:
                raise AssertionError(f"walk_footprint {fp} against the "
                                     f"kernel's {stats['random rows']}")
            row = {"random_rows": case["n"], "random_ms": t["ms"],
                   "random_first_version_ms": t["old_ms"],
                   "random_plain_ms": plain_ms, "random_steps": fp["steps"],
                   "random_longest": fp["longest"],
                   "_random_fp": fp, "_random_n_iv": case["n"]}
            log(f"K5 lf_walk random rows intv=64: {fp['steps']} steps, "
                f"longest walk {fp['longest']}, {fp['rows']} distinct table "
                f"rows of {fm.blocks.shape[0]}, {fp['slots']} sampled words; "
                f"device ms new {t['ms']:.5f} (1 launch; readings "
                f"{t['ms_readings']}), first version {t['old_ms']:.5f} "
                f"({t['old_launches']} launch; readings "
                f"{t['old_ms_readings']}), plain {plain_ms:.5f}")
        del walker, fm, case
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
    last = walker.last
    log(f"walker: {WALK_PAIRS} pairs in {last['waves']} wave, "
        f"{last['launches']} launch, equal to the native sa_lookup; wall "
        f"DeviceWalker.resolve {dev_s:.3f} s ({WALK_PAIRS / dev_s:.0f} "
        f"rows/s), native sa_lookup {host_s:.3f} s "
        f"({WALK_PAIRS / host_s:.0f} rows/s)")


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


def run_cli(cmd: str, args: list[str], out: pathlib.Path,
            env: dict | None = None) -> tuple[float, str]:
    """`ibwa_tpu_torch <cmd> ... -f out` in-process, as a user calls it
    (`parity_scale.run_cli`, `env` set for the call): (wall seconds of the
    whole command, its stderr)."""
    from ibwa_tpu_torch import parity_scale
    r = parity_scale.run_cli(cmd, args, out, env)
    return r["wall"], r["err"]


def run_aln(args: list[str], out: pathlib.Path,
            env: dict | None = None) -> dict:
    """`ibwa_tpu_torch aln ... -f out` in-process; returns its stats line
    plus the wall seconds of the whole command."""
    wall, err = run_cli("aln", args, out, env)
    lines = [ln for ln in err.splitlines() if ln.startswith("[aln] stats ")]
    if not lines:
        raise AssertionError(f"aln printed no stats:\n{err}")
    stats = json.loads(lines[-1][len("[aln] stats "):])
    stats["wall_s"] = wall
    return stats

def profile_chunk(fms, fm, chunk: dict) -> None:
    """One warm 2,048-read chunk of the device search, as the engine runs
    it (width pass, one `search_chunk` launch, one copy of the reads'
    iteration counts):
    bare wall, then under the profiler its launches and device time by
    kind; beside it, in the same process, the loop of the phased kernels on
    the same chunk with the host clock around each of a phase's calls; the
    step's prefetch on and off in turns; and the native search of the same
    reads.  At the caps the engine takes on the card (`card_cfg`)."""
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    n = len(chunk["seqs"])
    cfg, args = chunk["card_cfg"], chunk["args"]
    run = lambda: engine.run_search_persistent(cfg, fm, *args,
                                               n_lanes=B_LANES)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits, nh, fb, steps, _ = run()
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

    reps = 10   # a trace can drop a few of its records (device_us)

    def body():
        kernels.reset_launches()
        for _ in range(reps):
            run()
            torch.cuda.synchronize()

    traced_us = traced(body, reps)
    if not traced_us:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{TRACE_TRIES} sessions of the chunk")
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
    for key, (us, launches) in traced_us.items():
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


def run_aln_paths(fa, fq, caps: tuple[int, int]) -> tuple[dict, dict]:
    """`aln` native, device-only and hybrid, ROUNDS rounds of the three in
    turns (the order reversed every other round); in every round both
    device .sai must be byte-identical to the native one, every device
    batch at `caps` (ACAP, iter_cap: the card's), and the device-only
    run's launches, steps and fallback the same.  Returns the launch
    counts of the device-only and the hybrid runs."""
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
            took = {(b["acap"], b["iter_cap"])
                    for b in res[name][-1].get("batches", [])}
            if name != "native" and took != {tuple(caps)}:
                raise AssertionError(f"aln {name} round {r} took (ACAP, "
                                     f"iter_cap) {took}, not {caps}")
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
            f"({fb / max(dev_reads + fb, 1):.4f}; by cause "
            f"{r.get('fallback_by_cause')}), host share "
            f"{r.get('host_reads', 0)}, steps {r.get('iterations', 0)}; "
            f"the native search on {r['host_threads']} host thread(s)")
    log(f".sai byte-identical to --engine native (device-only, hybrid, at "
        f"ACAP {caps[0]} and iter_cap {caps[1]}) in each of {ROUNDS} "
        f"rounds; {n_hit}/{N_READS} reads with hits; "
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
    The device route must launch lf_walk and nothing else, once a wave,
    prefill every batch, and report 0 values refused by the cache and 0
    host walks in every batch and after the last; the native route
    launches nothing."""
    from ibwa_tpu_torch import kernels
    kernels.reset_launches()
    wall, err = run_cli("sampe", args, out)
    got = dict(kernels.launches)
    batches = [tuple(float(x) for x in m.groups())
               for m in PREFILL_LINE.finditer(err)]
    last = [int(m.group(1)) for m in LAST_LINE.finditer(err)]
    if not device:
        if got or batches or last:
            raise AssertionError(f"sampe --engine native launched {got}")
        return wall, batches, got
    if set(got) != {"lf_walk"} or got["lf_walk"] != sum(b[2] for b in batches):
        raise AssertionError(f"sampe on the card launched {got}, not "
                             f"lf_walk alone once a wave")
    if not batches or last != [0] or any(b[0] <= 0 or b[3] or b[4]
                                         for b in batches):
        raise AssertionError(f"a batch's SA walks were not all done on the "
                             f"card:\n{err}")
    return wall, batches, got


PREFILL_LINE = re.compile(
    r"\[sai2sam_pe\] prefill (\d+) rows in (\d+) waves, (\d+) launches; "
    r"(\d+) values refused by the cache, (\d+) host walks since the last "
    r"batch; ([\d.]+) s \(intervals ([\d.]+) s, walker ([\d.]+) s, cache "
    r"([\d.]+) s\)")
LAST_LINE = re.compile(r"\[sai2sam_pe\] (\d+) host walks after the last "
                       r"prefill")


def run_sampe_phase(fa, fqs, warp_us: float) -> dict:
    """`aln --device cuda` on both ends of the pairs; `sampe -R` on all
    of them with the SA walks on the card (K5 prefilling each batch) and
    with `--engine native` (host walks), SAM byte-equal, the device run
    with its intervals recorded;
    on those intervals K5 against its plain version (bitwise) and timed
    beside the first version's loop of dispatches, with its bounds; then
    the rates, ROUNDS rounds of the two routes in turns on the first
    RATE_PAIRS pairs, untraced, SAM byte-equal in every round; the same
    pairs in MANY_BATCHES batches (sampe.BATCH lowered), SAM byte-equal;
    then `samse` on end 1: one line per read.  Returns K5's row of the
    kernel table from this path."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import kernels, parity_scale
    from ibwa_tpu_torch.fm import walk
    from ibwa_tpu_torch.sam import sampe
    sais = [WORK / f"pairs_{e}.sai" for e in (1, 2)]
    # the .sai sampe reads: the host search on every core, as a parity
    # run's (no rate here is the native baseline's)
    every_core = {"OMP_NUM_THREADS": str(parity_scale.HOST_THREADS)}
    for fq, out in zip(fqs, sais):
        kernels.reset_launches()
        st = run_aln([str(fa), str(fq), "--device", "cuda"], out, every_core)
        log(f"aln --device cuda {fq.name}: {st['reads'] / st['search_s']:.1f} "
            f"reads/s of search wall, {st['reads'] / st['wall_s']:.1f} end "
            f"to end; device reads {st['device_reads']}, fallback "
            f"{st['fallback_reads']}, host share {st['host_reads']} on "
            f"{st['host_threads']} host thread(s); launches "
            f"{dict(kernels.launches)}")
    routes = {"native": ["-R", "--engine", "native"],
              "device": ["-R", "--device", "cuda"]}
    args = [str(fa), *map(str, sais), *map(str, fqs)]
    sam = {name: WORK / f"pairs_{name}.sam" for name in routes}

    # all the pairs: the SAM, K5's launches and time, and its intervals
    native_s, _, _ = sampe_run(routes["native"] + args, sam["native"], False)
    with parity_scale.WalkRecorder(keep_values=False) as rec:
        device_s, prefill, launches = sampe_run(
            routes["device"] + args, sam["device"], True)
    calls = rec.calls
    want = sam["native"].read_bytes()
    if sam["device"].read_bytes() != want:
        raise AssertionError("sampe SAM with K5's walks differs from the "
                             "host walks'")
    recs = [ln.split(b"\t") for ln in want.splitlines() if ln[:1] != b"@"]
    mapped = sum(1 for f in recs if not int(f[1]) & 4)
    if len(recs) != 2 * N_PAIRS or mapped < N_PAIRS:
        raise AssertionError(f"sampe: {len(recs)} records, {mapped} mapped")
    if len(calls) != 1:
        raise AssertionError(f"one db and one batch, so one call: "
                             f"{len(calls)}")
    walker, strand, ks, ls, _, _ = calls[0]
    del calls, rec
    case = walk_case(walker, strand, ks, ls)
    mask = walker.sa_intv - 1
    got, stats = walk.lf_resolve(walker.fm, walker.sampled, case["iv"],
                                 case["off"], 0, case["n"], mask)
    err = max_abs_err([got], [walk.resolve_intervals_plain(
        walker.fm, walker.sampled, case["iv"], case["off"], 0, case["n"],
        mask)[0]])
    if err:
        raise AssertionError(f"K5 on sampe's rows: kernel != plain (max abs "
                             f"err {err})")
    t = time_walk(walker, case, OLD_DISPATCH, 5)
    plain_ms = t["plain_ms"]
    fp = walk_footprint(walker.fm, case["strand"], case["k"], mask)
    queue, steps, longest = stats.tolist()
    if (steps, longest) != (fp["steps"], fp["longest"]):
        raise AssertionError(f"K5's counters {stats.tolist()} against "
                             f"walk_footprint {fp}")
    n_iv, rows = case["iv"].shape[1], case["n"]
    bd = walk_bound(n_iv, rows, fp, walker.fm.wpb, warp_us)
    old_lat = fp["chain"] * warp_us / 1e3
    del walker, case, got
    torch.cuda.empty_cache()
    if rows != sum(int(b[0]) for b in prefill):
        raise AssertionError("the recorded intervals are not the prefill's")
    per_batch = " + ".join(f"{int(b[0])} rows in {int(b[1])} wave, "
                           f"{int(b[2])} launch, {b[5]:.4f} s (unique "
                           f"intervals {b[6]:.4f}, walker {b[7]:.4f}, cache "
                           f"{b[8]:.4f})" for b in prefill)
    log(f"sampe -R on {N_PAIRS} pairs: SAM byte-equal between K5's walks "
        f"and the host walks ({len(want)} bytes, {len(recs)} records, "
        f"{mapped} mapped); host walks {native_s:.3f} s, K5's walks "
        f"{device_s:.3f} s (one run each: see the rates below); the prefill "
        f"{per_batch}; 0 values refused, 0 host walks; K5 "
        f"{launches['lf_walk']} launch")
    log(f"K5 on sampe's {rows} rows of {n_iv} intervals: bitwise equal to "
        f"the plain version ({plain_ms:.5f} ms); its queue handed out "
        f"{queue} rows, {steps} LF steps ({steps / rows:.2f} a row, as the "
        f"plain step counts them) over {fp['rows']} distinct table "
        f"rows of {fp['row_bytes']} B and {fp['slots']} sampled words, "
        f"longest walk {longest}; device ms new {t['ms']:.5f} in 1 "
        f"launch (readings {t['ms_readings']}) against the first version's "
        f"{t['old_ms']:.5f} in {t['old_launches']} dispatches (readings "
        f"{t['old_ms_readings']}), in turns in this call; bounds "
        f"{bd['bytes_bound_ms']:.5f} ms by bytes, {bd['ops_bound_ms']:.5f} by "
        f"operations, {bd['latency_bound_ms']:.5f} by latency "
        f"({fp['longest']} x {warp_us:.3f} us; the first version's: the "
        f"longest walk of each dispatch summed {fp['chain']} x "
        f"{warp_us:.3f} us = {old_lat:.5f} ms)")

    # the rates: the first RATE_PAIRS pairs, ROUNDS rounds in turns
    sub_fq = [WORK / f"rate_pairs_{e}.fq" for e in (1, 2)]
    sub_sai = [WORK / f"rate_pairs_{e}.sai" for e in (1, 2)]
    for fq, sfq, sai_ in zip(fqs, sub_fq, sub_sai):
        parity_scale.first_reads(fq, RATE_PAIRS, sfq)
        run_aln([str(fa), str(sfq), "--device", "cuda"], sai_, every_core)
    args = [str(fa), *map(str, sub_sai), *map(str, sub_fq)]
    walls = {name: [] for name in routes}
    pre_s, splits, want = [], [], None
    for r in range(ROUNDS):
        for name in routes if r % 2 == 0 else list(routes)[::-1]:
            wall, batches, _ = sampe_run(routes[name] + args, sam[name],
                                         name == "device")
            walls[name].append(wall)
            if batches:
                pre_s.append(sum(b[5] for b in batches))
                splits.append(tuple(sum(b[i] for b in batches)
                                    for i in (6, 7, 8)))
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
        f"{' / '.join(f'{x:.4f}' for x in share)} of the run (unique "
        f"intervals / walker / cache: "
        f"{'; '.join(' / '.join(f'{x:.4f}' for x in t) for t in splits)} s)")

    # the same pairs in several batches: each batch's prefill empties the
    # cache of the one before and leaves nothing to the host
    batch = sampe.BATCH
    sampe.BATCH = RATE_PAIRS // MANY_BATCHES
    try:
        many = {}
        for name in routes:
            _, got_batches, _ = sampe_run(routes[name] + args, sam[name],
                                          name == "device")
            many[name] = sam[name].read_bytes()
            batches = got_batches if name == "device" else batches
    finally:
        sampe.BATCH = batch
    if many["device"] != many["native"] or len(batches) != MANY_BATCHES:
        raise AssertionError(f"sampe in {len(batches)} batches: SAM with "
                             f"K5's walks differs from the host walks'")
    log(f"sampe -R on the first {RATE_PAIRS} pairs in {MANY_BATCHES} batches "
        f"of {RATE_PAIRS // MANY_BATCHES}: SAM byte-equal to --engine native "
        f"at the same batch size; the prefills "
        f"{' + '.join(str(int(b[0])) for b in batches)} rows, 0 values "
        f"refused and 0 host walks in every batch and after the last")
    out = WORK / "pairs_1.samse.sam"
    wall, _ = run_cli("samse", [str(fa), str(sais[0]), str(fqs[0])], out)
    lines = out.read_bytes().splitlines()
    head = sum(1 for ln in lines if ln[:1] == b"@")
    if len(lines) - head != N_PAIRS or head < 2:
        raise AssertionError(f"samse: {len(lines)} lines, {head} of header, "
                             f"for {N_PAIRS} reads")
    log(f"samse on end 1: exit 0, {head} header lines + {N_PAIRS} records, "
        f"{N_PAIRS / wall:.1f} reads/s end to end ({wall:.3f} s)")
    return {"launches": launches["lf_walk"], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": plain_ms, **bd, "library_ms": None,
            "first_version_ms": t["old_ms"],
            "first_version_launches": t["old_launches"],
            "first_version_latency_bound_ms": old_lat,
            "rows": rows, "intervals": n_iv,
            "steps": fp["steps"], "longest_walk": fp["longest"],
            "rows_fetched": fp["rows"], "sampled_words": fp["slots"]}


def ext_jobs(rng, n: int, tmax: int, qmax: int, band: int,
             g0_hi: int = 100) -> dict:
    """tests/test_dp_device.py's random extension jobs (70% of the queries
    a mutated copy of the target's start, some with an indel), as the
    native driver hands a batch over; G0 below g0_hi (in the hundreds it
    keeps a row's cells positive far off the diagonal, so the band bounds
    the row)."""
    import numpy as np
    targets, queries = [], []
    for _ in range(n):
        lt = int(rng.integers(1, tmax))
        lq = int(rng.integers(1, qmax))
        t = rng.integers(0, 4, lt).astype(np.uint8)
        if rng.random() < 0.7 and lt > 4:
            q = t[:min(lq, lt)].copy()
            for _ in range(rng.integers(0, max(len(q) // 8, 1) + 1)):
                q[rng.integers(0, len(q))] = rng.integers(0, 4)
            if rng.random() < 0.4 and len(q) > 10:
                q = np.delete(q, int(rng.integers(2, len(q) - 2)))
        else:
            q = rng.integers(0, 4, lq).astype(np.uint8)
        targets.append(t)
        queries.append(q)
    bands = np.full(n, band, dtype=np.int32)
    bands[::5] = rng.integers(1, band + 1, len(bands[::5]))
    return ext_batch(targets, queries, rng.integers(1, g0_hi, n), bands)


def ext_batch(targets, queries, g0, bands, q: int = 5, r: int = 2) -> dict:
    """A batch as dp.extend_jobs takes it (bsw2.cpp's ExtBatch)."""
    import numpy as np
    offs = []
    for seqs in (targets, queries):
        off = np.zeros(len(seqs) + 1, dtype=np.int64)
        off[1:] = np.cumsum([len(x) for x in seqs])
        offs.append(off)
    m = np.full(25, -3, dtype=np.int32)
    m[[0, 6, 12, 18]] = 1
    return {"tgt_blob": np.concatenate(targets).astype(np.uint8),
            "tgt_off": offs[0],
            "qry_blob": np.concatenate(queries).astype(np.uint8),
            "qry_off": offs[1], "g0": np.asarray(g0, dtype=np.int32),
            "band": np.asarray(bands, dtype=np.int32), "matrix": m,
            "gap_open": q, "gap_ext": r}


def long_ext_jobs(rng, lens) -> dict:
    """Jobs beyond the JAX package's compile caps (targets up to ~8,000,
    queries up to ~3,000): related, 4% substituted."""
    import numpy as np
    targets, queries = [], []
    for lt, lq in lens:
        t = rng.integers(0, 4, lt).astype(np.uint8)
        qq = t[:lq].copy()
        for _ in range(lq // 25):
            qq[rng.integers(0, lq)] = rng.integers(0, 4)
        targets.append(t)
        queries.append(qq)
    return ext_batch(targets, queries, rng.integers(1, 100, len(lens)),
                     np.full(len(lens), 50))


def ext_args(b: dict, dev):
    """extend_scan's tensors on dev for the jobs the device runs; sets
    b["widest"], their widest band (which picks K9's mode)."""
    import torch
    from ibwa_tpu_torch.ops import dp
    ids, _ = dp.device_jobs(b["tgt_off"], b["qry_off"], b["g0"], b["matrix"])
    b["widest"] = int(b["band"][ids].max())
    up = lambda a: torch.from_numpy(a).to(dev)
    return (up(b["tgt_blob"]), up(b["tgt_off"]), up(b["qry_blob"]),
            up(b["qry_off"]), up(b["g0"]), up(b["band"]), up(ids))


# K9's two entries: the redesign on bwasw's path, and its first version,
# kept to be timed beside it
EXT_SCAN = {"new": "extend_scan", "first": "extend_scan_first"}
EXT_ENTRY = {"new": "ibwa_extend_dp", "first": "ibwa_extend_dp_first"}


def ext_call(design: str, b: dict, args):
    """One launch of K9's `design` on a batch: (out, stats)."""
    from ibwa_tpu_torch.ops import dp
    fn = getattr(dp, EXT_SCAN[design])
    extra = {"widest_band": b["widest"]} if design == "new" else {}
    return fn(*args, b["matrix"], b["gap_open"], b["gap_ext"], **extra)


def check_extend_batch(label: str, b: dict, dev, first: bool = False
                       ) -> dict:
    """K9 against its plain version on one batch, bitwise, its counters
    against the plain version's, every job on the mode the batch's widest
    band asks for (a ring in shared memory, or a row in global memory);
    with `first` its first version too; a sample of its rows against the
    host kernel (`native.extend_aln`)."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import native
    from ibwa_tpu_torch.ops import dp
    args = ext_args(b, dev)
    mat, q, r = b["matrix"], b["gap_open"], b["gap_ext"]
    want, wst = dp.extend_scan_plain(
        *args, torch.from_numpy(mat.astype(np.int64)), q, r)
    wst = wst.tolist()
    got, st = ext_call("new", b, args)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    st = st.tolist()
    m = len(args[6])
    rings = b["widest"] <= dp.RING_BAND
    mode = "rings" if rings else "rows"
    if err or st[1:4] != wst[1:] or st[4:] != ([m, 0] if rings else [0, m]):
        raise AssertionError(f"K9 {label}: kernel != plain (max abs err "
                             f"{err}; counters {st} against {wst}, mode "
                             f"{mode})")
    if first:
        got1, st1 = ext_call("first", b, args)
        err1 = max_abs_err([got1], [want])
        if err1 or st1.tolist()[1:] != wst[1:]:
            raise AssertionError(f"K9's first version {label}: != plain "
                                 f"(max abs err {err1}; counters "
                                 f"{st1.tolist()} against {wst})")
    ids = args[6].cpu().numpy()
    got = got.cpu().numpy()
    sample = ids[np.linspace(0, len(ids) - 1, min(64, len(ids))).astype(int)]
    to, qo = b["tgt_off"], b["qry_off"]
    for i in sample:
        host = native.extend_aln(
            b["tgt_blob"][to[i]:to[i + 1]], b["qry_blob"][qo[i]:qo[i + 1]],
            q, r, int(b["band"][i]), mat.reshape(5, 5), int(b["g0"][i]))
        if tuple(got[i]) != host:
            raise AssertionError(f"K9 {label} job {i}: {tuple(got[i])}, the "
                                 f"host kernel {host}")
    log(f"K9 extend_dp {label}: {m} jobs of {len(b['g0'])} bitwise equal "
        f"to the plain version ({st[1]} rows, {st[2]} cells, longest job "
        f"{st[3]} rows, queue {st[0]}; widest band {b['widest']}, all "
        f"on {mode}{', the first version too' if first else ''}), "
        f"{len(sample)} of them equal to the host kernel")
    return {"jobs": m, "rows": st[1], "cells": st[2], "longest": st[3],
            "mode": mode}


def ext_kernel_fn(design: str, b: dict, args, blocks: int = 0):
    """fn() that launches K9's `design` once on a batch (`args`, its
    tensors) with its outputs made ahead: the queue's counter zeroed, then
    the C entry; a grid of `blocks` where it is not 0 (the redesign)."""
    import numpy as np
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.ops import dp
    n, dev = len(b["g0"]), args[0].device
    out = torch.empty((n, 3), dtype=torch.int32, device=dev)
    stats = torch.zeros(6, dtype=torch.int64, device=dev)
    eh = None
    if design == "first" or b["widest"] > dp.RING_BAND:
        # as large as either entry's scratch (ops/dp.py)
        eh = torch.empty(args[0].numel() + 12 * n + 4, dtype=torch.int32,
                         device=dev)
    entry = getattr(kernels.lib(), EXT_ENTRY[design])
    mat = np.ascontiguousarray(b["matrix"], dtype=np.int32).reshape(25)
    ptrs = [t.data_ptr() for t in args]
    rest = (len(args[6]), mat.ctypes.data, b["gap_open"], b["gap_ext"],
            None if eh is None else eh.data_ptr(), out.data_ptr(),
            stats.data_ptr(), blocks, torch.cuda.current_stream().cuda_stream)

    def fn():
        stats.zero_()
        kernels.check(entry(*ptrs, *rest), EXT_ENTRY[design])
    fn.buffers = (args, mat, eh, out)   # the pointers' owners live with fn
    return fn


def ext_kernel_ms(fn, reps: int, floor_ms: float, label: str) -> float:
    """ms a launch of fn() (`ext_kernel_fn`) over `reps` launches: the
    CUDA-event span of launches queued behind a kernel that sleeps
    EXT_SLEEP_CYCLES, so the host has queued them all before the first
    runs and the span is the card's time (K9 and a zeroing of 48 bytes a
    launch).  A reading under floor_ms (EXT_FLOOR_SHARE of the batch's
    least time) is taken again, up to TRACE_TRIES times; then the run
    fails, with no number."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda._sleep(EXT_SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        if ms >= floor_ms:
            return ms
        log(f"K9 {label}: reading {attempt} of {TRACE_TRIES}, {ms:.5f} ms, "
            f"is under the floor of {floor_ms:.5f} ms")
    raise AssertionError(f"K9 {label}: every reading under the floor")


def ext_bound(b: dict, counters: dict, row_us: float) -> dict:
    """K9's least time on a batch: bytes (the blobs, offsets, G0, bands
    and job list read once, 12 B a job written) over the memory rate, or
    the counted cells' operations over the integer rate; and the latency
    estimate, the longest job's rows times one row's dependent chain
    (`row_us`, measured on one band-50 job)."""
    n = len(b["g0"])
    moved = (b["tgt_blob"].size + b["qry_blob"].size + 16 * (n + 1)
             + 8 * n + 4 * counters["jobs"] + 12 * n)
    bd = bound(moved, counters["cells"] * EXT_OPS_PER_CELL)
    bd["ops_bound_ms"] = (counters["cells"] * EXT_OPS_PER_CELL
                          / INT_OPS_PER_S * 1e3)
    bd["latency_bound_ms"] = counters["longest"] * row_us / 1e3
    bd["bytes"] = moved
    return bd


def ext_row_us(dev, design: str = "new") -> float:
    """One row's dependent chain on the card: the marginal us a row of
    one job (one warp, band 50, a related query) between 1,000 and 2,000
    rows (`ext_kernel_ms`)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 4)
    t = rng.integers(0, 4, 2200).astype(np.uint8)
    ms, rows = [], []
    for lq in (1000, 2000):
        qq = t[:lq].copy()
        for _ in range(lq // 50):
            qq[rng.integers(0, lq)] = rng.integers(0, 4)
        b = ext_batch([t[:lq + 100]], [qq], [60], [50])
        args = ext_args(b, dev)
        ms.append(ext_kernel_ms(ext_kernel_fn(design, b, args), 20, 0.0,
                                f"({design}) {lq} rows"))
        rows.append(ext_call(design, b, args)[1][1].item())
    return (ms[1] - ms[0]) / (rows[1] - rows[0]) * 1e3


def bwasw_run(fa, fq, engine: str, out: pathlib.Path, dev) -> dict:
    """One `bwasw --engine <engine>` (`--device dev` on torch) through
    `bench.bwasw`, which checks its launches (extend_dp alone, once a
    batch, on torch; nothing on native) and that every job the card did not
    run is a counted gate, under-minimum or empty one: wall s, SAM bytes,
    launches, the stage split and the extension line's numbers."""
    from ibwa_tpu_torch import bench
    r = bench.bwasw(fa, fq, out, str(dev) if engine == "torch" else None)
    j = r["jobs"]
    res = {"wall": r["wall"], "sam": out.read_bytes(),
           "launches": r["launches"], "stages": r["stages"],
           "total": j["total"], "empty": j["empty"]}
    if engine == "torch":
        res.update(jobs=j["device"], batches=j["batches"], gate=j["gate"],
                   small=j["under_minimum"])
    return res


def check_extend_alone(dev) -> dict:
    """K9 against its plain version on tests/test_dp_device.py's job
    shapes, on jobs beyond the JAX caps, and on bands wider than a pass of
    the warp: 200 (several passes, on the rings) and 700 (the rows in
    global memory); the launch's shape."""
    import numpy as np
    from ibwa_tpu_torch.ops import dp
    info = dp.extend_dp_info()
    log(f"K9, a batch that fills the card: {info['warps']} warps a block, "
        f"{info['cells_a_lane']} cells a lane, {info['blocks_an_sm']} "
        f"blocks an SM, a grid of {info['grid']}; on the rings "
        f"{info['smem_bytes']} B of static shared memory a block, a ring of "
        f"{info['ring_cells']} cells holds a band of {info['ring_band']} "
        f"(RING_BAND {dp.RING_BAND})")
    if info["ring_band"] != dp.RING_BAND:
        raise AssertionError("K9's ring band differs from ops/dp.py's")
    checks = {}
    for seed, tmax, qmax, band in ((1, 60, 40, 8), (2, 300, 200, 50),
                                   (3, 1500, 1100, 50), (4, 25, 90, 33)):
        checks[f"test shapes seed {seed}"] = check_extend_batch(
            f"test shapes seed {seed} (band {band})",
            ext_jobs(np.random.default_rng(seed), 40, tmax, qmax, band), dev)
    checks["beyond the JAX caps"] = check_extend_batch(
        "beyond the JAX caps", long_ext_jobs(
            np.random.default_rng(SEED + 5),
            [(8000, 3000), (5000, 2500), (7000, 2200), (4500, 900)] * 8), dev)
    for band in (200, 700):
        checks[f"band {band}"] = check_extend_batch(
            f"band {band}, G0 to 1,500", ext_jobs(
                np.random.default_rng(SEED + band), 256, 3000, 1500, band,
                g0_hi=1500), dev, first=True)
    return checks


def sass_row_loop(so: str) -> dict:
    """K9's row loop in the SASS of its rings' entry (`cuobjdump -sass` of
    the built library): the warp instructions from the loop's head to its
    backward branch, and of them the pass loop's (the innermost loop).  A
    row of at most a pass (a band up to 61) runs the body once but for the
    two shuffles that carry a pass to the next.  {} where the dump or the
    loops are not found (logged)."""
    from ibwa_tpu_torch import kernels
    tool = pathlib.Path(kernels._nvcc()).parent / "cuobjdump"
    try:
        text = subprocess.run([str(tool), "-sass", so], check=True,
                              capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        log(f"K9's SASS: cuobjdump failed ({e})")
        return {}
    body = next((f for f in re.split(r"\n\s*Function : ", text)
                 if re.match(r"\S*extend_dp_kernelILb1E", f)), "")
    ins = [int(a, 16) for a in re.findall(r"/\*([0-9a-f]{4,})\*/\s+[@A-Z]",
                                          body)]
    loops = [(int(t, 16), int(a, 16)) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA\s+(0x[0-9a-f]+)",
        body) if int(t, 16) < int(a, 16)]
    inside = lambda x, y: x != y and y[0] <= x[0] and x[1] <= y[1]
    inner = [x for x in loops if not any(inside(y, x) for y in loops)]
    outer = sorted((y for y in loops if inner and inside(inner[0], y)),
                   key=lambda y: y[1] - y[0])
    if len(inner) != 1 or not outer:
        log(f"K9's SASS: no row loop around one pass loop ({loops})")
        return {}
    count = lambda x: sum(1 for a in ins if x[0] <= a <= x[1])
    out = {"row_loop": count(outer[0]), "pass_loop": count(inner[0]),
           "entry": len(ins)}
    log(f"K9's SASS (rings' entry): {out['entry']} instructions, the row "
        f"loop {out['row_loop']} of them, its pass loop {out['pass_loop']}")
    return out


def time_extend_batches(batches: list, dev, sass: dict) -> dict:
    """K9 on a run's batches: against its plain version on the first left
    and right batch (its first version too), each batch timed with the
    redesign and the first version in turns (EXT_READS, three readings of
    each; the first version bitwise equal to the redesign), bounds, one
    row's chain of each design, the warp instructions of its rows at the
    card's issue rate (`sass`: the row loop's); the grid's blocks an SM
    (EXT_GRIDS) and the queue's order on the first left and right batch.
    K9's row of the kernel table, but for its launches."""
    import numpy as np
    import torch
    from ibwa_tpu_torch.ops import dp
    checks = {}
    for k, label in ((0, "the run's first left batch"),
                     (1, "the run's first right batch")):
        checks[label] = check_extend_batch(label, batches[k], dev,
                                           first=True)
    row_us = {d: ext_row_us(dev, d) for d in EXT_SCAN}
    log(f"K9 one row's chain (band 50, one warp): redesign "
        f"{row_us['new']:.4f} us, first version {row_us['first']:.4f} us")
    fmt = lambda v: " / ".join(f"{x:.5f}" for x in v)
    per_batch = []
    for k, b in enumerate(batches):
        args = ext_args(b, dev)
        got, st = ext_call("new", b, args)
        got1, _ = ext_call("first", b, args)
        if not torch.equal(got, got1):
            raise AssertionError(f"K9 batch {k}: the first version differs "
                                 f"from the redesign")
        st = st.tolist()
        counters = {"jobs": len(args[6]), "rows": st[1], "cells": st[2],
                    "longest": st[3]}
        bd = ext_bound(b, counters, row_us["new"])
        if sass:
            bd["issue_ms"] = (counters["rows"] * sass["row_loop"]
                              / WARP_ISSUE_PER_S * 1e3)
        # the least time of each design's launch: its latency estimate, and
        # for the redesign its issue time as well
        floor = {"new": EXT_FLOOR_SHARE * max(bd["latency_bound_ms"],
                                              bd.get("issue_ms", 0.0)),
                 "first": EXT_FLOOR_SHARE * counters["longest"]
                 * row_us["first"] / 1e3}
        ms = {d: [] for d in EXT_SCAN}
        for d in EXT_READS:
            ms[d].append(ext_kernel_ms(ext_kernel_fn(d, b, args), 10,
                                       floor[d], f"({d}) batch {k}"))
        # the integer operations a cell each design's time would allow at
        # the card's full integer rate
        per_cell = {d: statistics.median(v) / 1e3 * INT_OPS_PER_S
                    / counters["cells"] for d, v in ms.items()}
        per_batch.append({"ms": statistics.median(ms["new"]),
                          "first_ms": statistics.median(ms["first"]),
                          "floor_ms": floor["new"],
                          "ops_a_cell_at_rate": per_cell["new"],
                          **counters, **bd})
        shape = dp.extend_dp_info(counters["jobs"])
        log(f"K9 on the run's batch {k} ({'left' if k % 2 == 0 else 'right'})"
            f": {counters['jobs']} jobs ({shape['blocks_an_sm']} blocks an SM, "
            f"a grid of {shape['grid']}), {counters['rows']} rows, "
            f"{counters['cells']} cells, longest {counters['longest']} rows; "
            f"in turns ({', '.join(EXT_READS)}) new {fmt(ms['new'])} ms, "
            f"first {fmt(ms['first'])} ms; bounds "
            f"{bd['bound_ms']:.5f} ms by {bd['bound_by']} (operations "
            f"{bd['ops_bound_ms']:.5f}, {bd['bytes']} B), latency estimate "
            f"{bd['latency_bound_ms']:.5f} ({counters['longest']} rows x "
            f"{row_us['new']:.4f} us)"
            + (f", issue {bd['issue_ms']:.5f} ({counters['rows']} rows x "
               f"{sass['row_loop']} warp instructions; the redesign at "
               f"{bd['issue_ms'] / statistics.median(ms['new']):.3f} of "
               f"it)" if sass else "")
            + f"; at the full integer rate the times allow "
            f"{per_cell['new']:.1f} / {per_cell['first']:.1f} operations a "
            f"cell (new / first)")
    # the grid's blocks an SM on the first left and right batch, forward
    # and back: the launch's own grid is 3 an SM (as many whole blocks an
    # SM as a smaller batch has, at least 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid_ms = {}
    for k in (0, 1):
        b = batches[k]
        args = ext_args(b, dev)
        floor = per_batch[k]["floor_ms"]
        gm = {g: [] for g in EXT_GRIDS}
        for g in EXT_GRIDS + EXT_GRIDS[::-1]:
            gm[g].append(ext_kernel_ms(
                ext_kernel_fn("new", b, args, g * sms), 10, floor,
                f"batch {k}, {g} blocks an SM"))
        grid_ms[k] = {g: statistics.median(v) for g, v in gm.items()}
        log(f"K9 on batch {k}, grids of " + "; ".join(
            f"{g} blocks an SM {fmt(v)}" for g, v in gm.items()) + " ms")
    # the queue's order on the first left batch: the driver's against
    # longest query first (ext_args' order), in turns
    b0 = batches[0]
    args = ext_args(b0, dev)
    orders = {"longest first": args,
              "the driver's": args[:6] + (torch.sort(args[6]).values,)}
    floor = per_batch[0]["floor_ms"]
    order_ms = {name: [] for name in orders}
    for r in range(2):
        for name in orders if r == 0 else list(orders)[::-1]:
            order_ms[name].append(ext_kernel_ms(
                ext_kernel_fn("new", b0, orders[name]), 10, floor,
                f"batch 0, {name}"))
    log(f"K9 on batch 0, the jobs in the driver's order against longest "
        f"query first, in turns: " + "; ".join(
            f"{name} {fmt(v)} ms" for name, v in order_ms.items()))
    mat64 = torch.from_numpy(b0["matrix"].astype(np.int64))
    plain_ms = event_ms(lambda: dp.extend_scan_plain(
        *args, mat64, b0["gap_open"], b0["gap_ext"]), 1)
    first = per_batch[0]
    info = dp.extend_dp_info(first["jobs"])
    return {"max_abs_err": 0, "ms": first["ms"],
            "first_version_ms": first["first_ms"], "plain_ms": plain_ms,
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "ops_bound_ms": first["ops_bound_ms"],
            "latency_bound_ms": first["latency_bound_ms"],
            "issue_ms": first.get("issue_ms"), "sass": sass,
            "row_us": row_us["new"], "first_version_row_us": row_us["first"],
            "batches_ms": [x["ms"] for x in per_batch],
            "first_version_batches_ms": [x["first_ms"] for x in per_batch],
            "batches_jobs": [x["jobs"] for x in per_batch],
            "batches_rows": [x["rows"] for x in per_batch],
            "batches_longest": [x["longest"] for x in per_batch],
            "grid_ms": {("left", "right")[k]: v for k, v in grid_ms.items()},
            "rows": first["rows"], "cells": first["cells"],
            "ops_a_cell_at_rate": first["ops_a_cell_at_rate"],
            "mode": checks["the run's first left batch"]["mode"],
            "blocks_an_sm": info["blocks_an_sm"], "grid": info["grid"],
            "smem_bytes_a_block": info["smem_bytes"],
            "checks": checks}


def run_bwasw_phase(fa, dev) -> dict:
    """K9 on its own (`check_extend_alone`); `bwasw --engine torch --device
    cuda` against `--engine native` on N_LONG long reads, BWASW_ROUNDS
    rounds in turns, SAM byte-equal in each (the first torch run's batches
    recorded and K9 held and timed on them, `time_extend_batches`); the staged
    driver against the sequential one with no device route on the first
    AB_READS reads; the stage
    split of each run and the core's sections.  Returns K9's row of the
    kernel table."""
    import numpy as np
    from ibwa_tpu_torch import bwasw_ab, parity_scale
    from ibwa_tpu_torch.ops import dp
    checks = check_extend_alone(dev)
    fq = bwasw_ab.make_long_reads(fa, N_LONG,
                                  WORK / f"long_{SEED + 3}_{N_LONG}.fq")
    n_bases = sum(len(ln) - 1 for i, ln in enumerate(open(fq, "rb"))
                  if i % 4 == 1)
    log(f"bwasw: {N_LONG} long reads, {n_bases} bases")
    routes = ("torch", "native")
    sam = {e: WORK / f"long_{e}.sam" for e in routes}
    recorded = []
    extend_jobs = dp.extend_jobs

    def record(*a, **k):
        recorded.append([x.copy() if isinstance(x, np.ndarray) else x
                         for x in a])
        return extend_jobs(*a, **k)

    runs = {e: [] for e in routes}
    for r in range(BWASW_ROUNDS):
        for e in routes if r % 2 == 0 else routes[::-1]:
            if e == "torch" and r == 0:
                dp.extend_jobs = record
            try:
                runs[e].append(bwasw_run(fa, fq, e, sam[e], dev))
            finally:
                dp.extend_jobs = extend_jobs
        if runs["torch"][-1]["sam"] != runs["native"][-1]["sam"]:
            raise AssertionError(f"round {r}: bwasw SAM with K9 differs from "
                                 f"the host extensions'")
        if runs["native"][-1]["sam"] != runs["native"][0]["sam"]:
            raise AssertionError(f"round {r}: bwasw SAM differs from round 0")
    t0, n0 = runs["torch"][0], runs["native"][0]
    records = sum(1 for ln in n0["sam"].splitlines() if ln[:1] != b"@")
    segments = -(-N_LONG // 1024)
    if (t0["batches"] != 2 * segments or t0["total"] != n0["total"]
            or records < N_LONG):
        raise AssertionError(f"bwasw: {t0['batches']} batches on the card "
                             f"for {segments} segments, {t0['total']} jobs "
                             f"against the host's {n0['total']}, {records} "
                             f"records")
    log(f"bwasw --engine torch --device cuda against --engine native on "
        f"{N_LONG} reads, {BWASW_ROUNDS} rounds in turns: SAM byte-equal in "
        f"every round ({len(n0['sam'])} bytes, {records} records); extensions "
        f"{t0['jobs']} jobs in {t0['batches']} batches on the card "
        f"({t0['launches']} launched, nothing else), {t0['gate'] + t0['small'] + t0['empty']} on the host (gate "
        f"{t0['gate']}, under the minimum {t0['small']}, empty "
        f"{t0['empty']}) of {t0['total']}; the native run launched nothing")
    for e in routes:
        log(f"bwasw --engine {e}: reads/s of the command's wall, untraced, "
            f"{spread([N_LONG / x['wall'] for x in runs[e]])}; stages a run "
            f"(core / extensions (device route / host loop) / cigar / all, "
            f"s): " + "; ".join(
                f"{s['core']:.4f} / {s['ext']:.4f} ({s['device_route']:.4f} /"
                f" {s['host_loop']:.4f}) / {s['cigar']:.4f} / {s['all']:.4f}"
                for s in (x["stages"] for x in runs[e])))

    # staged against sequential, no device route installed, the core's
    # section timers on in both, on the first AB_READS reads: their SAM is
    # the CLI run's records of those reads (a read's records depend on the
    # read alone: these have no N, whose drand48 draws would chain them)
    sub = WORK / f"long_{SEED + 3}_{AB_READS}.fq"
    parity_scale.first_reads(fq, AB_READS, sub)
    ab = bwasw_ab.staged_ab(str(fa), str(sub), 1, profile=True)
    names = set(parity_scale.fastq_records(sub))
    want = b"".join(ln + b"\n" for ln in n0["sam"].splitlines()
                    if ln[:1] == b"@" or ln.split(b"\t", 1)[0] in names)
    if ab["sam"] != want:
        raise AssertionError("bwasw: the staged driver's SAM differs from "
                             "the CLI run's")
    fmt = lambda x: " / ".join(f"{x[k]:.4f}" for k in bwasw_ab.STAGES
                               + bwasw_ab.CORE)
    walls = [ab[k][0]["wall_s"] for k in ("sequential", "staged")]
    log(f"bwasw --engine native sequential against staged on the first "
        f"{AB_READS} reads, in turns, no device route, the core's section "
        f"timers on in both: SAM byte-equal (and to the CLI run's); wall "
        f"{walls[0]:.3f} s against {walls[1]:.3f} s; "
        f"stages (core / extensions / device route / host loop / cigar / "
        f"all; the core's connectivity prepass / cell fill / hit save, s) "
        f"{fmt(ab['sequential'][0])} against {fmt(ab['staged'][0])}")

    # the run's own batches: the first left and right against the plain
    # version, every one timed
    batches = [dict(zip(("tgt_blob", "tgt_off", "qry_blob", "qry_off", "g0",
                         "band", "matrix", "gap_open", "gap_ext"), a[:9]))
               for a in recorded]
    if len(batches) != t0["batches"]:
        raise AssertionError(f"recorded {len(batches)} batches of "
                             f"{t0['batches']}")
    from ibwa_tpu_torch import kernels
    row = time_extend_batches(batches, dev,
                              sass_row_loop(kernels.build_info["path"]))
    row["checks"] = {**checks, **row["checks"]}
    walls = sorted(x["wall"] for x in runs["torch"])
    share = sum(row["batches_ms"]) / 1e3
    log(f"K9 on all {len(batches)} batches {share * 1e3:.5f} ms = "
        f"{share / statistics.median(walls):.6f} of the median torch run's "
        f"wall ({statistics.median(walls):.3f} s); the first version "
        f"{sum(row['first_version_batches_ms']):.5f} ms; the plain version "
        f"on batch 0 {row['plain_ms']:.3f} ms")
    return {"launches": t0["launches"].get("extend_dp", 0), **row}


def check_sharded(fm, chunk: dict, dev, rows: dict, ptxas: dict) -> dict:
    """B8 on the card: the smoke chunk's block table split by rows into
    MESH_IDX ranges, each an allocation of its own on this card
    (`shard_pair`).  The sharded instantiations of K6 and K8 against the
    flat ones (w / bid / meta; hits, counts, flags and counters, with and
    without the step's rows asked ahead) at every n_idx, and against their
    plain versions over the same split table (`big_planes_plain` at every
    n_idx; `run_search_plain`, finished over B_LANES lanes: hits, counts,
    flags, causes, steps; its rows come through the plain B8,
    `gather_rows_sharded`, at the largest n_idx only, untraced: a traced
    plain loop of ~330,000 launches takes ~90 s), bitwise; then K6 and K8
    timed in turns (MESH_TURNS), flat and split.  A row reports the
    largest n_idx, keeps the flat kernel's bound (the same bytes,
    operations and chain) and both instantiations' ptxas lines.  At the
    caps the engine takes on the card (`card_cfg`), as the flat row."""
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    from ibwa_tpu_torch.fm.device import shard_pair
    cfg, args = chunk["card_cfg"], chunk["args"]
    seqs, lens, md, hs, ssq, bad = args
    pairs = {"flat": fm, **{n: shard_pair(fm, [dev] * n) for n in MESH_IDX}}
    widths = lambda f: engine.big_planes(cfg, f, seqs, lens, hs, ssq)
    flat_big = widths(fm)
    flat_out = {mode: launch_chunk(cfg, fm, args, mode) for mode in (1, 0)}
    as_int = lambda out: [t.to(torch.int64) for t in out]
    plain = {"width_pass": {}, "search_chunk": {}}
    seen = []
    for n in MESH_IDX:
        sp = pairs[n]
        want_big = []
        plain["width_pass"][n] = timed_ms(lambda: want_big.append(
            engine.big_planes_plain(cfg, sp, seqs, lens, hs, ssq)), 1)[0]
        got = widths(sp)
        err = max(max_abs_err(got, flat_big), max_abs_err(got, want_big[-1]))
        for mode in (1, 0):   # every output but the lanes' own counters
            out = launch_chunk(cfg, sp, args, mode)
            err = max(err, max_abs_err(as_int(out[:5]),
                                       as_int(flat_out[mode][:5])))
        if n == MESH_IDX[-1]:
            out_plain = []
            plain["search_chunk"][n] = event_ms(lambda: out_plain.append(
                engine.run_search_plain(cfg, sp, *args, n_lanes=B_LANES)), 1)
            hold_search_chunk(sp, f"B8 at n_idx {n} against the plain loop "
                              f"over the split table", cfg, args, B_LANES,
                              out_plain[-1])
        if err:
            raise AssertionError(
                f"B8 at n_idx={n}: the sharded kernels differ from the flat "
                f"ones or the plain versions (max abs err {err})")
        seen.append(f"n_idx {n} ({sp.shard_rows} rows a range)")
    log(f"B8: width_pass and search_chunk over the table split in "
        f"{', '.join(seen)} on {dev}: bitwise equal to the flat kernels "
        f"(both step modes) and to the plain versions over the split table "
        f"(plain width pass, device ms: {plain['width_pass']}; plain loop at "
        f"n_idx {MESH_IDX[-1]}, the CUDA-event span of its launches, the "
        f"host's included: {plain['search_chunk']} ms)")

    times = {"width_pass": {}, "search_chunk": {}}
    for turn in MESH_TURNS:
        f = pairs[turn]
        key = ("search_chunk_kernel" if turn == "flat"
               else "search_chunk_sharded_kernel")
        times["search_chunk"].setdefault(turn, []).append(
            time_search_chunk(cfg, f, args, 10, 1, key))
        times["width_pass"].setdefault(turn, []).append(
            timed_ms(lambda: widths(f), 20)[0])
    out = {}
    for name in ("width_pass", "search_chunk"):
        t = times[name]
        med = {k: statistics.median(v) for k, v in t.items()}
        lines = {e: v for e, v in ptxas.items() if e.startswith(name)
                 and f"<Li{fm.wpb}E" in e}
        out[f"{name}_sharded"] = {
            "max_abs_err": 0, "n_idx": MESH_IDX[-1], "ms": med[MESH_IDX[-1]],
            "plain_ms": plain[name][MESH_IDX[-1]],
            **{k: rows[name][k] for k in ("bound_ms", "bound_by")},
            **({"latency_bound_ms": rows[name]["latency_bound_ms"]}
               if "latency_bound_ms" in rows[name] else {}),
            "library_ms": None, "flat_ms": med["flat"],
            "ms_by_n_idx": {str(k): med[k] for k in MESH_IDX},
            "turns_ms": {str(k): v for k, v in t.items()},
            "plain_ms_by_n_idx": {str(k): v for k, v in plain[name].items()},
            "ptxas": lines}
        log(f"B8 {name}: device ms in turns {' / '.join(map(str, MESH_TURNS))}"
            f": " + "; ".join(f"{k}: {' '.join(f'{x:.5f}' for x in v)}"
                              for k, v in t.items())
            + f"; medians {med}; split / flat "
            + ", ".join(f"n_idx {k} {med[k] / med['flat']:.4f}x"
                        for k in MESH_IDX)
            + f"; ptxas {lines}")
    kernels.reset_launches()
    return out


def k5_on_run(calls, warp_us: float) -> dict:
    """K5 on the intervals of a `sampe` run's first walker call (as
    `parity_scale.WalkRecorder` keeps them): bitwise against its plain
    version and the run's values; three readings of CUDA events around 5
    launches, the plain version's time; its bounds by `walk_footprint`
    and `walk_bound` at `warp_us` a dependent fetch."""
    import numpy as np
    import torch
    from ibwa_tpu_torch.fm import walk
    walker, strand, ks, ls, vals, last = calls[0]
    case = walk_case(walker, strand, ks, ls)
    mask = walker.sa_intv - 1
    args = (walker.fm, walker.sampled, case["iv"], case["off"], 0,
            case["n"], mask)
    got, stats = walk.lf_resolve(*args)
    err = max_abs_err([got], [walk.resolve_intervals_plain(*args)[0]])
    if err or not np.array_equal(got.cpu().numpy().view(np.uint32), vals):
        raise AssertionError(f"K5 on the run's rows: kernel != plain or the "
                             f"run's values (max abs err {err})")
    stream = torch.cuda.current_stream().cuda_stream
    readings = [event_ms(lambda: walk._launch_resolve(*args, stream), 5)
                for _ in range(3)]
    plain_ms = event_ms(lambda: walk.resolve_intervals_plain(*args), 1)
    fp = walk_footprint(walker.fm, case["strand"], case["k"], mask)
    _, steps, longest = stats.tolist()
    if (steps, longest) != (fp["steps"], fp["longest"]):
        raise AssertionError(f"K5's counters {stats.tolist()} against "
                             f"walk_footprint {fp}")
    n_iv = case["iv"].shape[1]
    return {"rows": case["n"], "intervals": n_iv, "run_waves": last["waves"],
            "ms": statistics.median(readings), "ms_readings": readings,
            "plain_ms": plain_ms, "max_abs_err": err,
            **walk_bound(n_iv, case["n"], fp, walker.fm.wpb, warp_us),
            "steps": fp["steps"], "longest_walk": fp["longest"],
            "rows_fetched": fp["rows"], "sampled_words": fp["slots"]}


def k5_text(row: dict, warp_us: float) -> str:
    return (f"{row['rows']} rows of {row['intervals']} intervals (the run: "
            f"{row['run_waves']} wave) bitwise equal to the plain version "
            f"and the run's values; {row['steps']} LF steps over "
            f"{row['rows_fetched']} distinct table rows and "
            f"{row['sampled_words']} sampled words, longest walk "
            f"{row['longest_walk']}; device ms {row['ms_readings']} (CUDA "
            f"events, 5 launches each), plain {row['plain_ms']:.3f}; bounds "
            f"{row['bytes_bound_ms']:.5f} by bytes, {row['ops_bound_ms']:.5f} "
            f"by operations, {row['latency_bound_ms']:.5f} by latency "
            f"({row['longest_walk']} x {warp_us:.3f} us)")


def aln_summaries(obj, path: str = ""):
    """(path, summary) of every device `aln` summary inside a report of
    parity_scale (`aln_summary`: the ones that carry a fallback split)."""
    if isinstance(obj, dict):
        if "fallback_by_cause" in obj and "fallback_reads" in obj:
            yield path, obj
        for k, v in obj.items():
            if k != "batches":
                yield from aln_summaries(v, f"{path}/{k}" if path else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from aln_summaries(v, f"{path}/{i}")


def host_threads_of(obj):
    """Every `host_threads` inside a report (the `[aln] stats` of each
    `aln` it ran)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "host_threads":
                yield v
            else:
                yield from host_threads_of(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from host_threads_of(v)


def run_scale_phase(warp_us: float, rows: dict) -> dict:
    """Phase 4g: every configuration of `ibwa_tpu_torch/parity_scale.py`
    at full scale on the card (it raises on the first inequality), then
    K5 on repeat_pe's recorded intervals (bitwise against its plain
    version and the run's values, CUDA events, bounds by `walk_footprint`)
    and the width pass and the chunk search on the CLI path, gappy and
    default options (device ms a launch from a profiler session around one
    device-only `aln` of aln_options' reads, .sai byte-equal to native);
    logs every device `aln`'s overflow fallback by cause.
    Adds those readings to the kernel table's rows; returns the launches
    of the configurations' commands."""
    import torch
    from ibwa_tpu_torch import parity_scale
    say = lambda msg: log(f"4g {msg}")
    work = REPO / ".bench" / "parity_scale_torch"
    res = {r["config"]: r for r in parity_scale.run(
        device="cuda", scale="full", work=work, report=say, say=say)}
    launches = collections.Counter()
    for r in res.values():
        launches.update(r["launches"])
    full = parity_scale.SCALES["full"]
    ecoli = res["ecoli_seam"]
    if (len(ecoli["sampe"]["batches"]), ecoli["samse"]["batches"],
            ecoli["samse"]["records"]) != (2, 2, full.ecoli_pairs) or any(
            st["n_batches"] != 2 for end in ecoli["aln"]
            for st in end.values()):
        raise AssertionError("ecoli_seam did not cross the batch seam")
    for name in ("width_pass", "search_chunk", "lf_walk"):
        if launches[name] <= 0:
            raise AssertionError(f"4g never launched {name}: {launches}")
    secs = {name: round(r["seconds"], 1) for name, r in res.items()}
    say(f"every configuration equal; seconds {secs}")
    split = rows["search_chunk"]["scale_fallback_by_cause"] = {}
    for path, st in aln_summaries(res):
        split[path] = {"fallback": st["fallback_reads"],
                       "device_reads": st["device_reads"],
                       **st["fallback_by_cause"]}
        say(f"aln {path}: overflow fallback {st['fallback_reads']} of "
            f"{st['device_reads'] + st['fallback_reads']} device reads, by "
            f"cause {st['fallback_by_cause']}; the native search on "
            f"{st['host_threads']} host thread(s)")
    say(f"host threads of the native search in every aln of 4g, native "
        f"runs included: {sorted(set(host_threads_of(res)))}")

    # K5 on repeat_pe's intervals, thousands of rows wide
    calls = res["repeat_pe"]["sampe"].pop("_calls")
    wave = res["repeat_pe"]["wave_check"][0]
    row = rows["lf_walk"]["repeat_pe"] = {
        **k5_on_run(calls, warp_us), "check_waves": wave["waves"]}
    say(f"K5 on repeat_pe's rows (the check: {wave['waves']} waves of "
        f"{full.wave_rows} rows, bitwise equal): {k5_text(row, warp_us)}")
    del calls
    torch.cuda.empty_cache()

    # the width pass and the chunk search on the CLI path, gappy / default
    paths = res["aln_options"]["_paths"]
    for name in ("gappy", "default"):
        out, st = WORK / f"scale_{name}.sai", {}
        us = traced(lambda: st.update(parity_scale.aln(
            paths["fa"], paths["fq"], out, "device_only", "cuda",
            parity_scale.OPTION_SETS[name])), 1)
        parity_scale.same_bytes(f"aln {name}", out, work / "full" /
                                "aln_options" / f"{name}.native.sai")
        reading = {"acap": sorted({b["acap"] for b in st["batches"]}),
                   "launches": st["launches"]["search_chunk"],
                   "fallback_share": st["fallback_reads"] / st["reads"],
                   "search_s": st["search_s"]}
        per = {}
        for kernel, key in (("search_chunk", "search_chunk_kernel"),
                            ("width_pass", "width_pass_kernel")):
            seen = sum(n for k, (_, n) in us.items() if key in k)
            per[kernel] = kernel_ms(us, key) / seen if seen else None
            rows[kernel][f"cli_{name}"] = {**reading, "launches_seen": seen,
                                           "ms_a_launch": per[kernel]}
        say(f"aln {name} ({' '.join(parity_scale.OPTION_SETS[name])}) on "
            f"{st['reads']} reads of the 63 Mbp primary, device-only, the "
            f"profiler on: .sai byte-equal to native; ACAP "
            f"{reading['acap']}, {reading['launches']} chunks, fallback "
            f"share {reading['fallback_share']:.4f}, search_s "
            f"{st['search_s']:.3f}; device ms a launch (None: the profiler "
            f"saw none) {per}")
    return dict(launches)


def chunk_case(fa, fq, dev) -> tuple:
    """The block table of `fa` on the card and the first PERSIST_N reads
    of `fq` as the engine takes a chunk (`smoke_chunk`)."""
    from ibwa_tpu_torch.fm.device import build_device_pair
    from ibwa_tpu_torch.fm.fmindex import FmIndex
    from ibwa_tpu_torch.index.builder import load_index
    fms = (FmIndex(load_index(str(fa), 0)), FmIndex(load_index(str(fa), 1)))
    return build_device_pair(fms[0], fms[1], dev), smoke_chunk(fms, fq, dev)


@contextlib.contextmanager
def fetch_tally():
    """Count the bounds the plain width pass and step ask occ rows for,
    inside the block: the pair queries `engine._occ` gives them (K2's
    entries on a card) are wrapped for the block; each asks the rows of
    (k - 1, l) of its intervals, its masked lanes' too.  Yields a dict
    that gets, as the block ends, "occ_bounds" and
    "occ_bounds_at_or_above_2_31" (not NEG1, the k - 1 of row 0)."""
    import torch
    from ibwa_tpu_torch.align import engine
    from ibwa_tpu_torch.u32 import MASK, NEG1
    plain = engine._occ
    seen = []

    def count(k, l):
        b = torch.stack([(k - 1) & MASK, l])
        seen.append((b.numel(), ((b >= HIGH) & (b != NEG1)).sum()))

    def counted(fm):
        occ4, occ1 = plain(fm)

        def occ4_counted(fm_, strand, k, l):
            count(k, l)
            return occ4(fm_, strand, k, l)

        def occ1_counted(fm_, strand, k, l, c):
            count(k, l)
            return occ1(fm_, strand, k, l, c)

        return occ4_counted, occ1_counted

    out = {}
    engine._occ = counted
    try:
        yield out
    finally:
        engine._occ = plain
        out["occ_bounds"] = sum(n for n, _ in seen)
        out["occ_bounds_at_or_above_2_31"] = int(sum(h for _, h in seen))


def table_chunk_rows(label: str, case: tuple, smoke: tuple, hbm_us: float,
                     sass: dict, say, tally: bool = False) -> dict:
    """K6 and K8 on the chunk of `case` (`chunk_case`) bitwise against
    their plain versions (`big_planes_plain`, the plain loop, whose span
    of CUDA events is its time), then both timed in turns with the smoke's
    32 Mbp chunk `smoke` (TABLE_TURNS), beside their bounds; the latency
    bounds at `hbm_us` a dependent fetch; K8's fallback split by cause.
    With `tally`, the bounds the plain versions' occ queries asked rows
    for (`fetch_tally`), and the hits at and above 2^31.  Returns {kernel:
    row}."""
    from ibwa_tpu_torch.align import engine
    fm, chunk = case
    cfg, args = chunk["cfg"], chunk["args"]
    seqs, lens, md, hs, ssq, bad = args
    got = engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
    plain_w = lambda: engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    with (fetch_tally() if tally else contextlib.nullcontext({})) as w_t:
        want_w = plain_w()
    err = max_abs_err(got, want_w)
    if err:
        raise AssertionError(f"width_pass on {label} chunk: kernel != "
                             f"plain (max abs err {err})")
    box = []
    with (fetch_tally() if tally else contextlib.nullcontext({})) as s_t:
        plain_span = event_ms(lambda: box.append(engine.run_search_plain(
            cfg, fm, *args, n_lanes=B_LANES)), 1)
    want = box[0]
    seen, (*_, it, counters) = hold_search_chunk(
        fm, f"{label} chunk against the plain loop", cfg, args, B_LANES, want)
    c = dict(zip(engine.COUNTERS, counters.tolist()))
    steps, longest, total = want[3], int(it.max()), c["iterations"]
    cases = {"table": case, "smoke": smoke}
    times = {name: {"width_pass": [], "search_chunk": []} for name in cases}
    for name in TABLE_TURNS:
        fm_t, ch = cases[name]
        c_t, a_t = ch["cfg"], ch["args"]
        times[name]["width_pass"].append(timed_ms(
            lambda: engine.big_planes(c_t, fm_t, a_t[0], a_t[1], a_t[3],
                                      a_t[4]), 20)[0])
        times[name]["search_chunk"].append(time_search_chunk(
            c_t, fm_t, a_t, 10, 1))
    w_moved, w_ops, fetches, chain = width_work(cfg, fm, got, args)
    s_moved, s_ops, s_ins, _ = chunk_work(cfg, fm, want, c, sass["new"])
    table = {"seq_len": fm.seq_len, "table_bytes": nbytes(fm.blocks),
             "reads": lens.shape[0], "lanes": B_LANES, "acap": cfg.acap,
             "max_abs_err": err}
    if tally:
        s_t["hits_at_or_above_2_31"] = int(
            (engine.masked_hits(*want[:3])[:, :, 1] >= HIGH).sum())
    out = {}
    for kernel, moved, ops, lat, extra in (
            ("width_pass", w_moved, w_ops, chain,
             {"bases_fetched": fetches, "longest_chain": chain,
              "plain_ms": timed_ms(plain_w, 2)[0], **w_t}),
            ("search_chunk", s_moved, s_ops, longest,
             {"steps": steps, "longest_read": longest,
              "longest_lane": c["longest_lane"], "lane_iterations": total,
              "fm_rows": c["rows"], "issue_ms": issue_ms(s_ins),
              "fallback_by_cause": cause_split(want[4], want[2]),
              "plain_span_ms": plain_span, **s_t})):
        mine, smoke_ms = times["table"][kernel], times["smoke"][kernel]
        out[kernel] = r = {
            **table, "ms": statistics.median(mine), "ms_readings": mine,
            "smoke_ms_readings": smoke_ms,
            "ratio": statistics.median(mine) / statistics.median(smoke_ms),
            **bound(moved, ops), "latency_bound_ms": lat * hbm_us / 1e3,
            **extra}
        say(f"{kernel} on {label} table ({r['table_bytes']} bytes, seq_len "
            f"{fm.seq_len}), {r['reads']} reads on {B_LANES} lanes, ACAP "
            f"{cfg.acap}: bitwise equal to its plain version; device ms "
            f"{mine} against the smoke's 32 Mbp chunk {smoke_ms}, in turns "
            f"{TABLE_TURNS} ({r['ratio']:.3f}x); bound {r['bound_ms']:.5f} "
            f"({r['bound_by']}, {moved} bytes); latency {lat} x "
            f"{hbm_us:.3f} us = {r['latency_bound_ms']:.5f} ms"
            + (f" to {engine.E_UNROLL * r['latency_bound_ms']:.5f}"
               if kernel == "search_chunk" else "") + f"; {extra}")
    say(f"search_chunk: {seen}")
    return out


def run_large_phase(gbp: float, warp_us: dict, rows: dict, fa, fq, dev,
                    sass: dict, rounds: int = ROUNDS,
                    sweep: bool = True) -> dict:
    """Phase 4h: `ibwa_tpu_torch/index_3gbp.py` at `gbp` Gbp on the card
    (its 32-contig genome indexed in a child process; aln device-only,
    hybrid and native on both ends and the rates; sampe -R K5 against the
    host walks; it raises on the first inequality), then on its table:
    K5 on sampe's recorded intervals (`k5_on_run`), K6 and K8 on the
    first 2,048 reads of end 1 bitwise against their plain versions
    (`big_planes_plain`, the plain loop), and both timed in turns with
    the smoke's chunk (TABLE_TURNS), beside their bounds; the latency
    bounds at table (c)'s one-warp step (HBM); K8's fallback split by
    cause, and with `sweep` the cap sweep on that chunk against the phased
    kernels' loop (`cap_sweep`: the plain loop at every setting of the
    sweep does not fit the smoke's time twice).  Adds the readings to the
    kernel table's rows as `large_table`; fails at the end if the index
    took more than the module's 16 GB of host memory; returns the launches
    of the module's commands."""
    import gc
    import torch
    from ibwa_tpu_torch import index_3gbp
    from ibwa_tpu_torch.align import engine
    say = lambda msg: log(f"4h {msg}")
    t0 = time.perf_counter()
    res = index_3gbp.run(gbp, align_too=True, device="cuda",
                         work=REPO / ".bench" / "index3g_torch",
                         rounds=rounds, say=say)
    launches = res["launches"]
    for name in ("width_pass", "search_chunk", "lf_walk"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"4h never launched {name}: {launches}")
    mem = res["memory"]
    say(f"{gbp} Gbp, {res['bases']} bases in 32 contigs: every .sai and "
        f"the SAM equal in {time.perf_counter() - t0:.1f} s; index "
        f"{res['index_wall_s']} s ({res['path']}), peak RSS "
        f"{res['max_rss_gb']} GB ({res['rss_bytes_per_base']} bytes a "
        f"base); on the card {mem['blocks_bytes']} bytes of block table "
        f"and {mem['sampled_bytes']} of sampled arrays (load "
        f"{mem['load_s']:.2f} s, build {mem['blocks_s']:.2f} s, upload "
        f"{mem['upload_s']:.2f} s), max allocated: aln "
        f"{mem['aln_max_allocated']}, sampe {mem['sampe_max_allocated']} "
        f"bytes")

    # K5 on sampe's intervals over the large table
    hbm_us = warp_us["c"]
    calls = res["sampe"].pop("_calls")
    row = rows["lf_walk"]["large_table"] = k5_on_run(calls, hbm_us)
    say(f"K5 on sampe's rows of the {gbp} Gbp table: "
        f"{k5_text(row, hbm_us)}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()

    # K6 and K8 on one chunk of end 1, bitwise, then timed in turns with
    # the smoke's chunk of the same shape
    cases = {"large": chunk_case(res["_paths"]["fa"], res["_paths"]["fqs"][0],
                                 dev),
             "smoke": chunk_case(fa, fq, dev)}
    got = table_chunk_rows(f"the {gbp} Gbp table's", cases["large"],
                           cases["smoke"], hbm_us, sass, say)
    for kernel, r in got.items():
        rows[kernel]["large_table"] = {"gbp": gbp, **r}
    fm, chunk = cases["large"]
    if sweep:
        rows["search_chunk"]["large_table"]["cap_sweep"] = cap_sweep(
            fm, chunk, f"{gbp} Gbp", plain=False)
    del cases, fm, chunk, got
    gc.collect()
    torch.cuda.empty_cache()
    if not res["under_16gb"]:
        raise AssertionError(f"the index took {res['max_rss_gb']} GB of host "
                             f"memory, above index_3gbp's "
                             f"{index_3gbp.RSS_LIMIT_GB} GB")
    return launches


def hold_split(fm, chunk: dict, dev, label: str, say) -> dict:
    """The chunk's table split by rows in two ranges on this card
    (`shard_pair`): the sharded K6 and K8 bitwise against the flat ones
    (planes; hits, counts, flags, causes and the step count, finished as
    the engine finishes them).  Its launch checks the split table with
    `shards_ok`."""
    from ibwa_tpu_torch.align import engine
    from ibwa_tpu_torch.fm.device import shard_pair
    cfg, args = chunk["cfg"], chunk["args"]
    seqs, lens, md, hs, ssq, bad = args
    split = shard_pair(fm, [dev, dev])
    flat_big = engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
    err = max_abs_err(engine.big_planes(cfg, split, seqs, lens, hs, ssq),
                      flat_big)
    out_h, nh, fb, it, cause, _ = launch_chunk(cfg, fm, args, 1)
    want = engine.finish_chunk(out_h.permute(1, 2, 0), nh, fb, it, cause,
                               B_LANES)
    text, _ = hold_search_chunk(split, f"{label} table split in two "
                                f"against the flat one", cfg, args, B_LANES,
                                want, modes=(1,))
    if err:
        raise AssertionError(f"{label}: the split width pass differs from "
                             f"the flat one (max abs err {err})")
    say(f"width_pass and search_chunk over {label} table split in two "
        f"ranges of {split.shard_rows} rows on {dev} (seq_len "
        f"{fm.seq_len}): bitwise equal to the flat kernels; {text}")
    return {"seq_len": fm.seq_len, "shard_rows": split.shard_rows,
            "n_idx": 2, "max_abs_err": err, "equal": True}


def run_tall_phase(warp_us: dict, rows: dict, fa, fq, dev,
                   sass: dict) -> dict:
    """Phase 4l: the lifted tables of the smoke's 32 Mbp index
    (`ibwa_tpu_torch/tall_table.py`: `straddle`, its rows across 2^31;
    `top`, seq_len' = 2^32 - 2) with the smoke's 16,384 reads after the
    probe reads of A's.  On each lift: aln device-only, hybrid and native
    (.sai byte-equal; on straddle also `aln --idx 2` over the table split
    in two on this card), the hits at and above 2^31, the walker on the
    run's intervals and on random ones at and above 2^31 against the host
    walk (`tall_table.run`); then K5 on that walker call (`k5_on_run`);
    K6 and K8 on the first 2,048 reads (the probes among them) bitwise
    against their plain versions, the plain versions' occ bounds at and
    above 2^31 counted, timed in turns with the smoke's chunk
    (`table_chunk_rows`); K8 at ACAP 1024 / iter_cap 6,144 against the
    phased kernels, every read it keeps equal to the host search's hits
    (`cap_sweep`: the probes stay on the card there); on straddle the
    split table's K6 and K8 bitwise against the flat ones (`hold_split`).
    Every count at and above 2^31 must be above 0.  Adds the readings to
    the kernel table's rows as `tall_table`; returns the launches of the
    aln commands."""
    import torch
    from ibwa_tpu_torch import tall_table
    say = lambda msg: log(f"4l {msg}")
    work = REPO / ".bench" / "tall"
    work.mkdir(parents=True, exist_ok=True)
    reads = tall_table.probe_fastq(fq, work / "reads.fq")
    smoke = chunk_case(fa, fq, dev)
    hbm_us = warp_us["c"]
    launches = collections.Counter()
    for name in tall_table.LIFTS:
        t0 = time.perf_counter()
        rec = tall_table.run(str(fa), reads, name, device="cuda", work=work,
                             split=name == "straddle", say=say)
        for got in rec["launches"].values():
            launches.update(got)
        k5 = k5_on_run(rec.pop("_calls"), hbm_us)
        rows["lf_walk"].setdefault("tall_table", {})[name] = {
            "lift": name, "m": rec["m"], **k5, **rec["walk"]}
        say(f"K5 on the {name} lift's walker call: {k5_text(k5, hbm_us)}")
        case = chunk_case(rec["_prefix"], reads, dev)
        got = table_chunk_rows(f"the {name} lift's", case, smoke, hbm_us,
                               sass, say, tally=True)
        for kernel, r in got.items():
            rows[kernel].setdefault("tall_table", {})[name] = {
                "lift": name, "m": rec["m"], **r}
        counts = {"K6's occ bounds": got["width_pass"][
                      "occ_bounds_at_or_above_2_31"],
                  "K8's occ bounds": got["search_chunk"][
                      "occ_bounds_at_or_above_2_31"],
                  "K8's hits": got["search_chunk"]["hits_at_or_above_2_31"]}
        if min(counts.values()) <= 0:
            raise AssertionError(f"4l {name}: at or above 2^31 in the "
                                 f"chunk: {counts}")
        fm, chunk = case
        rows["search_chunk"]["tall_table"][name]["wide_caps"] = cap_sweep(
            fm, chunk, f"the {name} lift's", plain=False,
            settings=[(1024, 6144)],
            must_keep=range(len(tall_table.PROBE_READS)))[0]
        if name == "straddle":
            held = hold_split(fm, chunk, dev, f"the {name} lift's", say)
            for kernel in ("width_pass_sharded", "search_chunk_sharded"):
                rows.setdefault(kernel, {})["tall_table"] = {
                    "lift": name, **held,
                    "aln_launches": rec["launches"]["split"]}
        rows["search_chunk"]["tall_table"][name]["aln"] = {
            k: rec[k] for k in ("seq_len", "genome_seq_len", "primary",
                                "seconds", "bytes", "hits",
                                "hits_at_or_above_2_31", "widest_hit",
                                "launches", "aln_s")}
        del case, fm, chunk, got
        gc.collect()
        torch.cuda.empty_cache()
        say(f"{name} done in {time.perf_counter() - t0:.1f} s")
    return dict(launches)


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "host_frac",
              "device_only_vs_ref", "baseline", "device", "rounds",
              "host_threads"}
BENCH_KERNELS = {"width_pass", "search_chunk", "lf_walk", "extend_dp"}


def run_bench_phase() -> dict:
    """Phase 4i: `ibwa_tpu_torch.bench` in-process at full scale, one round,
    on its own inputs: exit 0, the record's keys, `aln` launching the width
    pass and the chunk search alone, one each a chunk, and the launch
    counters, set to 0 just before, equal to the bench's own count.
    Returns those launches."""
    from ibwa_tpu_torch import bench, kernels
    kernels.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--rounds", "1"])
    launches = dict(kernels.launches)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"the bench exited {rc} with {len(lines)} lines")
    rec = json.loads(lines[-1])
    if set(rec) != BENCH_KEYS or rec["device"] != CARD or rec["rounds"] != 1 \
            or rec["host_threads"] != 1:
        raise AssertionError(f"the bench's record: {rec}")
    extra = json.loads((bench.WORK / "full" / "bench_extra.json").read_text())
    aln = extra["aln"]
    if aln["chunks"] <= 0 or aln["launches"] != dict.fromkeys(
            ALN_KERNELS, aln["chunks"]):
        raise AssertionError(f"the bench's aln launched {aln['launches']} "
                             f"for {aln['chunks']} chunks")
    if launches != extra["launches"] or set(launches) != BENCH_KERNELS:
        raise AssertionError(f"the bench launched {launches}, by its own "
                             f"count {extra['launches']}")
    d = aln["device_round"]
    log(f"4i bench record: {json.dumps(rec)}")
    log(f"4i bench: aln reads/s hybrid {aln['rates']['hybrid']['median']:.1f},"
        f" device-only {aln['rates']['device_only']['median']:.1f}, native "
        f"{aln['rates']['native']['median']:.1f}, the native search on "
        f"{rec['host_threads']} host thread(s) in every route; device-only "
        f"round: device ms {d['device_ms']} ({d['device_ms_source']}), "
        f"busy share "
        f"{d['busy_share']:.4f}, fallback {d['fallback_reads']} by cause "
        f"{d['fallback_by_cause']}; sampe -R K5 "
        f"{extra['sampe']['k5']['median']:.1f}, host walks "
        f"{extra['sampe']['host']['median']:.1f}; samse "
        f"{extra['samse']['rate']['median']:.1f}; bwasw K9 "
        f"{extra['bwasw']['torch']['median']:.1f}, host "
        f"{extra['bwasw']['native']['median']:.1f}; seconds "
        f"{extra['seconds']}")
    return launches


def run_dist_phase() -> dict:
    """Phase 4j: `ibwa_tpu_torch.dist_aln` in-process as a user calls it,
    two workers on cuda:0 over its 40,000-read corpus: exit 0, the merged
    .sai equal to one process's and that to native's, each worker's
    launches one width pass and one chunk search a chunk and nothing else,
    none in this process.  Returns the workers' launches summed."""
    from ibwa_tpu_torch import dist_aln, kernels
    kernels.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dist_aln.main(["--device", "cuda:0", "--json"])
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"dist_aln exited {rc} with {len(lines)} lines")
    rec = json.loads(lines[-1])
    if not (rec["ok"] and rec["merged_sai_identical"]
            and rec["native_sai_identical"]) or rec["device"] != CARD \
            or rec["devices"] != ["cuda:0"] * 2 \
            or rec["reads"] != dist_aln.READS:
        raise AssertionError(f"dist_aln's record: {json.dumps(rec)[:2000]}")
    if kernels.launches:
        raise AssertionError(f"4j's parent launched {dict(kernels.launches)}")
    launches = collections.Counter()
    workers = rec["per_process"] + [rec["single_process"]]
    for w in workers:
        if w["chunks"] <= 0 or w["launches"] != dict.fromkeys(ALN_KERNELS,
                                                              w["chunks"]):
            raise AssertionError(f"4j worker {w['pid']} launched "
                                 f"{w['launches']} for {w['chunks']} chunks")
        launches.update(w["launches"])
    log(f"4j dist_aln: {rec['reads']} reads, merged .sai of 2 processes on "
        f"cuda:0 byte-equal to one process's and that to native's; reads/s "
        f"of go to the last exit: 2 processes "
        f"{rec['aggregate_reads_per_s']:.1f} ({rec['wall_s_2proc']:.3f} s), "
        f"1 process {rec['aggregate_reads_per_s_1proc']:.1f} "
        f"({rec['wall_s_1proc']:.3f} s), native in this process "
        f"{rec['reads'] / rec['wall_s_native']:.1f} on "
        f"{rec['native_host_threads']} host thread(s); workers (2 + 1): "
        + "; ".join(f"{w['reads']} reads, {w['seconds']:.3f} s, search_s "
                    f"{w['search_s']:.3f}, fallback {w['fallback_reads']} on "
                    f"{w['host_threads']} host thread(s), {w['chunks']} "
                    f"chunks, peak {w['peak_mem_bytes']} bytes"
                    for w in workers))
    return dict(launches)


def run_input_phase() -> dict:
    """Phase 4k: `ibwa_tpu_torch.input_routes` in-process at full scale
    (it raises on the first inequality): every route equal, each aln
    route's device run with reads on the card and one width pass and one
    chunk search a chunk, each sampe route's lf_walk once a wave, and the
    launch counters, set to 0 just before, equal to the routes' own
    counts (the 2^31 check's launches are a check's, not counted).  A
    line a route.  Returns the routes' launches."""
    from ibwa_tpu_torch import input_routes, kernels
    kernels.reset_launches()
    recs = input_routes.run(device="cuda", scale="full",
                            work=input_routes.WORK,
                            say=lambda msg: log(f"4k {msg}"))
    launches = dict(kernels.launches)
    want = collections.Counter()
    for r in recs:
        if not r["equal"]:
            raise AssertionError(f"4k {r['route']} is not equal")
        if r["route"] in input_routes.ALN_ROUTES and (
                r["device_reads"] <= 0 or r["launches"] != dict.fromkeys(
                    ALN_KERNELS, r["chunks"])):
            raise AssertionError(f"4k {r['route']}: {r['device_reads']} "
                                 f"device reads, launches {r['launches']} "
                                 f"for {r['chunks']} chunks")
        if r["route"].startswith("sampe") and (
                r["launches"] != {"lf_walk": r["waves"]} or r["refused"]
                or r["host_walks"] or r["device_rows"] <= 0):
            raise AssertionError(f"4k {r['route']}: {json.dumps(r)}")
        want.update(r["launches"])
    if [r["route"] for r in recs] != list(input_routes.ROUTES) \
            or launches != dict(want):
        raise AssertionError(f"4k launched {launches}, by the routes' own "
                             f"count {dict(want)}")
    return launches


def probe_warp_us(dev) -> dict:
    """One warp's marginal time a dependent row fetch (K3 at 32 lanes) on
    the probe's tables b and c, for the latency bounds of 4h alone."""
    from ibwa_tpu_torch import bench_chase as bc
    out = {}
    for label, n, w in PROBE_TABLES[1:]:
        table = bc.make_table_device(n, w, SEED, dev)
        recs = bc.probe(table, [32], [4], PROBE_STEPS, PROBE_DELTA, reps=3,
                        plain_mw=False, label=label)
        del table
        if not all(r["parity"] for r in recs):
            raise AssertionError(f"probe parity failed: {recs}")
        out[label] = next(r["marginal_us_per_step"] for r in recs
                          if r["variant"] == "chase")
    log(f"one-warp dependent fetch, us/step: {out}")
    return out


def run_mesh_aln(fa, fq) -> dict:
    """`aln` device-only over one entry (`--device cuda:0`), two entries on
    the one card (`--device cuda:0,cuda:0`: reads split, a table each, a
    stream each) and one entry whose table is split in two ranges on it
    (`--device cuda:0,cuda:0 --idx 2`, B8), ROUNDS rounds in turns: every
    .sai byte-equal to `--engine native`'s (4c), one width pass and one
    chunk search launch per device entry and chunk, the split run's
    through the sharded instantiations.  On several cards the same over
    cuda:0,cuda:1 (the peer path); on one card that is not run.  Returns
    the split run's launches, for B8's rows.  First the port's
    `dryrun_multichip` over 4 entries on the visible cards."""
    import torch
    from ibwa_tpu_torch import kernels
    from ibwa_tpu_torch.align import engine
    from ibwa_tpu_torch.parallel import mesh
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mesh.dryrun_multichip(4)   # visible cards, else cuda:0 four times
    log(out.getvalue().strip())
    runs = {"one": ["--device", "cuda:0"],
            "two": ["--device", "cuda:0,cuda:0"],
            "split": ["--device", "cuda:0,cuda:0", "--idx", "2"]}
    if torch.cuda.device_count() > 1:
        runs.update(cards=["--device", "cuda:0,cuda:1"],
                    cards_split=["--device", "cuda:0,cuda:1", "--idx", "2"])
    else:
        log("several cards: not run (one card visible); the peer reads of "
            "a table split over cards and the dp scaling across cards are "
            "not held here")
    chunk_n = engine.PERSIST_N
    want_launches = {
        "one": dict.fromkeys(ALN_KERNELS, -(-N_READS // chunk_n)),
        "two": dict.fromkeys(ALN_KERNELS, 2 * -(-N_READS // (2 * chunk_n))),
        "split": {"width_pass_sharded": -(-N_READS // chunk_n),
                  "search_chunk_sharded": -(-N_READS // chunk_n)},
        "cards": dict.fromkeys(ALN_KERNELS,
                               2 * -(-N_READS // (2 * chunk_n))),
        "cards_split": {"width_pass_sharded": -(-N_READS // chunk_n),
                        "search_chunk_sharded": -(-N_READS // chunk_n)}}
    native = (WORK / "native.sai").read_bytes()
    res = {name: [] for name in runs}
    got_launches = {}
    for r in range(ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            out = WORK / f"mesh_{name}.sai"
            os.environ["IBWA_HOST_FRAC"] = "0"
            kernels.reset_launches()
            try:
                res[name].append(run_aln([str(fa), str(fq), *runs[name]],
                                         out))
            finally:
                os.environ.pop("IBWA_HOST_FRAC", None)
            got = dict(kernels.launches)
            if got != want_launches[name]:
                raise AssertionError(f"aln {runs[name]} launched {got}, not "
                                     f"{want_launches[name]}")
            got_launches[name] = got
            if out.read_bytes() != native:
                raise AssertionError(f"round {r}: aln {runs[name]} .sai "
                                     f"differs from --engine native")
    for name, rr in res.items():
        log(f"aln {' '.join(runs[name])} device-only, {ROUNDS} rounds in "
            f"turns: reads/s of search wall "
            f"{spread([x['reads'] / x['search_s'] for x in rr])}; .sai "
            f"byte-equal to --engine native every round; launches "
            f"{got_launches[name]}; steps {rr[0]['iterations']}, fallback "
            f"{rr[0]['fallback_reads']}")
    return got_launches["split"]


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
    "extend_dp": ("ibwa_tpu_torch/csrc/extend_dp.cu",
                  "ibwa_tpu/ops/dp.py:46"),
    # B8: the sharded branch of _gather_block, read where the rows lie
    "width_pass_sharded": ("ibwa_tpu_torch/csrc/width_pass.cu",
                           "ibwa_tpu/fm/device.py:286"),
    "search_chunk_sharded": ("ibwa_tpu_torch/csrc/search_chunk.cu",
                             "ibwa_tpu/fm/device.py:286"),
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


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--large-table", type=float, metavar="GBP",
                    help="run phase 4h alone at GBP Gbp (after the build, "
                         "the smoke's inputs and the probe's one-warp step "
                         "on tables b and c)")
    ap.add_argument("--input-routes", action="store_true",
                    help="run phase 4k alone (after the build)")
    ap.add_argument("--tall-table", action="store_true",
                    help="run phase 4l alone (after the build, the smoke's "
                         "inputs and the probe's one-warp step on tables b "
                         "and c)")
    args = ap.parse_args(argv)
    large = args.large_table
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
    global CARD, INT_OPS_PER_S, WARP_ISSUE_PER_S
    CARD = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    INT_OPS_PER_S, WARP_ISSUE_PER_S = int_ops_per_s(dev)

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
    entry, ptxas = "", {}
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"\d+([a-z_]+_kernel)(?:I(\w+?)EEv)?", line)
            entry = f"{found.group(1)}<{found.group(2) or ''}>" if found \
                else line.split("'")[1][-40:]
        elif "registers" in line or "spill" in line:
            what = line.split(' : ')[-1].strip()
            ptxas.setdefault(entry, []).append(what)
            log(f"  ptxas {entry}: {what}")

    if args.input_routes:       # 4k alone
        t4 = time.perf_counter()
        launches = run_input_phase()
        log(f"launches of 4k (the input routes' commands): {launches}; 4k "
            f"{time.perf_counter() - t4:.0f} s; all "
            f"{time.perf_counter() - t_start:.0f} s")
        print(smi)
        print(json.dumps({"input_routes": launches}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernel vs plain version (K2 and K5 need the aln path's index)
    fa, fq = make_inputs()
    if args.tall_table:         # 4l alone
        rows = {name: {} for name in ("width_pass", "search_chunk",
                                      "lf_walk")}
        t4 = time.perf_counter()
        launches = run_tall_phase(probe_warp_us(dev), rows, fa, fq, dev,
                                  sass_step_loop(info["path"], int(
                                      os.environ.get("IBWA_DEV_INTV",
                                                     "64")) >> 4))
        log(f"launches of 4l (the lifted tables' aln commands): "
            f"{launches}; 4l {time.perf_counter() - t4:.0f} s; all "
            f"{time.perf_counter() - t_start:.0f} s")
        print(smi)
        print(json.dumps({"tall_table": {
            name: r["tall_table"] for name, r in rows.items()}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if large is not None:       # 4h alone
        rows = {name: {} for name in ("width_pass", "search_chunk",
                                      "lf_walk")}
        launches = run_large_phase(large, probe_warp_us(dev), rows, fa, fq,
                                   dev, sass_step_loop(
                                       info["path"], int(os.environ.get(
                                           "IBWA_DEV_INTV", "64")) >> 4),
                                   rounds=1)
        log(f"launches of 4h (the large table's commands): {launches}; "
            f"all {time.perf_counter() - t_start:.0f} s")
        print(smi)
        print(json.dumps({"large_table": {
            name: r["large_table"] for name, r in rows.items()}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
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
    sass = sass_step_loop(info["path"], fm.wpb)
    rows["search_step"] = check_search_step(fm, chunk, sass)
    stamp("search_step check")
    rows["lane_switch"], switch_cases = check_lane_switch(fm, chunk)
    stamp("lane_switch check")
    rows["search_chunk"] = check_search_chunk(fm, chunk, switch_cases, sass)
    rows["search_chunk"]["ptxas"] = {e: v for e, v in ptxas.items()
                                     if e.startswith("search_chunk")}
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
    k5 = rows["lf_walk"]
    fp = k5.pop("_random_fp")
    rb = walk_bound(k5.pop("_random_n_iv"), k5["random_rows"], fp,
                    fm.wpb, warp_us["b"])
    longest = fp["longest"]
    k5.update(random_bound_ms=rb["bound_ms"], random_bound_by=rb["bound_by"],
              random_latency_bound_ms=rb["latency_bound_ms"])
    log(f"K5 random rows: bounds {rb['bytes_bound_ms']:.5f} ms by bytes, "
        f"{rb['ops_bound_ms']:.5f} by operations, "
        f"{rb['latency_bound_ms']:.5f} by latency ({longest} x "
        f"{warp_us['b']:.3f} us); new {k5['random_ms']:.5f} in 1 launch, "
        f"first version {k5['random_first_version_ms']:.5f}")
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
    # a chunk launch is as long as its longest read: every read has a lane
    read = rows["search_chunk"].pop("_longest")
    k8 = rows["search_chunk"]
    k8["latency_bound_ms"] = read * warp_us["b"] / 1e3
    log(f"search_chunk latency bound: the longest read's {read} iterations "
        f"x 1 to {engine.E_UNROLL} dependent fetches "
        f"{k8['latency_bound_ms']:.5f} to "
        f"{engine.E_UNROLL * k8['latency_bound_ms']:.5f} ms, "
        f"{k8['latency_bound_ms'] / k8['ms']:.4f} to "
        f"{engine.E_UNROLL * k8['latency_bound_ms'] / k8['ms']:.4f} of its "
        f"{k8['ms']:.5f} ms; issue {k8['issue_ms']:.5f} ms, "
        f"{k8['issue_ms'] / k8['ms']:.4f} of it")

    # ---- 4b. the walker on random rows (its launches on its path are
    # sampe's, 4d)
    run_walker(fms, dev)
    stamp("probe and walker")

    # ---- 4c. aln
    aln_launches, hybrid_launches = run_aln_paths(
        fa, fq, (chunk["card_cfg"].acap, chunk["card_cfg"].iter_cap))
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

    # ---- 4f. several devices: B8's sharded instantiations against the
    # flat ones, then aln over two entries and over a split table
    rows.update(check_sharded(fm, chunk, dev, rows, ptxas))
    stamp("B8 checks")
    launches.update(run_mesh_aln(fa, fq))
    stamp("aln over several entries")

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
    stamp("sampe and samse")

    # ---- 4e. bwasw: K9 on its own and the long reads' seed extensions
    rows["extend_dp"] = run_bwasw_phase(fa, dev)
    launches["extend_dp"] = rows["extend_dp"].pop("launches")
    rows["extend_dp"]["ptxas"] = {e: v for e, v in ptxas.items()
                                  if e.startswith("extend_dp")}
    stamp("bwasw")
    for name in WITHIN:
        launches[name] = launches.get(host_kernel(name), 0)
    for name in rows:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on its "
                                 f"path ({launches})")
    log(f"launches on the paths: {launches}; phases 1-4f "
        f"{time.perf_counter() - t_start:.0f} s")

    # ---- 4g. the scale configurations, counted on a line of their own
    t4 = time.perf_counter()
    scale_launches = run_scale_phase(warp_us["b"], rows)
    log(f"launches of 4g (the scale configurations' commands): "
        f"{scale_launches}; 4g {time.perf_counter() - t4:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4h. a large table, counted on a line of their own
    t4 = time.perf_counter()
    large_launches = run_large_phase(LARGE_GBP, warp_us, rows, fa, fq, dev,
                                     sass, rounds=1)
    log(f"launches of 4h (the large table's commands): {large_launches}; "
        f"4h {time.perf_counter() - t4:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4i. the port's bench, counted on a line of its own
    t4 = time.perf_counter()
    bench_launches = run_bench_phase()
    log(f"launches of 4i (the bench's commands): {bench_launches}; 4i "
        f"{time.perf_counter() - t4:.0f} s")

    # ---- 4j. aln as two processes on the card, counted on a line of its own
    t4 = time.perf_counter()
    dist_launches = run_dist_phase()
    log(f"launches of 4j (the dist_aln workers'): {dist_launches}; 4j "
        f"{time.perf_counter() - t4:.0f} s")

    # ---- 4k. the input routes, counted on a line of their own
    t4 = time.perf_counter()
    input_launches = run_input_phase()
    log(f"launches of 4k (the input routes' commands): {input_launches}; "
        f"4k {time.perf_counter() - t4:.0f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4l. the lifted tables, counted on a line of their own
    t4 = time.perf_counter()
    tall_launches = run_tall_phase(warp_us, rows, fa, fq, dev, sass)
    log(f"launches of 4l (the lifted tables' aln commands): "
        f"{tall_launches}; 4l {time.perf_counter() - t4:.0f} s; all phases "
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
