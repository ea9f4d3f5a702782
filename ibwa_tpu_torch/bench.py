"""The port's benchmark: `aln` reads/s on the card against the host search,
and the `sampe -R`, `samse` and `bwasw` stage rates, in one JSON line: the
counterpart of `bench.py`.

    python -m ibwa_tpu_torch.bench [--device cuda] [--rounds 5]
        [--scale full|tiny] [--work DIR]

Inputs are `bench.py`'s recipe, byte for byte (`random.Random(20260816)`:
a 32 Mbp genome of `simulate.make_genome`, `>bench_chr` in lines of 70, then
16,384 reads of 100 bp at 1% substitutions, half reverse-complemented;
50,000 pairs from `Random(20260817)`; 1,500 long reads of 400-999 bp from
`Random(20260818)`), cached under `--work` (default
.bench/bench_torch/<scale>/) and indexed by the port's `index`.  `--scale
tiny` cuts the counts, never the recipe.  FASTQ records are counted
structurally (four lines a record).

`aln`: `TorchAlnEngine.align_batch` on the reads loaded once, each device
engine warmed twice, then `--rounds` rounds of three routes in turns (the
order reversed every other round): `hybrid` (the adaptive host share: the
headline), `device_only` (an engine of its own with `host_frac = 0`) and
`native` (`native_align_batch` on one host thread, the baseline: the
reference binary's `aln -t 1` is not part of this repository, and the
native search's `.sai` is the reference's by the parity suite).  The
native search runs on one host thread in every route, the hybrid's host
share and the overflow fallback too, as a default `aln` (`-t 1`) does:
`native.set_threads(1)` before the first call, whatever loaded the library
first, the count read back into the record (`host_threads`) and the
setting before restored at the end.  A rate is reads / the wall of one
call.  In every round both device routes' hits
encode to `.sai` bytes equal to native's.  Then one more device-only round
under the profiler: its counters, the device ms and launches of
`width_pass` and `search_chunk` (one each a chunk) and the busy share (their
device ms / the round's wall).  An empty profiler session is made again
after a pause, up to four in all; then CUDA events around the call stand in
for the device ms, and the record says so.

The stages, every command through the port's CLI with the host route as
the baseline, the same rounds in turns: `sampe -R` on the pairs (the `.sai`
of both ends from `aln`, byte-equal to `--engine native`'s), K5's walks
against the host walks, SAM byte-equal every round, 0 values refused and 0
host walks after each prefill, records mapped; `samse` on end 1 (one route:
nothing of it runs on a device); `bwasw` on the long reads, K9's extensions
(`--engine torch`) against the host's (`--engine native`), SAM byte-equal
every round, with the extension job counts and the stage split.

stderr carries a log line a measurement, each naming the card as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives it;
`<work>/bench_extra.json` holds every number; stdout's last line is
`bench.py`'s record plus `baseline`, `device`, `rounds` and
`host_threads`.  Any
inequality raises and no record is printed.  With no CUDA device it exits
2 unless `--device cpu` is given (the kernels' plain versions; `device` is
then "cpu" and no device time is measured).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import io
import json
import os
import pathlib
import random
import re
import subprocess
import sys
import time

from . import parity_scale
from .kernels import launched

REPO = pathlib.Path(__file__).resolve().parent.parent
WORK = REPO / ".bench" / "bench_torch"
READ_LEN = 100
ROUNDS = 5
HOST_THREADS = 1    # of the native search in every route: the CLI's -t
ALN_ROUTES = ("hybrid", "device_only", "native")
ALN_KERNELS = ("width_pass", "search_chunk")
TRACE_TRIES, TRACE_PAUSE_S = 4, 0.25   # profiler sessions, and the pause
                                       # before each one after the first
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}

BWASW_EXT = re.compile(
    r"\[bsw2_aln\] extensions: (\d+) jobs in (\d+) batches on (\S+) \((\d+) "
    r"launches\), (\d+) on the host \(gate (\d+), under the minimum (\d+), "
    r"empty (\d+)\); (\d+) jobs in all")
BWASW_NATIVE = re.compile(r"\[bsw2_aln\] extensions: (\d+) jobs, all on the "
                          r"host \(engine native; empty (\d+)\)")
BWASW_STAGES = re.compile(
    r"\[bsw2_aln\] stages: core ([\d.]+) s, extensions ([\d.]+) s \(device "
    r"route ([\d.]+) s, host loop ([\d.]+) s\), cigar ([\d.]+) s, all "
    r"([\d.]+) s")


@dataclasses.dataclass(frozen=True)
class Scale:
    """The counts of one scale (bench.py's GENOME_LEN, N_READS, N_PAIRS,
    N_LONG)."""

    genome_len: int
    reads: int
    pairs: int
    long_reads: int


SCALES = {"full": Scale(32_000_000, 16_384, 50_000, 1_500),
          "tiny": Scale(200_000, 64, 128, 16)}


@dataclasses.dataclass(frozen=True)
class Inputs:
    fa: pathlib.Path
    reads: pathlib.Path
    pairs: tuple[pathlib.Path, pathlib.Path]
    long_reads: pathlib.Path


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---- inputs: bench.py's recipe ----------------------------------------------

def inputs_of(work: pathlib.Path) -> Inputs:
    return Inputs(work / "genome.fa", work / "reads.fq",
                  (work / "pairs_1.fq", work / "pairs_2.fq"),
                  work / "long.fq")


def write_inputs(inp: Inputs, sc: Scale) -> None:
    """bench.py::ensure_inputs' files at sc's counts: the same generators,
    draws and text, so the bytes are equal."""
    from . import simulate
    rng = random.Random(20260816)
    seq = simulate.make_genome(rng, sc.genome_len)
    with open(inp.fa, "w") as f:
        f.write(">bench_chr\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    with open(inp.reads, "w") as f:
        for i in range(sc.reads):
            pos = rng.randrange(0, sc.genome_len - READ_LEN)
            s = list(seq[pos:pos + READ_LEN])
            for j in range(len(s)):
                if rng.random() < 0.01:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.5:
                s = [COMP[c] for c in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * READ_LEN}\n")
    prng = random.Random(20260817)
    with open(inp.pairs[0], "w") as f1, open(inp.pairs[1], "w") as f2:
        for i in range(sc.pairs):
            isz = max(2 * READ_LEN + 10, int(prng.gauss(320, 40)))
            pos = prng.randrange(0, sc.genome_len - isz)
            frag = seq[pos:pos + isz]
            a = list(frag[:READ_LEN])
            b = [COMP[c] for c in reversed(frag[-READ_LEN:])]
            for arr in (a, b):
                for j in range(len(arr)):
                    if prng.random() < 0.01:
                        arr[j] = prng.choice("ACGT")
            f1.write(f"@p{i}\n{''.join(a)}\n+\n{'I' * READ_LEN}\n")
            f2.write(f"@p{i}\n{''.join(b)}\n+\n{'I' * READ_LEN}\n")
    lrng = random.Random(20260818)
    with open(inp.long_reads, "w") as f:
        for i in range(sc.long_reads):
            ln = lrng.randrange(400, 1000)
            pos = lrng.randrange(0, sc.genome_len - ln)
            s = list(seq[pos:pos + ln])
            for j in range(len(s)):
                if lrng.random() < 0.02:
                    s[j] = lrng.choice("ACGT")
            if lrng.random() < 0.5:
                s = [COMP[c] for c in reversed(s)]
            f.write(f"@L{i}\n{''.join(s)}\n+\n{'I' * len(s)}\n")


def ensure_inputs(work: pathlib.Path, sc: Scale, say=log) -> Inputs:
    """The inputs under `work`, made and indexed once (cached), each FASTQ
    holding the scale's count of records."""
    inp = inputs_of(work)

    def make():
        write_inputs(inp, sc)
        parity_scale.index(inp.fa)

    work.mkdir(parents=True, exist_ok=True)
    parity_scale.cached(work / "inputs.done", make, say)
    for fq, n in ((inp.reads, sc.reads), (inp.pairs[0], sc.pairs),
                  (inp.pairs[1], sc.pairs), (inp.long_reads, sc.long_reads)):
        got = len(parity_scale.fastq_records(fq))
        if got != n:
            raise AssertionError(f"{fq}: {got} records, not {n}")
    return inp


# ---- aln ---------------------------------------------------------------------

def sai_bytes(opt, hits) -> bytes:
    """The .sai of a batch's hit lists, header first, as pipeline.py writes
    it."""
    from .io import sai
    buf = io.BytesIO()
    sai.write_header(buf, opt)
    for h in hits:
        sai.write_read_hits(buf, h)
    return buf.getvalue()


def check_aln_launches(got: dict, eng, device: str) -> int:
    """One width pass and one chunk search a chunk of the batch's device
    share on a card, nothing on the CPU; returns the chunks."""
    from .align import engine
    b = eng.stats["batches"][-1]
    chunks = -(-(b["reads"] - b["host_reads"]) // engine.PERSIST_N)
    want = (dict.fromkeys(ALN_KERNELS, chunks)
            if device.startswith("cuda") else {})
    if got != want:
        raise AssertionError(f"align_batch launched {got}, not {want}")
    return chunks if want else 0


COUNTERS = ("device_reads", "fallback_reads", "host_reads", "iterations")


def counters(eng) -> dict:
    st = eng.stats
    return {**{k: st[k] for k in COUNTERS},
            "fallback_by_cause": dict(st["fallback_by_cause"])}


def counter_delta(after: dict, before: dict) -> dict:
    out = {k: after[k] - before[k] for k in COUNTERS}
    out["fallback_by_cause"] = {
        k: v - before["fallback_by_cause"][k]
        for k, v in after["fallback_by_cause"].items()}
    return out


def kernel_ms(prof, launches: dict) -> dict:
    """{kernel: device ms over the session} for the aln kernels, each its
    mean time a launch seen x its launches counted (a trace can miss a few
    of its first records); {} if the trace missed a kernel that ran."""
    import torch
    seen = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.count <= 0:
            continue
        for name in ALN_KERNELS:
            if f"{name}_kernel" in e.key:
                us, n = seen.get(name, (0.0, 0))
                seen[name] = (us + e.self_device_time_total, n + e.count)
    if any(launches.get(k) and k not in seen for k in ALN_KERNELS):
        return {}
    return {k: us / n * launches[k] / 1e3 for k, (us, n) in seen.items()}


def device_round(eng, call, device: str, say) -> dict:
    """One device-only round, call() -> (hits, wall, launches): its
    counters, the aln kernels' device ms and launches, and their busy
    share of the round's wall.  On a card under the profiler (a session
    that saw nothing made again after a pause, up to TRACE_TRIES; then
    CUDA events around the call); on the CPU no device time is
    measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = device.startswith("cuda")
    for attempt in range(1, TRACE_TRIES + 2 if on_card else 2):
        if attempt > 1:
            time.sleep(TRACE_PAUSE_S)
        before = counters(eng)
        if not on_card:
            hits, wall, got = call()
            ms, source = None, None
        elif attempt <= TRACE_TRIES:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                hits, wall, got = call()
                torch.cuda.synchronize()
            ms, source = kernel_ms(prof, got), "profiler"
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hits, wall, got = call()
            end.record()
            torch.cuda.synchronize()
            ms = {"span": start.elapsed_time(end)}
            source = "cuda_events_span"
        if ms or not on_card:
            break
        say(f"the profiler saw no aln kernel in session {attempt} of "
            f"{TRACE_TRIES}")
    return {"hits": hits, "wall_s": wall, "launches": got,
            **counter_delta(counters(eng), before),
            "host_frac": eng.stats["host_frac"],
            "device_ms": ms, "device_ms_source": source,
            "busy_share": sum(ms.values()) / 1e3 / wall if ms else None,
            "profiler_sessions": min(attempt, TRACE_TRIES) if on_card else 0}


def aln_rates(inp: Inputs, device: str, rounds: int, say) -> dict:
    """The three routes' reads/s in rounds in turns, every device route's
    .sai equal to native's in every round; one device-only round's
    counters and device time."""
    from .align import engine
    from .align.opts import GapOpt
    from .fm.fmindex import FmIndex
    from .index.builder import load_index
    from .io.reads import load_reads
    opt = GapOpt()
    fa = str(inp.fa)
    fms = (FmIndex(load_index(fa, 0)), FmIndex(load_index(fa, 1)))
    reads = load_reads(str(inp.reads))
    seqs = [r.seq for r in reads]
    rseqs = [r.rseq for r in reads]
    n = len(reads)
    if n != len(parity_scale.fastq_records(inp.reads)):
        raise AssertionError(f"loaded {n} reads of {inp.reads}")
    engines = {"hybrid": engine.TorchAlnEngine(fms, device),
               "device_only": engine.TorchAlnEngine(fms, device)}
    engines["device_only"].host_frac = 0.0
    launches = collections.Counter()
    n_chunks = 0

    def run(route):
        """One call of `route`: (hits, wall s, launches), its launches
        checked and counted."""
        nonlocal n_chunks
        t0 = time.perf_counter()
        if route == "native":
            hits, got = launched(lambda: engine.native_align_batch(
                fms, seqs, rseqs, opt))
            if got:
                raise AssertionError(f"native aln launched {got}")
        else:
            hits, got = launched(lambda: engines[route].align_batch(
                seqs, rseqs, opt))
            n_chunks += check_aln_launches(got, engines[route], device)
            launches.update(got)
        return hits, time.perf_counter() - t0, got

    try:
        t0 = time.perf_counter()
        for route in ("hybrid", "device_only"):
            for _ in range(2):
                run(route)
        say(f"aln warmed (each device engine twice, the kernels built on a "
            f"card) in "
            f"{time.perf_counter() - t0:.1f} s")
        walls = {r: [] for r in ALN_ROUTES}
        shares, want = [], None
        for i in range(rounds):
            got = {}
            for route in ALN_ROUTES if i % 2 == 0 else ALN_ROUTES[::-1]:
                hits, wall, _ = run(route)
                walls[route].append(wall)
                got[route] = sai_bytes(opt, hits)
            want = want or got["native"]
            for route, b in got.items():
                if b != want:
                    raise AssertionError(f"aln round {i}: {route} .sai "
                                         f"differs from native's")
            shares.append(engines["hybrid"].stats["batches"][-1]
                          ["host_share"])
            say(f"aln round {i + 1}/{rounds}: reads/s " + ", ".join(
                f"{r} {n / walls[r][-1]:.1f}" for r in ALN_ROUTES)
                + f"; .sai of both device routes byte-equal to native's; "
                  f"hybrid host share {shares[-1]:.4f}")
        d = device_round(engines["device_only"],
                         lambda: run("device_only"), device, say)
        if sai_bytes(opt, d.pop("hits")) != want:
            raise AssertionError("aln device round: .sai differs from "
                                 "native's")
        host_frac = engines["hybrid"].stats["host_frac"]
    finally:
        for eng in engines.values():
            eng.close()
    rates = {r: {**parity_scale.spread([n / w for w in ws]),
                 "values": [n / w for w in ws]} for r, ws in walls.items()}
    say(f"aln on {n} reads, reads/s of align_batch's wall, {rounds} rounds "
        f"in turns: " + "; ".join(
            f"{r} median {v['median']:.1f} (min {v['min']:.1f}, max "
            f"{v['max']:.1f})" for r, v in rates.items()))
    say(f"aln device-only round: {d['device_reads']} device reads, "
        f"{d['fallback_reads']} overflow fallback (by cause "
        f"{d['fallback_by_cause']}), {d['host_reads']} host reads, "
        f"{d['iterations']} iterations; launches {d['launches']}; device "
        f"ms {d['device_ms']} "
        f"({d['device_ms_source']}), busy share "
        + (f"{d['busy_share']:.4f}" if d["busy_share"] is not None
           else "not measured") + f" of {d['wall_s']:.4f} s")
    return {"reads": n, "rates": rates, "host_frac": host_frac,
            "hybrid_host_share": shares, "device_round": d,
            "launches": dict(launches), "chunks": n_chunks,
            "sai_bytes": len(want)}


# ---- the stages --------------------------------------------------------------

def pair_sai(inp: Inputs, work: pathlib.Path, device: str, say) -> tuple:
    """The .sai of both ends through `aln` (the default hybrid route),
    each byte-equal to `--engine native`'s; (sais, launches)."""
    sais, launches = [], collections.Counter()
    for e, fq in enumerate(inp.pairs, 1):
        res = parity_scale.aln_pair(f"end{e}", inp.fa, fq, work, device,
                                    ("hybrid",))
        launches.update(res["hybrid"]["launches"])
        sais.append(work / f"end{e}.native.sai")
    say(f"aln of both ends of the pairs: .sai byte-equal to --engine "
        f"native's; launches {dict(launches)}")
    return sais, launches


def bwasw(fa, fq, out: pathlib.Path, device: str | None) -> dict:
    """One `bwasw` of fq: K9's extensions on `device`, or the host's with
    None; its wall, stage split, job counts and launches.  The torch route
    must launch extend_dp alone, once a batch its glue took, and every job
    it did not run must be a counted gate, under-minimum or empty one; the
    native route launches nothing."""
    args = (["--engine", "native"] if device is None else
            ["--engine", "torch", "--device", device])
    r = parity_scale.run_cli("bwasw", [*args, str(fa), str(fq)], out)
    err, got = r["err"], r["launches"]
    stages = dict(zip(("core", "ext", "device_route", "host_loop", "cigar",
                       "all"), map(float, BWASW_STAGES.search(err).groups())))
    if device is None:
        m = BWASW_NATIVE.search(err)
        if got or not m:
            raise AssertionError(f"bwasw --engine native launched {got}:\n"
                                 f"{err[-2000:]}")
        jobs = {"total": int(m.group(1)), "empty": int(m.group(2))}
    else:
        m = BWASW_EXT.search(err)
        if not m:
            raise AssertionError(f"bwasw printed no extension line:\n"
                                 f"{err[-2000:]}")
        (dev_jobs, batches, _, n_launch, host, gate, small, empty,
         total) = (int(x) if x.isdigit() else x for x in m.groups())
        want = ({"extend_dp": batches} if device.startswith("cuda")
                else {})
        if (got != want or n_launch != sum(want.values())
                or dev_jobs + host != total
                or host != gate + small + empty):
            raise AssertionError(f"bwasw on {device}: launches {got}, "
                                 f"line {m.group(0)!r}")
        jobs = {"device": dev_jobs, "batches": batches, "host": host,
                "gate": gate, "under_minimum": small, "empty": empty,
                "total": total}
    return {"wall": r["wall"], "stages": stages, "jobs": jobs,
            "launches": got}


def stage_rates(inp: Inputs, sc: Scale, work: pathlib.Path, device: str,
                rounds: int, say) -> dict:
    """`sampe -R` (K5's walks against the host walks), `samse` and `bwasw`
    (K9 against the host extensions), the rounds in turns, every device
    route's output byte-equal to the host route's in every round."""
    t0 = time.perf_counter()
    sais, launches = pair_sai(inp, work, device, say)
    sai_s = time.perf_counter() - t0
    pe_args = [str(inp.fa), *map(str, sais), *map(str, inp.pairs)]
    n_pairs = sc.pairs
    names = parity_scale.fastq_records(inp.pairs[0])
    walls = {k: [] for k in ("sampe_host", "sampe_k5", "samse",
                             "bwasw_native", "bwasw_torch")}
    prefill, bw = [], {}
    seconds = collections.Counter()
    for i in range(rounds):
        # sampe -R, the two routes in turns
        t1 = time.perf_counter()
        order = ("host", "k5") if i % 2 == 0 else ("k5", "host")
        for route in order:
            r = parity_scale.sampe(pe_args, work / f"pairs.{route}.sam",
                                   None if route == "host" else device,
                                   n_pairs)
            walls[f"sampe_{route}"].append(r["wall"])
            if route == "k5":
                prefill.append(r["batches"])
                launches.update(r["launches"])
        parity_scale.same_bytes(f"sampe -R round {i}",
                                work / "pairs.k5.sam", work / "pairs.host.sam")
        recs = parity_scale.sam_records(work / "pairs.host.sam")
        mapped = sum(1 for f in recs if not int(f[1]) & 4)
        if len(recs) != 2 * n_pairs or mapped < n_pairs:
            raise AssertionError(f"sampe -R: {len(recs)} records, {mapped} "
                                 f"mapped, for {n_pairs} pairs")
        seconds["sampe"] += time.perf_counter() - t1
        # samse on end 1: one route
        t1 = time.perf_counter()
        out = work / "end1.samse.sam"
        r = parity_scale.run_cli("samse", [str(inp.fa), str(sais[0]),
                                           str(inp.pairs[0])], out)
        if r["launches"] or [f[0] for f in parity_scale.sam_records(out)] \
                != names:
            raise AssertionError(f"samse launched {r['launches']} or wrote "
                                 f"not one record a read in read order")
        walls["samse"].append(r["wall"])
        seconds["samse"] += time.perf_counter() - t1
        # bwasw, the two routes in turns
        t1 = time.perf_counter()
        order = ("native", "torch") if i % 2 == 0 else ("torch", "native")
        for route in order:
            bw[route] = bwasw(inp.fa, inp.long_reads,
                              work / f"long.{route}.sam",
                              None if route == "native" else device)
            walls[f"bwasw_{route}"].append(bw[route]["wall"])
        launches.update(bw["torch"]["launches"])
        parity_scale.same_bytes(f"bwasw round {i}", work / "long.torch.sam",
                                work / "long.native.sam")
        long_recs = parity_scale.sam_records(work / "long.native.sam")
        if not any(not int(f[1]) & 4 for f in long_recs):
            raise AssertionError("bwasw mapped no long read")
        seconds["bwasw"] += time.perf_counter() - t1
        walker = sum(b["walker_s"] for b in prefill[-1])
        say(f"stages round {i + 1}/{rounds}: sampe -R reads/s K5 "
            f"{2 * n_pairs / walls['sampe_k5'][-1]:.1f} (walker {walker:.4f}"
            f" s), host walks {2 * n_pairs / walls['sampe_host'][-1]:.1f}, "
            f"SAM byte-equal, {mapped} of {len(recs)} records mapped; samse "
            f"{n_pairs / walls['samse'][-1]:.1f}; bwasw K9 "
            f"{sc.long_reads / walls['bwasw_torch'][-1]:.1f}, host "
            f"{sc.long_reads / walls['bwasw_native'][-1]:.1f}, SAM "
            f"byte-equal")

    def rate(key, n):
        vals = [n / w for w in walls[key]]
        return {**parity_scale.spread(vals), "values": vals}

    res = {
        "sampe": {"pairs": n_pairs, "k5": rate("sampe_k5", 2 * n_pairs),
                  "host": rate("sampe_host", 2 * n_pairs),
                  "walker_s": [sum(b["walker_s"] for b in p)
                               for p in prefill],
                  "prefill": prefill[-1], "records": len(recs),
                  "mapped": mapped},
        "samse": {"reads": n_pairs, "rate": rate("samse", n_pairs)},
        "bwasw": {"reads": sc.long_reads,
                  "torch": rate("bwasw_torch", sc.long_reads),
                  "native": rate("bwasw_native", sc.long_reads),
                  "jobs": {r: v["jobs"] for r, v in bw.items()},
                  "stages": {r: v["stages"] for r, v in bw.items()},
                  "records": len(long_recs)},
        "launches": dict(launches),
        "seconds": {"pair_sai": sai_s, **seconds},
    }
    for name, a, b in (("sampe -R", "k5", "host"),
                       ("bwasw", "torch", "native")):
        key = name.split()[0]
        ra, rb = res[key][a], res[key][b]
        say(f"{name} reads/s, {rounds} rounds in turns: {a} median "
            f"{ra['median']:.1f} (min {ra['min']:.1f}, max {ra['max']:.1f}),"
            f" {b} median {rb['median']:.1f} (min {rb['min']:.1f}, max "
            f"{rb['max']:.1f}): {ra['median'] / rb['median']:.3f}x")
    ss = res["samse"]["rate"]
    say(f"samse reads/s, {rounds} rounds: median {ss['median']:.1f} (min "
        f"{ss['min']:.1f}, max {ss['max']:.1f}); bwasw jobs "
        f"{res['bwasw']['jobs']}, stages {res['bwasw']['stages']}")
    return res


# ---- the run -----------------------------------------------------------------

def card_of(device: str) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` line, or "cpu"."""
    if not device.startswith("cuda"):
        return "cpu"
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()
    return smi[torch.device(device).index or 0].strip()


def one_device(device: str) -> str:
    """`device` as one device: "cuda" alone (every visible card to the aln
    engine) becomes the current card."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def run(device: str, scale: str, rounds: int, work: pathlib.Path,
        say=log) -> dict:
    """Every measurement of the module's docstring; raises on the first
    inequality."""
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, not {rounds}")
    from . import native
    sc = SCALES[scale]
    t0 = time.perf_counter()
    inp = ensure_inputs(work, sc, say)
    inputs_s = time.perf_counter() - t0
    before = native.set_threads(HOST_THREADS)
    try:
        threads = native.get_threads()
        say(f"the native search on {threads} host thread(s)")
        t1 = time.perf_counter()
        aln = aln_rates(inp, device, rounds, say)
        aln_s = time.perf_counter() - t1
        stages = stage_rates(inp, sc, work, device, rounds, say)
    finally:
        native.set_threads(before)
    launches = collections.Counter(aln["launches"])
    launches.update(stages.pop("launches"))
    return {"scale": scale, "device": device, "rounds": rounds,
            "host_threads": threads, "aln": aln,
            **stages, "launches": dict(launches),
            "seconds": {"inputs": inputs_s, "aln": aln_s,
                        **stages.pop("seconds"),
                        "all": time.perf_counter() - t0}}


def record(res: dict, card: str) -> dict:
    """bench.py's record, with `baseline`, `device`, `rounds` and
    `host_threads`."""
    med = {r: res["aln"]["rates"][r]["median"] for r in ALN_ROUTES}
    return {"metric": "aln_reads_per_s_per_chip", "value": med["hybrid"],
            "unit": "reads/s", "vs_baseline": med["hybrid"] / med["native"],
            "host_frac": res["aln"]["host_frac"],
            "device_only_vs_ref": med["device_only"] / med["native"],
            "baseline": "native", "device": card, "rounds": res["rounds"],
            "host_threads": res["host_threads"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the device routes (cuda, cuda:N, cpu)")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="rounds of the routes in turns (at least 1)")
    ap.add_argument("--scale", choices=sorted(SCALES), default="full")
    ap.add_argument("--work", default=None,
                    help="directory of the cached inputs and the outputs "
                         "[.bench/bench_torch/<scale>]")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error(f"--rounds must be at least 1, not {args.rounds}")
    if "IBWA_HOST_FRAC" in os.environ:
        log("IBWA_HOST_FRAC is set: the hybrid route would not be the "
            "adaptive share; unset it")
        return 2
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log("no CUDA device: the bench measures the card; pass "
                "--device cpu to run the kernels' plain versions")
            return 2
    device = one_device(args.device)
    card = card_of(device)
    work = pathlib.Path(args.work) if args.work else WORK / args.scale

    def say(msg: str) -> None:
        log(f"{card}: {msg}")

    res = run(device, args.scale, args.rounds, work, say)
    res["card"] = card
    rec = record(res, card)
    (work / "bench_extra.json").write_text(json.dumps(res, indent=1))
    say(f"every route equal in every round; seconds {res['seconds']}; "
        f"extra in {work / 'bench_extra.json'}")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
