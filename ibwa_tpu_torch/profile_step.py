"""Per-stage and per-lane-count profile of K8, aln's chunk search kernel
(`csrc/search_chunk.cu`): the port's counterpart of scripts/profile_step.py.

  --mode stages  one launch of K8's profiling instantiation (mode 2:
                 clock64 marks between the stages of the step, summed a
                 lane) on a chunk: each stage's clocks an iteration and its
                 share of the step, beside mode 1's device ms on the chunk.
  --mode lanes   K8's device ms on the chunk at several resident lane
                 counts (the grid capped at lanes / 4 blocks; the launch's
                 own grid last), fresh width planes for every launch, CUDA
                 events around the launches alone.
  --first        either mode on K8's first version
                 (csrc/search_chunk_first.cu: static lanes, --lanes of them
                 for `lanes`, DEV_BATCH for `stages`), the profile from
                 before the redesign.

The chunk is the first --reads reads (default 2,048, one chunk of aln) of
--fq against the indexed --fa, or, when neither is given, of reads
simulated as chip_smoke.py's (100 bp, 1% substitutions, half reverse
complemented) from a genome of `simulate.make_genome` (--mbp, default 32),
both from --seed, indexed by the port in --work.  Not ported from
scripts/profile_step.py: `budget` (its stubbed components,
EngineConfig.profile_skips) and `hlo` (xprof), which are the TPU's.

On a card only (K8 is a CUDA kernel):
    python -m ibwa_tpu_torch.profile_step --mode stages --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import random
import sys
import time

import torch

from . import kernels
from .align import engine

SEED = 20261016
READ_LEN = 100


def stage_table(prof: torch.Tensor, iters: int, clock_mhz: float) -> dict:
    """The stages' clocks of a mode-2 launch (int64[lanes, N_STAGES]) as a
    table: per stage the clocks summed over the lanes, the clocks an
    iteration, its share of the step, and the us an iteration at
    `clock_mhz` (0: left out)."""
    total = prof.sum(dim=0).tolist()
    step = sum(total)
    out = {}
    for name, clocks in zip(engine.STAGES, total):
        row = {"clocks": int(clocks), "per_iteration": clocks / max(iters, 1),
               "share": clocks / step if step else 0.0}
        if clock_mhz:
            row["us_per_iteration"] = row["per_iteration"] / clock_mhz
        out[name] = row
    return out


def profile_stages(cfg, fm, args, stream: int, clock_mhz: float = 0.0,
                   first: bool = False, n_lanes: int = engine.DEV_BATCH
                   ) -> dict:
    """One mode-2 launch of K8 on the chunk `args` (pack_chunk's read
    arguments), or of its first version over `n_lanes` static lanes
    (`first`): its stage table, its lanes and their iterations."""
    seqs, lens, md, hs, ssq, bad = args
    big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq) \
        if fm.device.type == "cpu" else \
        engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
    if first:
        *_, counters, prof = engine._launch_search_chunk_first(
            cfg, fm, seqs, big, lens, md, hs, bad, n_lanes, stream, 2)
        _, _, longest, iters, _ = counters.tolist()
    else:
        got = engine._launch_search_chunk(cfg, fm, seqs, big, lens, md, hs,
                                          bad, stream, 2)
        prof, counters = got[6], dict(zip(engine.COUNTERS,
                                          got[5].tolist()))
        longest, iters = counters["longest_lane"], counters["iterations"]
    return {"stages": stage_table(prof, iters, clock_mhz),
            "iterations": iters, "longest_lane": longest,
            "lanes": prof.shape[0]}


def time_lanes(cfg, fm, args, lanes: list[int], reps: int = 5,
               first: bool = False) -> list:
    """K8's device ms on the chunk at each lane count of `lanes` (the grid
    capped at lanes / 4 blocks) and at the launch's own grid, or its first
    version's over each count of static lanes (`first`): CUDA events around
    `reps` launches, each on width planes made before the first event.
    [(lanes, blocks, ms)]."""
    seqs, lens, md, hs, ssq, bad = args
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for n in (lanes if first else [*lanes, 0]):
        blocks = -(-n // 4)
        if first:
            launch = lambda big: engine._launch_search_chunk_first(
                cfg, fm, seqs, big, lens, md, hs, bad, n, stream)
        else:
            blocks = engine.search_chunk_shape(
                cfg, fm, seqs, engine.big_planes(cfg, fm, seqs, lens, hs,
                                                 ssq),
                lens, md, hs, bad, 1, blocks)["blocks"]
            launch = lambda big: engine._launch_search_chunk(
                cfg, fm, seqs, big, lens, md, hs, bad, stream, 1, blocks)
        planes = [engine.big_planes(cfg, fm, seqs, lens, hs, ssq)
                  for _ in range(reps + 1)]
        launch(planes[0])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for big in planes[1:]:
            launch(big)
        end.record()
        torch.cuda.synchronize()
        out.append((4 * blocks, blocks, start.elapsed_time(end) / reps))
    return out


def make_inputs(work: pathlib.Path, mbp: float, n_reads: int,
                seed: int) -> tuple[pathlib.Path, pathlib.Path]:
    """A genome of `simulate.make_genome` and reads from it, both from
    `seed`, the genome indexed by the port; cached in `work`."""
    from . import cli, simulate
    work.mkdir(parents=True, exist_ok=True)
    fa = work / f"genome_{seed}_{mbp}.fa"
    fq = work / f"reads_{seed}_{n_reads}.fq"
    if pathlib.Path(str(fa) + ".bwt").exists() and fq.exists():
        return fa, fq
    rng = random.Random(seed)
    seq = simulate.make_genome(rng, int(mbp * 1e6))
    with open(fa, "w") as f:
        f.write(">profile_chr\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(fq, "w") as f:
        for i in range(n_reads):
            pos = rng.randrange(0, len(seq) - READ_LEN)
            s = list(seq[pos:pos + READ_LEN])
            for j in range(len(s)):
                if rng.random() < 0.01:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.5:
                s = [comp[ch] for ch in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * READ_LEN}\n")
    if cli.main(["index", str(fa)]) != 0:
        raise RuntimeError(f"index of {fa} failed")
    return fa, fq


def load_chunk(fa, fq, n_reads: int, device, acap: int = 0):
    """(config, index pair on `device`, pack_chunk's read arguments) of the
    first `n_reads` reads of `fq` against `fa`, at ACAP `acap` (0: the
    engine's choice)."""
    from .align import pipeline
    from .align.opts import GapOpt
    from .fm.device import build_device_pair
    from .fm.fmindex import FmIndex
    from .index.builder import load_index
    opt = GapOpt()
    fms = (FmIndex(load_index(str(fa), 0)), FmIndex(load_index(str(fa), 1)))
    reads = pipeline._load(str(fq), opt)[:n_reads]
    seqs, rseqs = [r.seq for r in reads], [r.rseq for r in reads]
    cfg, lens, md = engine.batch_config(seqs, opt, fms[0].seq_len)
    if acap:
        cfg = dataclasses.replace(cfg, acap=acap)
    fm = build_device_pair(fms[0], fms[1], device)
    return cfg, fm, engine.pack_chunk(cfg, seqs, rseqs, lens, md,
                                      opt.seed_len, device)


def sm_clock_mhz() -> float:
    """The card's SM clock now (`nvidia-smi --query-gpu=clocks.sm`)."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout.split()
    return float(out[0])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("stages", "lanes"), default="stages")
    ap.add_argument("--fa", help="indexed FASTA (with --fq)")
    ap.add_argument("--fq", help="FASTQ whose first --reads reads are the "
                                 "chunk")
    ap.add_argument("--reads", type=int, default=engine.PERSIST_N)
    ap.add_argument("--mbp", type=float, default=32.0,
                    help="simulated genome size without --fa")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--work", default=".bench/profile_step_torch")
    ap.add_argument("--acap", type=int, default=0,
                    help="arena slots (0: the engine's choice)")
    ap.add_argument("--lanes", type=int, nargs="*",
                    default=[132, 264, 528, 1056, 2112],
                    help="resident lane counts for --mode lanes")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--first", action="store_true",
                    help="profile K8's first version")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        print("profile_step: K8 runs on a CUDA card only", file=sys.stderr)
        return 2
    if (a.fa is None) != (a.fq is None):
        ap.error("--fa and --fq go together")
    t0 = time.perf_counter()
    fa, fq = (a.fa, a.fq) if a.fa else make_inputs(
        pathlib.Path(a.work), a.mbp, a.reads, a.seed)
    cfg, fm, args = load_chunk(fa, fq, a.reads, device, a.acap)
    kernels.lib()
    out = {"device": torch.cuda.get_device_name(device), "mode": a.mode,
           "kernel": "first version" if a.first else "redesign",
           "reads": int(args[1].shape[0]), "acap": cfg.acap}
    if a.mode == "stages":
        out.update(profile_stages(cfg, fm, args,
                                  torch.cuda.current_stream().cuda_stream,
                                  sm_clock_mhz(), a.first))
        out["ms_mode1"] = time_lanes(
            cfg, fm, args, [engine.DEV_BATCH] if a.first else [], a.reps,
            a.first)[-1][2]
    else:
        out["lanes"] = [{"lanes": n, "blocks": b, "ms": ms}
                        for n, b, ms in time_lanes(cfg, fm, args, a.lanes,
                                                   a.reps, a.first)]
    out["seconds"] = time.perf_counter() - t0
    if a.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
