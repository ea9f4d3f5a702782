"""The `aln` loop: single-end reads in FASTQ shards, one `aln` process a
shard.

Set-up writes the run's shards (drawn from the seed by `sim.sim_single`)
and a warm-up shard (drawn from the traffic's own `warmup_seed`), and
runs `aln` once over the warm-up shard's first `warmup_reads`, so that the
program's libraries are built (in the first run of a checkout) and its
kernels have run at the cell's shapes.  A shard is one process of
`aln <aln_args> -f <out> <prefix> <shard>`, as a pipeline's scatter step
runs `aln` over one lane's shard; its stderr is kept for the metrics
(`[aln] stats`).  Window shard i reads written shard i mod n and writes a
.sai of its own (`window<i>.sai`).

The check: every shard that ended in the window has the .sai header of
the configuration's options and one record for each read of its input;
a sample of the window's records, drawn from the seed, is byte-equal to
the plain reference's for the read it belongs to (`refaln` over
`refindex`), computed after the window.
"""

from __future__ import annotations

import json
import multiprocessing
import os

import numpy as np

from benchmark import refcheck, refaln, sim

STATS = "[aln] stats "


def _db(ctx):
    return ctx.cfg["dbs"][0]["name"]


def make_inputs(ctx) -> None:
    """The run's shards, shard s drawn from the rng seeded [seed, s], and
    the warm-up shard, written on the host's cores (a process a shard at a
    time; they have ended before the window opens)."""
    t = ctx.traffic
    genome = str(ctx.cache / f"{_db(ctx)}.bases.npy")
    jobs = [(genome, [ctx.seed, s], t["shard_reads"], t, ctx.tmp /
             f"shard{s}.fq", b"r%d_" % s) for s in range(t["shards"])]
    jobs.append((genome, [t["warmup_seed"]], t["warmup_reads"], t,
                 ctx.tmp / "warmup.fq", b"w"))
    pool = multiprocessing.get_context("spawn").Pool(
        min(len(jobs), os.cpu_count() or 1))
    with pool:
        made = pool.map(sim.write_shard, jobs, chunksize=1)
    ctx.inputs["shards"] = [{"units": len(reads), "fq": job[4],
                             "reads": reads}
                            for job, reads in zip(jobs[:-1], made)]


def _sai(ctx, index: int):
    """The .sai of window shard `index`."""
    return ctx.tmp / f"window{index}.sai"


def _aln(ctx, fq, sai) -> list[str]:
    return ["aln", *ctx.cfg["aln_args"], *ctx.cli_extra, "-f", str(sai),
            str(ctx.cache / f"{_db(ctx)}.fa"), str(fq)]


def stats_of(err: str) -> dict:
    for line in reversed(err.splitlines()):
        if line.startswith(STATS):
            return json.loads(line[len(STATS):])
    return {}


def warmup_commands(ctx) -> list[tuple[str, list[str]]]:
    return [("warmup", _aln(ctx, ctx.tmp / "warmup.fq",
                            ctx.tmp / "warmup.sai"))]


def shard_commands(ctx, unit, index: int) -> list[tuple[str, list[str]]]:
    return [(f"aln{index}", _aln(ctx, unit["fq"], _sai(ctx, index)))]


def shard_result(ctx, unit, runs: list[dict]) -> dict:
    return {"stats": stats_of(runs[0]["err"]) if runs else {}}


def check(ctx, view) -> list[tuple[str, int, int]]:
    """[(name, value, limit)]: shards with a wrong header, reads with no
    record (or records past the reads), sampled reads whose record is not
    the reference's."""
    t = ctx.traffic
    opt = refaln.opt_from_args(ctx.cfg["aln_args"])
    header = opt.pack()
    bad_header = missing = 0
    records, reads = [], []
    for s in view.done:
        unit = ctx.inputs["shards"][s["input"]]
        sai = _sai(ctx, s["index"])
        data = sai.read_bytes() if sai.exists() else b""
        head, recs, left = refaln.split_records(data)
        bad_header += head != header
        missing += abs(len(recs) - unit["units"]) + (left > 0)
        recs += [b""] * (unit["units"] - len(recs))
        records += recs[:unit["units"]]
        reads.append(unit["reads"])
    if not records:
        return [("shards_not_done", 1, 0)]
    rng = np.random.default_rng([ctx.seed, 0x5EED])
    pick = np.sort(rng.choice(len(records), min(t["check_reads"],
                                                len(records)),
                              replace=False))
    all_reads = np.concatenate(reads)
    want = refcheck.reference_records(
        ctx.cache / f"ref_{_db(ctx)}", [all_reads[i] for i in pick],
        ctx.cfg["aln_args"], t["read_len"], workers=ctx.ref_workers)
    wrong = sum(records[i] != w for i, w in zip(pick, want))
    return [("sai_header_wrong", bad_header, 0),
            ("sai_reads_missing", missing, 0),
            ("sampled_reads_wrong", wrong, 0)]
