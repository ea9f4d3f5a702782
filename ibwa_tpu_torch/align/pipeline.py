"""The `aln` stage: reads + FM-indexes -> .sai stream.

Port of `ibwa_tpu/align/pipeline.py` (bwa_aln_core, bwtaln.c:173-241):
batches of 0x40000 reads, the gap_opt_t header, per-read hit records.
Index loading, read parsing (FASTQ and BAM) and the .sai writer are
the port's own copies of `ibwa_tpu`'s host modules.

Engines:
  * "torch"  — the device search (align/engine.py) on `device` (one
               device, or a comma list: the reads split over them, the
               table split by rows over groups of `n_idx`), with the
               native host search for overflow reads and the hybrid share
  * "native" — the native C++ search for everything
  * "ref"    — the host emulator for everything (slow; testing only)
"""

from __future__ import annotations

import json
import sys
from typing import BinaryIO

from .. import native, spans
from ..fm.fmindex import FmIndex
from ..index.builder import load_index
from ..io import sai
from ..io.reads import load_reads
from . import engine as torch_engine
from . import engine_ref
from .opts import GapOpt

BATCH_SIZE = 0x40000


def _load(fq_path: str, opt: GapOpt):
    if opt.mode & 0x20:  # BWA_MODE_BAM (bwtaln.c:162-168)
        from ..io.bam import load_reads_bam
        which = 0
        if opt.mode & 0x40:
            which |= 4
        if opt.mode & 0x80:
            which |= 1
        if opt.mode & 0x100:
            which |= 2
        if which == 0:
            which = 7
        return load_reads_bam(fq_path, which, trim_qual=opt.trim_qual,
                              is_comp=bool(opt.mode & 0x02))
    return load_reads(fq_path, trim_qual=opt.trim_qual,
                      is_comp=bool(opt.mode & 0x02),
                      is_64=bool(opt.mode & 0x200), l_bc=opt.mode >> 24)


def aln_to_stream(prefix: str, fq_path: str, opt: GapOpt, out: BinaryIO,
                  engine: str = "torch", device: str = "cuda",
                  n_idx: int = 1) -> int:
    """Align every read of `fq_path` against the index at `prefix` and
    write the .sai stream to `out`; returns the read count.  The torch
    engine prints a line a batch (its host share, overflow fallback and
    its split by cause, and arena size); the run ends with an `[aln]
    stats {json}` line on stderr (`host_threads`: the native search's
    threads, on the torch and native engines; `spans`: the call's spans,
    its root `aln`)."""
    rec = spans.Recorder()
    with rec.span("aln"):
        total, summary = run_aln(prefix, fq_path, opt, out, engine, device,
                                 n_idx, rec)
    print_stats(summary, rec)
    return total


def run_aln(prefix: str, fq_path: str, opt: GapOpt, out: BinaryIO,
            engine: str, device: str, n_idx: int, rec: spans.Recorder
            ) -> tuple[int, dict]:
    """`aln_to_stream`'s work inside the caller's root span, its spans
    recorded in `rec`; (read count, the stats line's summary)."""
    if engine not in ("torch", "native", "ref"):
        raise ValueError(f"unknown engine {engine!r}")
    with rec.span("aln.index_load"):
        fms = (FmIndex(load_index(prefix, 0)), FmIndex(load_index(prefix, 1)))
    with rec.span("aln.reads_parse"):
        reads = _load(fq_path, opt)
    eng = (torch_engine.TorchAlnEngine(fms, device, n_idx=n_idx, spans=rec)
           if engine == "torch" else None)
    sai.write_header(out, opt)
    total = 0
    search_s = 0.0
    try:
        for i, start in enumerate(range(0, len(reads), BATCH_SIZE)):
            batch = reads[start:start + BATCH_SIZE]
            seqs = [r.seq for r in batch]
            rseqs = [r.rseq for r in batch]
            with rec.span("aln.search", i) as sp:
                if engine == "ref":
                    results = engine_ref.align_batch(fms, seqs, rseqs, opt)
                elif engine == "native":
                    results = torch_engine.native_align_batch(fms, seqs,
                                                              rseqs, opt)
                else:
                    results = eng.align_batch(seqs, rseqs, opt)
            search_s += sp.seconds
            with rec.span("aln.sai_write", i):
                for hits in results:
                    sai.write_read_hits(out, hits)
            total += len(batch)
            print(f"[aln] {total} sequences processed", file=sys.stderr)
            if eng is not None:
                b = eng.stats["batches"][-1]
                print(f"[aln] batch {len(eng.stats['batches'])}: "
                      f"{b['reads']} reads, host share "
                      f"{b['host_share']:.4f} ({b['host_reads']} reads), "
                      f"overflow fallback {b['fallback_reads']} ("
                      + ", ".join(f"{k} {v}" for k, v in
                                  b["fallback_by_cause"].items())
                      + f"), ACAP {b['acap']}", file=sys.stderr)
        # one machine-readable summary line: search wall time (index and
        # read loading excluded; the `aln.search` spans' total), the native
        # search's host threads (the torch engine's host share and fallback
        # run there too) and the device engine's counters
        summary = {"engine": engine, "reads": total, "search_s": search_s,
                   **({"host_threads": native.get_threads()}
                      if engine != "ref" else {}),
                   **(eng.stats if eng is not None else {})}
    finally:
        with rec.span("aln.close"):
            if eng is not None:
                eng.close()
            # the shard's reads, hits, index and engine freed here, in the
            # span, not unnamed on the return (~0.2 s at 0x40000 reads)
            reads = batch = seqs = rseqs = results = fms = eng = None
    return total, summary


def print_stats(summary: dict, rec: spans.Recorder) -> None:
    """The `[aln] stats` line: `summary` and the command's spans, once its
    root span has closed."""
    line = json.dumps({**summary, "spans": rec.records()})
    print(f"[aln] stats {line}", file=sys.stderr)
