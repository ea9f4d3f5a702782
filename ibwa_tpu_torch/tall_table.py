"""Lifted tables: an index of a small genome raised above 2^31 rows, so
that `aln` and the SA walker run on table rows and values at and above
2^31 without a genome of that size: phase 4l of `chip_smoke.py`.

    python -m ibwa_tpu_torch.tall_table PREFIX [--lift straddle|top]
        [--device cuda] [--fq READS] [--json] [--work DIR]

`lift(prefix, out, m)` writes `out.bwt`, `.rbwt`, `.sa` and `.rsa` (the
files `load_index` reads and the native search binds) from the arrays of
a built index, for each strand putting `m` rows of base A (code 0) BEFORE
its BWT; `m` is a multiple of 128, so whole occ blocks and the 1-in-32 SA
sampling stay aligned.  With n = seq_len:

    seq_len' = n + m            primary' = primary + m
    L2'[c]   = L2[c] + m        for C, G and T (the counts of the lifted
                                string), L2'[0] = 0
    checkpoints: the m / 128 padding blocks count 128 * b A's before block
                 b, and every checkpoint of the genome's blocks (the final
                 one too) is raised by m in A's column
    sampled SA: sample s of the genome is sample s + m / 32, its value
                raised by m (mod 2^32: the genome's row 0, stored as
                0xFFFFFFFF, becomes m - 1); padding sample s has m - 1 -
                32 s, the value the padding's own LF walk gives it.

So for every row r >= m but primary', LF'(r) = LF(r - m) + m (the occ
counts of the genome's rows are raised by m in A's column exactly where
L2 of the other bases is), and LF'(primary') = 0, LF'(r) = r + 1 for r
< m: a backward-search step from an interval inside the genome's rows
lands exactly m higher, and an SA walk from a genome row returns its
value plus m, unless it passes the primary row (then it ends at row 0,
whose value the format fixes at 0xFFFFFFFF, and returns the value
itself).  The one step that reaches the padding is a search's first step
on base A from (0, seq_len'), whose interval spans it: every route takes
it alike, so the routes are compared on the lifted table, never against
the genome's own hits.  No suffix array is built: a lift of a 32 Mbp
index to 4.3 Gbp takes seconds.

The two lifts (`LIFTS`):

  straddle  m = 2^31 - 2^floor(log2 n): the genome's rows cross 2^31,
            more than half of them above it (the smoke's 32 Mbp genome:
            2^31 - 2^24)
  top       m as large as the index admits: seq_len' = TOP_SEQ_LEN -
            (TOP_SEQ_LEN - n) % 128, at most TOP_SEQ_LEN = 2^32 - 2.
            0xFFFFFFFF is bwtint_t(-1), the occ queries' "k - 1 of row 0"
            (`fm/fmindex.py` NEG1, `u32.py`, `csrc/fm_row.cuh` kNeg1), so
            seq_len, an interval's upper bound, must stay below it; the
            frugal builder's EMPTY (`native/src/sais_frugal.cpp`) is the
            same word, so no text of 2^32 - 1 bases can be built either.
            Nothing else in the index format (u32 primary, L2, seq_len
            and SA values) or in `ibwa_tpu`'s code bounds it lower: its
            sizes (n_sa, the interleaved length) are Python integers.

`run` (4l; `--lift`) lifts an index, aligns a FASTQ on the lifted table
`--engine native`, device-only and hybrid (the .sai byte-equal), and
holds the SA walker (K5 on a card) on the .sai's intervals plus random
intervals whose rows lie at or above 2^31 against the native host walk;
it counts the hits and walk rows and values at and above 2^31, each of
which must be above 0.  With `split` it also runs `aln --idx 2` over the
lifted table split by rows on one device (each range an allocation of
its own).  The checks of K6 and K8 on a chunk, and their times, are
`chip_smoke.py`'s (`run_tall_phase`).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import struct
import sys
import time

import numpy as np

from .index import formats

OCC_INTV = formats.OCC_INTERVAL
HIGH = 1 << 31
TOP_SEQ_LEN = 0xFFFFFFFE        # the largest seq_len the index admits
LIFTS = ("straddle", "top")
PAD_BLOCKS = 1 << 20            # padding blocks written at a time (48 MB)
WALK_MAX_WIDTH = 256            # the .sai's intervals K5 is held on
RANDOM_INTERVALS = 200_000
WORK = pathlib.Path(__file__).resolve().parent.parent / ".bench" / "tall"
SEED = 20261019
STRANDS = ((".bwt", ".sa"), (".rbwt", ".rsa"))
PROBE_READS = ("A" * 100, "A" * 60 + "C" + "A" * 39, "T" * 100)


def log(msg: str) -> None:
    print(f"[tall] {msg}", file=sys.stderr, flush=True)


def lift_m(name: str, seq_len: int) -> int:
    """The padding of lift `name` for a genome of `seq_len` bases."""
    if name == "straddle":
        m = HIGH - (1 << (seq_len.bit_length() - 1))
    elif name == "top":
        m = (TOP_SEQ_LEN - seq_len) // OCC_INTV * OCC_INTV
    else:
        raise ValueError(f"unknown lift {name!r}: one of {LIFTS}")
    check_m(m, seq_len)
    return m


def check_m(m: int, seq_len: int, sa_intv: int = formats.SA_INTERVAL
            ) -> None:
    if m <= 0 or m % OCC_INTV or m % sa_intv:
        raise ValueError(f"the padding must be a positive multiple of "
                         f"{OCC_INTV} and of the SA interval: {m}")
    if seq_len + m > TOP_SEQ_LEN:
        raise ValueError(f"seq_len {seq_len} + {m} is above the index's "
                         f"{TOP_SEQ_LEN}")


def _write_padding(f, m: int) -> None:
    """The m / 128 padding blocks of the interleaved stream: block b counts
    128 * b A's before it, and its 8 text words are 0 (A)."""
    n = m // OCC_INTV
    blk = np.zeros((min(PAD_BLOCKS, n), 12), dtype="<u4")
    for b0 in range(0, n, PAD_BLOCKS):
        b1 = min(b0 + PAD_BLOCKS, n)
        blk[:b1 - b0, 0] = np.arange(b0, b1, dtype=np.uint32) * np.uint32(
            OCC_INTV)          # below 2^32: n < 2^25
        f.write(blk[:b1 - b0])


def lift_bwt(src: str, dst: str, m: int) -> formats.BwtIndex:
    """One strand's .bwt lifted by m (the module's docstring)."""
    idx = formats.read_bwt(src)
    check_m(m, idx.seq_len)
    n_blocks = (idx.seq_len + OCC_INTV - 1) // OCC_INTV
    body = np.array(idx.interleaved, dtype=np.uint32)
    # A's column: each block's first checkpoint word, then the final
    # checkpoint (the totals) after the last block's text words
    body[0:12 * (n_blocks - 1) + 1:12] += np.uint32(m)
    body[-4] += np.uint32(m)
    l2 = idx.L2.astype(np.uint64)
    l2[1:] += m
    with open(dst, "wb") as f:
        f.write(struct.pack("<I", idx.primary + m))
        f.write(l2[1:5].astype("<u4").tobytes())
        _write_padding(f, m)
        f.write(body.astype("<u4", copy=False))
    return idx


def lift_sa(src: str, dst: str, idx: formats.BwtIndex, m: int) -> None:
    """One strand's .sa lifted by m (the module's docstring)."""
    formats.read_sa(src, idx)
    intv = idx.sa_intv
    check_m(m, idx.seq_len, intv)
    pad = (m - 1 - intv * np.arange(m // intv, dtype=np.int64)).astype(
        np.uint32)
    vals = (idx.sa.astype(np.uint64) + m).astype(np.uint32)   # mod 2^32
    l2 = idx.L2.astype(np.uint64)
    l2[1:] += m
    with open(dst, "wb") as f:
        f.write(struct.pack("<I", idx.primary + m))
        f.write(l2[1:5].astype("<u4").tobytes())
        f.write(struct.pack("<II", intv, idx.seq_len + m))
        f.write(pad[1:].astype("<u4", copy=False))  # sa'[0] not stored
        f.write(vals.astype("<u4", copy=False))


def lift(prefix: str, out: str, m: int) -> dict:
    """Write `out`.{bwt,rbwt,sa,rsa}: the index at `prefix` lifted by m.
    Returns {seq_len, m, primary: [fwd, rev] of the lifted table,
    seconds, bytes}."""
    t0 = time.perf_counter()
    prim, size = [], 0
    for bwt_ext, sa_ext in STRANDS:
        idx = lift_bwt(prefix + bwt_ext, out + bwt_ext, m)
        lift_sa(prefix + sa_ext, out + sa_ext, idx, m)
        prim.append(idx.primary + m)
        size += sum(pathlib.Path(out + e).stat().st_size
                    for e in (bwt_ext, sa_ext))
    return {"seq_len": idx.seq_len + m, "m": m, "genome_seq_len":
            idx.seq_len, "primary": prim, "seconds":
            time.perf_counter() - t0, "bytes": size}


# ---- 4l: aln and the walker on a lift -----------------------------------

def probe_fastq(fq: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    """`fq`'s reads after PROBE_READS (first, so that a chunk of the first
    PERSIST_N reads holds them): reads of A's whose exact hit on a lifted
    table spans the padding, 2^31 rows and more on `top`, with hits of one
    mismatch beside it (the padding's junction with the genome), which
    bwtgap.c's int best_cnt lets in after it."""
    head = "".join(f"@tall_probe{i}\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(PROBE_READS))
    out.write_text(head + pathlib.Path(fq).read_text())
    return out


def sai_hits(path) -> dict:
    """The hits of a .sai as arrays: read index, a, k, l (int64)."""
    from .io.sai import iter_sai
    rows = [(i, h.a, h.k, h.l) for i, hits in enumerate(iter_sai(str(path)))
            for h in hits]
    arr = np.array(rows, dtype=np.int64).reshape(-1, 4)
    return dict(zip(("read", "a", "k", "l"), arr.T))


def aln_split(prefix: str, fq, work: pathlib.Path, device: str,
              native_sai: pathlib.Path) -> dict:
    """`aln --idx 2` device-only over one entry whose table is split by
    rows in two ranges on `device` (each range an allocation of its own):
    .sai byte-equal to native's, and on a card one launch of the sharded
    width pass and chunk search a chunk and nothing else."""
    from . import parity_scale as ps
    from .align import engine
    out = work / "split.sai"
    devs = f"{device},{device}"
    r = ps.run_cli("aln", ["--idx", "2", prefix, str(fq), "--device", devs],
                   out, {"IBWA_HOST_FRAC": "0",
                         "OMP_NUM_THREADS": str(ps.HOST_THREADS)})
    ps.same_bytes("aln --idx 2", out, native_sai)
    stats = json.loads([ln for ln in r["err"].splitlines()
                        if ln.startswith("[aln] stats ")][-1][12:])
    chunks = sum(-(-(b["reads"] - b["host_reads"]) // engine.PERSIST_N)
                 for b in stats["batches"])
    want = ({f"{k}_sharded": chunks for k in ps.ALN_KERNELS}
            if device.startswith("cuda") else {})
    if r["launches"] != want:
        raise AssertionError(f"aln --idx 2 launched {r['launches']}, not "
                             f"{want}")
    return {"device": devs, "launches": r["launches"], "chunks": chunks,
            "device_reads": stats["device_reads"],
            "fallback_reads": stats["fallback_reads"], "equal": True}


def hold_walker(prefix: str, hits: dict, device: str, m: int, rng
                ) -> dict:
    """The SA walker (K5 on a card, its plain version on the CPU) over the
    lift by `m` at `prefix`: on the run's intervals of at most
    WALK_MAX_WIDTH rows (walker strand 1 - a, the strand the hit was
    searched on) and on RANDOM_INTERVALS intervals of 1 to 4 of the
    genome's rows at and above max(2^31, m), bitwise equal to the native
    host walk row by row.  Its launches are a
    check's: the counters are left as they were.  Returns the counts and,
    under `_calls`, the walker call as `chip_smoke.py`'s k5_on_run takes
    it."""
    import collections

    from . import kernels, native
    from .fm import walk
    from .fm.fmindex import FmIndex
    from .index.builder import load_index
    fms = [FmIndex(load_index(prefix, s)) for s in (0, 1)]
    seq_len = fms[0].seq_len
    keep = hits["l"] - hits["k"] < WALK_MAX_WIDTH
    rk = rng.integers(max(HIGH, m), seq_len + 1, RANDOM_INTERVALS)
    strand = np.concatenate([1 - hits["a"][keep],
                             rng.integers(0, 2, RANDOM_INTERVALS)])
    ks = np.concatenate([hits["k"][keep], rk])
    ls = np.concatenate([hits["l"][keep],
                         np.minimum(rk + rng.integers(0, 4, len(rk)),
                                    seq_len)])
    strand, ks, ls = (a.astype(np.uint32) for a in (strand, ks, ls))
    rows = np.concatenate([np.arange(k, l + 1, dtype=np.int64)
                           for k, l in zip(ks.tolist(), ls.tolist())])
    row_strand = np.repeat(strand, ls.astype(np.int64) - ks + 1)
    want = np.empty(len(rows), dtype=np.uint32)
    for s in (0, 1):
        f, sel = fms[s], row_strand == s
        want[sel] = native.sa_lookup(f._interleaved, f.primary, f.L2,
                                     f.seq_len, f.sa_intv, f.sa,
                                     rows[sel].astype(np.uint32))
    before = collections.Counter(kernels.launches)
    t0 = time.perf_counter()
    walker = walk.DeviceWalker(fms[0], fms[1], device)
    _, vals = walker.resolve_intervals(strand, ks, ls)
    secs = time.perf_counter() - t0
    kernels.launches.clear()
    kernels.launches.update(before)
    if not np.array_equal(vals, want):
        bad = int(np.nonzero(vals != want)[0][0])
        raise AssertionError(f"the walker on {device} differs from the host "
                             f"walk at row {rows[bad]} (strand "
                             f"{row_strand[bad]}): {vals[bad]} against "
                             f"{want[bad]}")
    out = {"intervals": len(ks), "run_intervals": int(keep.sum()),
           "rows": len(rows), "rows_at_or_above_2_31": int(
               (rows >= HIGH).sum()),
           "values_at_or_above_2_31": int((vals >= HIGH).sum()),
           "waves": walker.last["waves"], "seconds_walker": secs,
           "equal": True}
    for key in ("rows_at_or_above_2_31", "values_at_or_above_2_31"):
        if out[key] <= 0:
            raise AssertionError(f"the walker's check reached no {key}")
    out["_calls"] = [(walker, strand, ks, ls, vals, walker.last)]
    return out


def run(prefix: str, fq, name: str, device: str = "cuda",
        work: pathlib.Path = WORK, split: bool = False, say=log) -> dict:
    """Lift `name` of the index at `prefix` and, on it: `aln` of `fq`
    (`--engine native`, device-only and hybrid; with `split` also `aln
    --idx 2`), every device .sai byte-equal to native's, one width pass
    and one chunk search a chunk on a card; the hits at and above 2^31;
    the walker held (`hold_walker`).  Raises on the first inequality or a
    count of 0 at and above 2^31.  Returns the record (its `_calls` and
    `_prefix` for the caller's own checks)."""
    from . import parity_scale as ps
    work = pathlib.Path(work) / name
    work.mkdir(parents=True, exist_ok=True)
    n = formats.read_bwt(prefix + ".bwt").seq_len
    lifted = str(work / "lift")
    rep = lift(prefix, lifted, lift_m(name, n))
    say(f"{name}: {n} rows lifted by {rep['m']} to seq_len "
        f"{rep['seq_len']} (primary {rep['primary']}) in "
        f"{rep['seconds']:.1f} s, {rep['bytes']} bytes of .bwt and .sa")
    t0 = time.perf_counter()
    res = ps.aln_pair(name, lifted, fq, work, device,
                      routes=("device_only", "hybrid"))
    rec = {"lift": name, **rep, "genome_seq_len": n,
           "aln": {r: ps.aln_summary(st) for r, st in res.items()},
           "aln_s": time.perf_counter() - t0}
    launches = {r: st["launches"] for r, st in res.items()}
    if split:
        rec["aln"]["split"] = aln_split(lifted, fq, work, device,
                                        work / f"{name}.native.sai")
        launches["split"] = rec["aln"]["split"]["launches"]
    rec["launches"] = launches
    hits = sai_hits(work / f"{name}.native.sai")
    rec["hits"] = len(hits["k"])
    rec["hits_at_or_above_2_31"] = int((hits["k"] >= HIGH).sum())
    rec["widest_hit"] = int((hits["l"] - hits["k"] + 1).max())
    if rec["hits_at_or_above_2_31"] <= 0:
        raise AssertionError(f"{name}: no hit at or above 2^31")
    say(f"{name}: aln device-only, hybrid"
        + (", --idx 2" if split else "") + f" and native .sai byte-equal "
        f"({rec['aln_s']:.1f} s); {rec['hits']} hits, "
        f"{rec['hits_at_or_above_2_31']} at or above 2^31, the widest "
        f"{rec['widest_hit']} rows; launches {launches}; fallback "
        f"{rec['aln']['device_only']['fallback_reads']} by cause "
        f"{rec['aln']['device_only']['fallback_by_cause']}")
    rec["walk"] = hold_walker(lifted, hits, device, rep["m"],
                              np.random.default_rng([SEED, len(name)]))
    rec["_calls"] = rec["walk"].pop("_calls")
    rec["_prefix"] = lifted
    say(f"{name}: the walker on {device} bitwise equal to the host walk: "
        + ", ".join(f"{k} {v}" for k, v in rec["walk"].items()))
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.tall_table",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("prefix", help="a built index (the FASTA's path)")
    ap.add_argument("--fq", help="reads to align on the lift (aln and the "
                                 "walker's hold); without it, only the lift")
    ap.add_argument("--lift", choices=LIFTS, default="straddle")
    ap.add_argument("--device", default="cuda",
                    help="device of the device routes (cuda, cuda:N, cpu)")
    ap.add_argument("--split", action="store_true",
                    help="also aln --idx 2 over the table split in two")
    ap.add_argument("--json", action="store_true",
                    help="print the record as one JSON line on stdout")
    ap.add_argument("--work", default=str(WORK))
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log("no CUDA device; pass --device cpu")
            return 2
    work = pathlib.Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    if args.fq is None:
        n = formats.read_bwt(args.prefix + ".bwt").seq_len
        rec = lift(args.prefix, str(work / args.lift), lift_m(args.lift, n))
    else:
        rec = run(args.prefix, probe_fastq(args.fq, work / "reads.fq"),
                  args.lift, args.device, work, args.split)
        rec = {k: v for k, v in rec.items() if not k.startswith("_")}
    log(json.dumps(rec))
    if args.json:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
