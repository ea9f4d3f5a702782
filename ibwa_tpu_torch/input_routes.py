"""The input routes of the port at a size users run, every device route
byte-equal to the host route: phase 4k of `chip_smoke.py`.

    python -m ibwa_tpu_torch.input_routes [--device cuda]
        [--scale full|tiny] [--json] [--work DIR]

The genome is `dist_aln.py`'s 4,600,000 bp corpus genome (cached under
.bench/dist_aln_torch/, as phase 4j leaves it), rewritten as a user's
assembly comes: 30% of its bases soft-masked (lower case) and 0.3% IUPAC
ambiguity codes (numpy from a fixed seed), then indexed by the port.
Pairs of 100 bp are simulated from the unmasked bases (`parity_scale.
sim_pairs`), so that some reads span IUPAC sites, and 5% of the reads of
each end get an N run of 1-30 bases.  Every command runs through the
port's `cli.main` (`parity_scale.run_cli`), and on each route:

  aln_end1, aln_end2  `aln` device-only (IBWA_HOST_FRAC=0) against
                      `--engine native` on each end (.sai byte-equal)
  samse               on end 1, from the device .sai and from the native
                      one: SAM byte-equal, one record a read in read order
  sampe               `sampe -R`, K5's walks against the host walks: SAM
                      byte-equal, 0 values refused and 0 host walks after
                      each prefill, lf_walk once a wave
  aln_q20_I           end 1 with offset-64 qualities with decaying tails,
                      `aln -q 20 -I`
  aln_B5              end 1 with a 5-base barcode before each read,
                      `aln -B 5`
  bam_seam            BAM input (`aln -b`) of pipeline.BATCH_SIZE + 4,096
                      records (read1 / read2 in turns, half stored
                      reverse-complemented with 0x10): two batches (tiny:
                      40 records, batches as BATCH_SIZE makes them)
  bam_read1/2         the first 32,768 of those records, `aln -b -1` and
                      `aln -b -2`
  remap3_aln          a primary (the masked genome) and two alternates of
                      haplotypes with `.remap` CIGARs (`parity_scale.
                      make_haplotype`), 32,768 pairs from all three: `aln`
                      of both ends against each db, device-only against
                      native
  sampe_remap3        `sampe -R` over the three dbs, K5 against the host
                      walks: SAM byte-equal with ZR tags, one walker a db
                      in DbSet order, 0 refused and 0 host walks
  k5_above_2_31       the walker over the masked genome's table with both
                      sampled arrays shifted by 2^31 (`DeviceWalker.
                      from_table`), on random intervals: bitwise equal to
                      the native host walk plus 2^31 (a check: its launches
                      are not a route's)

Each aln route's device run must launch one width pass and one chunk
search a chunk and nothing else on a card, and keep reads on the device
(`device_reads` > 0).  Each route ends with one JSON line (on stdout with
--json): its reads, `device_reads`, fallback by cause, launches, chunks
or waves, the native search's host threads, seconds and `equal`.  The
first inequality raises.  `--scale tiny` cuts the counts, never the
recipe, for the CPU (`--device cpu`: the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gzip
import json
import pathlib
import struct
import sys
import time

import numpy as np

from . import parity_scale as ps

WORK = pathlib.Path(__file__).resolve().parent.parent / ".bench" / \
    "input_routes"
SEED = 20261018
LOWER_SHARE = 0.3               # soft-masked bases
IUPAC_SHARE = 0.003             # IUPAC codes, of every base
IUPAC = np.frombuffer(b"MRWSYKVHDBN", dtype=np.uint8)
NRUN_SHARE = 0.05               # reads of an end with an N run
NRUN_LENS = np.array([1, 2, 3, 5, 8, 15, 30])
BARCODE = 5
TRIM_Q = 20
HIGH = 1 << 31
ALN_ROUTES = ("aln_end1", "aln_end2", "aln_q20_I", "aln_B5", "bam_seam",
              "bam_read1", "bam_read2", "remap3_aln")
ROUTES = ("aln_end1", "aln_end2", "samse", "sampe", "aln_q20_I", "aln_B5",
          "bam_seam", "bam_read1", "bam_read2", "remap3_aln",
          "sampe_remap3", "k5_above_2_31")


@dataclasses.dataclass(frozen=True)
class Scale:
    genome_len: int          # of dist_aln's genome
    genome_reads: int        # dist_aln's corpus the genome is cached with
    pairs: int
    bam_base: int | None     # BAM records before bam_extra (None: the
                             # pipeline's BATCH_SIZE, so that -b crosses it)
    bam_extra: int
    bam_split: int           # records of the -b -1 / -b -2 runs
    remap_pairs: int
    haplotypes: int          # of each alternate
    hap_len: int
    walk_intervals: int      # k5_above_2_31's random intervals


SCALES = {
    "full": Scale(genome_len=4_600_000, genome_reads=40_000, pairs=65_536,
                  bam_base=None, bam_extra=4_096, bam_split=32_768,
                  remap_pairs=32_768, haplotypes=4, hap_len=50_000,
                  walk_intervals=200_000),
    "tiny": Scale(genome_len=200_000, genome_reads=8, pairs=16, bam_base=32,
                  bam_extra=8, bam_split=16, remap_pairs=12, haplotypes=1,
                  hap_len=5_000, walk_intervals=64),
}


def log(msg: str) -> None:
    print(f"[input_routes] {msg}", file=sys.stderr, flush=True)


# ---- inputs -----------------------------------------------------------------

def mask(rng, clean: np.ndarray) -> np.ndarray:
    """LOWER_SHARE of the bases in lower case, then IUPAC_SHARE of them
    (of every base) replaced by an IUPAC code (upper case), as
    tests/test_adversarial.py's soft-masked genome."""
    out = clean.copy()
    lower = rng.random(len(out)) < LOWER_SHARE
    out[lower] += 32
    iu = np.nonzero(rng.random(len(out)) < IUPAC_SHARE)[0]
    out[iu] = IUPAC[rng.integers(0, len(IUPAC), len(iu))]
    return out


def add_n_runs(rng, reads: np.ndarray) -> int:
    """NRUN_SHARE of the reads get an N run of one of NRUN_LENS bases at
    a random place (cut at the read's end), in place; returns their
    count."""
    rows = np.nonzero(rng.random(len(reads)) < NRUN_SHARE)[0]
    at = rng.integers(0, reads.shape[1] - 5, len(rows))
    run = rng.choice(NRUN_LENS, len(rows))
    for r, a, n in zip(rows, at, run):
        reads[r, a:a + n] = ord("N")
    return len(rows)


def illumina64(rng, n: int, length: int) -> np.ndarray:
    """Offset-64 qualities with a decaying 3' tail (tests/
    test_adversarial.py's `-q 20 -I` recipe): base j has
    64 + max(2, 40 - U[0, j + 2))."""
    drop = (rng.random((n, length)) * (np.arange(length) + 2)).astype(
        np.int64)
    return (64 + np.maximum(2, 40 - drop)).astype(np.uint8)


NT16 = np.zeros(256, dtype=np.uint8)
for _c, _v in zip(b"ACGTN", (1, 2, 4, 8, 15)):
    NT16[_c] = _v


def write_bam(path: pathlib.Path, names: list[bytes], flags: np.ndarray,
              seqs: np.ndarray, quals: np.ndarray) -> None:
    """A BAM of unmapped records (bamlite's layout, gzip): names, flags,
    ASCII bases and phred+33 qualities of one length."""
    n, length = seqs.shape
    codes = NT16[seqs]
    if length % 2:
        codes = np.pad(codes, ((0, 0), (0, 1)))
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    q = quals - 33
    text = b"@HD\tVN:1.0\n"
    parts = [b"BAM\x01", struct.pack("<i", len(text)), text,
             struct.pack("<i", 0)]
    for i in range(n):
        qname = names[i] + b"\x00"
        body = (struct.pack("<iiIIiiii", -1, -1, (4680 << 16) | len(qname),
                            int(flags[i]) << 16, length, -1, -1, 0)
                + qname + packed[i].tobytes() + q[i].tobytes())
        parts.append(struct.pack("<i", len(body)) + body)
    with open(path, "wb") as f:
        f.write(gzip.compress(b"".join(parts), compresslevel=1))


def bam_records(rng, clean: np.ndarray, n: int):
    """n records of n // 2 + 1 simulated pairs, read1 and read2 in turns
    (flags 0x41 / 0x81), half stored reverse-complemented with 0x10."""
    m1, m2 = ps.sim_pairs(rng, [clean], [1.0], n // 2 + 1)
    seqs = np.empty((2 * len(m1), m1.shape[1]), dtype=np.uint8)
    seqs[0::2], seqs[1::2] = m1, m2
    flags = np.tile([0x41, 0x81], len(m1))
    rev = rng.random(len(seqs)) < 0.5
    seqs[rev] = ps.COMP[seqs[rev][:, ::-1]]
    flags[rev] |= 0x10
    return seqs[:n], flags[:n]


def haplotype_dbs(rng, clean: np.ndarray, sc: Scale, work: pathlib.Path,
                  contig: str) -> tuple[list[pathlib.Path], list]:
    """Two alternates of sc.haplotypes haplotypes each (the second also an
    exact contig), from places spread over the primary, with their .remap
    files; indexed.  Returns (their FASTAs, every alternate contig)."""
    n = 2 * sc.haplotypes + 1
    starts = [(2 * i + 1) * (len(clean) - 2 * sc.hap_len) // (2 * n)
              for i in range(n)]
    fas, contigs = [], []
    for a in (1, 2):
        fa = work / f"alt{a}.fa"
        mine, remap = [], []
        for i in range(sc.haplotypes):
            s = starts[(a - 1) * sc.haplotypes + i]
            seq, cig, stop = ps.make_haplotype(rng, clean, s, sc.hap_len)
            mine.append((f"a{a}hap{i}", seq))
            remap.append(f">a{a}h{i}-{contig}|{s + 1}|{stop}\n"
                         + "".join(cig[j:j + 60] + "\n"
                                   for j in range(0, len(cig), 60)))
        if a == 2:
            s = starts[-1]
            mine.append(("a2exact", clean[s:s + sc.hap_len]))
            remap.append(f">a2x-{contig}|exact|0\n")
        ps.write_fasta(fa, mine)
        (work / f"alt{a}.fa.remap").write_text("".join(remap))
        ps.index(fa)
        fas.append(fa)
        contigs += [c for _, c in mine]
    return fas, contigs


@dataclasses.dataclass
class Inputs:
    fa: pathlib.Path
    pairs: tuple
    i64: pathlib.Path
    barcoded: pathlib.Path
    bam: pathlib.Path
    bam_split: pathlib.Path
    alts: list
    remap_pairs: tuple
    counts: dict


def ensure_inputs(sc: Scale, work: pathlib.Path, scale: str,
                  say=log) -> Inputs:
    """Every input under `work`, made once (`inputs.json`, written last,
    keeps their counts)."""
    from . import dist_aln
    from .align import pipeline
    n_bam = (sc.bam_base or pipeline.BATCH_SIZE) + sc.bam_extra
    inp = Inputs(
        fa=work / "masked.fa", pairs=(work / "pairs_1.fq",
                                      work / "pairs_2.fq"),
        i64=work / "end1_q64.fq", barcoded=work / "end1_bc.fq",
        bam=work / "reads.bam", bam_split=work / "reads_split.bam",
        alts=[work / "alt1.fa", work / "alt2.fa"],
        remap_pairs=(work / "remap_1.fq", work / "remap_2.fq"), counts={})
    done = work / "inputs.json"
    if done.exists():
        meta = json.loads(done.read_text())
        if meta["bam_records"] == n_bam:
            inp.counts = meta
            return inp
    t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    src = (dist_aln.WORK if scale == "full" else work / "genome")
    g = dist_aln.ensure_inputs(src, sc.genome_reads, sc.genome_len, say)
    clean = ps.fasta_bases(g["fa"]).copy()
    if len(clean) != sc.genome_len:
        raise AssertionError(f"{g['fa']}: {len(clean)} bases, not "
                             f"{sc.genome_len}")
    rng = np.random.default_rng([SEED, 0])
    masked = mask(rng, clean)
    ps.write_fasta(inp.fa, [("U00096", masked)])
    ps.index(inp.fa)
    mates = ps.sim_pairs(np.random.default_rng([SEED, 1]), [clean], [1.0],
                         sc.pairs)
    rng = np.random.default_rng([SEED, 2])
    n_runs = [add_n_runs(rng, m) for m in mates]
    for fq, m in zip(inp.pairs, mates):
        ps.write_fastq(fq, b"p", m)
    ps.write_fastq(inp.i64, b"p", mates[0],
                   illumina64(rng, *mates[0].shape))
    bc = ps.BASES[rng.integers(0, 4, (sc.pairs, BARCODE))]
    ps.write_fastq(inp.barcoded, b"p", np.concatenate([bc, mates[0]], 1))
    seqs, flags = bam_records(np.random.default_rng([SEED, 3]), clean,
                              n_bam)
    names = [b"b%d" % i for i in range(n_bam)]
    quals = np.full(seqs.shape, ord("I"), dtype=np.uint8)
    write_bam(inp.bam, names, flags, seqs, quals)
    k = sc.bam_split
    write_bam(inp.bam_split, names[:k], flags[:k], seqs[:k], quals[:k])
    fas, contigs = haplotype_dbs(np.random.default_rng([SEED, 4]), clean,
                                 sc, work, "U00096")
    n_alt = len(contigs)
    m1, m2 = ps.sim_pairs(np.random.default_rng([SEED, 5]),
                          [clean, *contigs], [0.5] + [0.5 / n_alt] * n_alt,
                          sc.remap_pairs, indel_reads=ps.INDEL_READS)
    for fq, m in zip(inp.remap_pairs, (m1, m2)):
        ps.write_fastq(fq, b"r", m)
    is_iupac = ~np.isin(masked, np.frombuffer(b"ACGTacgt", dtype=np.uint8))
    inp.counts = {"genome": len(masked), "lower": int((masked >= 97).sum()),
                  "iupac": int(is_iupac.sum()), "pairs": sc.pairs,
                  "n_run_reads": n_runs, "bam_records": n_bam,
                  "bam_split": k, "remap_pairs": sc.remap_pairs,
                  "alternate_contigs": n_alt}
    done.write_text(json.dumps(inp.counts))
    say(f"made and indexed the inputs in {time.perf_counter() - t0:.1f} s: "
        f"{inp.counts}")
    return inp


# ---- the routes -------------------------------------------------------------

def aln_record(route: str, res: dict) -> dict:
    """One aln route's line from `parity_scale.aln_pair`'s result (the
    device .sai already byte-equal to native's)."""
    from .align import engine
    d = res["device_only"]
    chunks = sum(-(-(b["reads"] - b["host_reads"]) // engine.PERSIST_N)
                 for b in d["batches"])
    if d["device_reads"] <= 0:
        raise AssertionError(f"{route}: no read stayed on the device")
    return {"route": route, "reads": d["reads"],
            "device_reads": d["device_reads"],
            "fallback_reads": d["fallback_reads"],
            "fallback_by_cause": d["fallback_by_cause"],
            "launches": d["launches"], "chunks": chunks,
            "batches": d["n_batches"],
            "host_threads": res["native"]["host_threads"],
            "native_search_s": res["native"]["search_s"],
            "device_search_s": d["search_s"], "equal": True}


def merge_aln(route: str, recs: list[dict]) -> dict:
    """Several aln records as one line: counts summed."""
    out = dict(recs[0], route=route)
    for k in ("reads", "device_reads", "fallback_reads", "chunks",
              "batches", "native_search_s", "device_search_s"):
        out[k] = sum(r[k] for r in recs)
    for k in ("fallback_by_cause", "launches"):
        c = collections.Counter()
        for r in recs:
            c.update(r[k])
        out[k] = dict(c)
    return out


def sampe_record(route: str, pe: dict) -> dict:
    waves = sum(b["waves"] for b in pe["batches"])
    return {"route": route, "reads": pe["records"], "mapped": pe["mapped"],
            "zr_tags": pe["zr_tags"],
            "device_rows": sum(b["rows"] for b in pe["batches"]),
            "batches": len(pe["batches"]), "waves": waves,
            "refused": sum(b["refused"] for b in pe["batches"]),
            "host_walks": sum(b["host_walks"] for b in pe["batches"]),
            "launches": pe["launches"], "host_s": pe["host_s"],
            "k5_s": pe["k5_s"], "equal": True}


def samse_route(inp: Inputs, work: pathlib.Path) -> dict:
    """samse on end 1 from the device .sai and from the native one: SAM
    byte-equal, one record a read in read order, nothing launched."""
    outs = {}
    for src in ("device_only", "native"):
        out = work / f"end1.{src}.samse.sam"
        r = ps.run_cli("samse", [str(inp.fa), str(work / f"end1.{src}.sai"),
                                 str(inp.pairs[0])], out)
        if r["launches"]:
            raise AssertionError(f"samse launched {r['launches']}")
        outs[src] = (out, r["wall"])
    size = ps.same_bytes("samse end 1", outs["device_only"][0],
                         outs["native"][0])
    recs = ps.sam_records(outs["native"][0])
    if [f[0] for f in recs] != ps.fastq_records(inp.pairs[0]):
        raise AssertionError("samse: not one record a read in read order")
    return {"route": "samse", "reads": len(recs),
            "mapped": sum(1 for f in recs if not int(f[1]) & 4),
            "bytes": size, "seconds_each": [w for _, w in outs.values()],
            "launches": {}, "equal": True}


def k5_above_2_31(inp: Inputs, sc: Scale, device: str) -> dict:
    """The walker over the masked genome's table with both sampled arrays
    shifted by 2^31, on random intervals of widths 1-4: its u32 values
    bitwise equal to the native host walk plus 2^31.  Its launches are a
    check's: the counters are left as they were."""
    from . import kernels, native
    from .fm import walk
    from .fm.fmindex import FmIndex
    from .index.builder import load_index
    fms = [FmIndex(load_index(str(inp.fa), s)) for s in (0, 1)]
    rng = np.random.default_rng([SEED, 6])
    n = fms[0].seq_len
    ks = rng.integers(1, n + 1, sc.walk_intervals).astype(np.uint32)
    ls = np.minimum(ks + rng.integers(0, 4, len(ks)), n).astype(np.uint32)
    strand = rng.integers(0, 2, len(ks)).astype(np.uint32)
    rows = np.concatenate([np.arange(k, l + 1, dtype=np.uint32)
                           for k, l in zip(ks, ls)])
    row_strand = np.repeat(strand, ls.astype(np.int64) - ks + 1)
    true = np.empty(len(rows), dtype=np.uint32)
    for s in (0, 1):
        f, sel = fms[s], row_strand == s
        true[sel] = native.sa_lookup(f._interleaved, f.primary, f.L2,
                                     f.seq_len, f.sa_intv, f.sa, rows[sel])
    want = (true.astype(np.uint64) + HIGH).astype(np.uint32)
    before = collections.Counter(kernels.launches)
    t0 = time.perf_counter()
    flat = walk.DeviceWalker(fms[0], fms[1], device)
    shifted = walk.DeviceWalker.from_table(
        flat.fm, [(np.asarray(f.sa, np.uint64) + HIGH).astype(np.uint32)
                  for f in fms], fms[0].sa_intv)
    _, got = shifted.resolve_intervals(strand, ks, ls)
    secs = time.perf_counter() - t0
    got_launches = {k: v - before[k] for k, v in kernels.launches.items()
                    if v != before[k]}
    kernels.launches.clear()
    kernels.launches.update(before)
    want_l = ({"lf_walk": shifted.last["waves"]}
              if device.startswith("cuda") else {})
    if got.dtype != np.uint32 or not np.array_equal(got, want) \
            or int(got.min()) < HIGH or got_launches != want_l:
        raise AssertionError(f"K5 above 2^31 on {device}: values differ "
                             f"from the host walk + 2^31, or launched "
                             f"{got_launches}, not {want_l}")
    return {"route": "k5_above_2_31", "reads": 0, "rows": len(rows),
            "intervals": len(ks), "min_value": int(got.min()),
            "max_value": int(got.max()), "waves": shifted.last["waves"],
            "check_launches": got_launches, "launches": {},
            "seconds_walker": secs, "equal": True}


def run(device: str = "cuda", scale: str = "full", work: pathlib.Path = WORK,
        report=None, say=log) -> list[dict]:
    """Every route of the docstring, in ROUTES' order; report(line) gets
    each route's JSON line as it ends.  Raises on the first
    inequality."""
    from .align import pipeline
    from .sam import sampe as sampe_mod
    sc = SCALES[scale]
    work = pathlib.Path(work) / scale
    inp = ensure_inputs(sc, work, scale, say)
    records = []

    def done(rec: dict, t0: float) -> None:
        rec.update(seconds=time.perf_counter() - t0, device=device)
        records.append(rec)
        say(f"{rec['route']}: " + ", ".join(
            f"{k} {v}" for k, v in rec.items()
            if k not in ("route", "device")))
        if report is not None:
            report(json.dumps(rec))

    fa = inp.fa
    for e, fq in enumerate(inp.pairs, 1):
        t0 = time.perf_counter()
        done(aln_record(f"aln_end{e}", ps.aln_pair(f"end{e}", fa, fq, work,
                                                   device)), t0)
    t0 = time.perf_counter()
    done(samse_route(inp, work), t0)
    t0 = time.perf_counter()
    args = [str(fa), str(work / "end1.native.sai"),
            str(work / "end2.native.sai"), *map(str, inp.pairs)]
    pe = ps.sampe_pair("pairs", args, work, device, sc.pairs)
    pe.pop("_calls")
    done(sampe_record("sampe", pe), t0)
    for route, fq, opts in (
            ("aln_q20_I", inp.i64, ["-q", str(TRIM_Q), "-I"]),
            ("aln_B5", inp.barcoded, ["-B", str(BARCODE)])):
        t0 = time.perf_counter()
        done(aln_record(route, ps.aln_pair(route, fa, fq, work, device,
                                           opts=opts)), t0)
    t0 = time.perf_counter()
    rec = aln_record("bam_seam", ps.aln_pair("bam", fa, inp.bam, work,
                                             device, opts=["-b"]))
    n_bam = inp.counts["bam_records"]
    want_b = ps.batches_of(n_bam, pipeline.BATCH_SIZE)
    if rec["reads"] != n_bam or rec["batches"] != want_b or (
            sc.bam_base is None and want_b != 2):
        raise AssertionError(f"bam_seam: {rec['reads']} reads in "
                             f"{rec['batches']} batches, not {n_bam} in "
                             f"{want_b}")
    done(rec, t0)
    for which in (1, 2):
        t0 = time.perf_counter()
        rec = aln_record(f"bam_read{which}", ps.aln_pair(
            f"bam{which}", fa, inp.bam_split, work, device,
            opts=["-b", f"-{which}"]))
        if rec["reads"] != sc.bam_split // 2:
            raise AssertionError(f"bam_read{which}: {rec['reads']} reads, "
                                 f"not {sc.bam_split // 2}")
        done(rec, t0)
    # three dbs
    t0 = time.perf_counter()
    dbs = [fa, *inp.alts]
    recs, args = [], []
    for j, db in enumerate(dbs):
        pair = []
        for e, fq in enumerate(inp.remap_pairs, 1):
            recs.append(aln_record("remap3_aln", ps.aln_pair(
                f"db{j}e{e}", db, fq, work, device)))
            pair.append(str(work / f"db{j}e{e}.native.sai"))
        args += [str(db), *pair]
        if j == 0:
            args += map(str, inp.remap_pairs)
    done(merge_aln("remap3_aln", recs), t0)
    t0 = time.perf_counter()
    pe = ps.sampe_pair("remap3", args, work, device, sc.remap_pairs)
    lens = [ps.fasta_len(db) for db in dbs]
    n_b = ps.batches_of(sc.remap_pairs, sampe_mod.BATCH)
    order = [c[0].fm.seq_len for c in pe.pop("_calls")]
    if order != lens * n_b or pe["zr_tags"] <= 0:
        raise AssertionError(f"sampe -R over three dbs: walkers on tables "
                             f"of {order} bases (not one a db in DbSet "
                             f"order, {lens}), {pe['zr_tags']} ZR tags")
    rec = sampe_record("sampe_remap3", pe)
    rec["walkers"] = order
    done(rec, t0)
    t0 = time.perf_counter()
    done(k5_above_2_31(inp, sc, device), t0)
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.input_routes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the device routes (cuda, cuda:N, cpu)")
    ap.add_argument("--scale", choices=sorted(SCALES), default="full")
    ap.add_argument("--json", action="store_true",
                    help="print each route's JSON line on stdout")
    ap.add_argument("--work", default=str(WORK),
                    help="directory of the cached inputs and the outputs")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log("no CUDA device; pass --device cpu")
            return 2
    run(args.device, args.scale, pathlib.Path(args.work),
        report=(lambda line: print(line, flush=True)) if args.json else None)
    log(f"every route equal ({args.scale}, {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
