"""Scale parity of the port: the counterpart of `scripts/parity_scale.py`.

That script holds `ibwa_tpu` against the reference binary on what small
fixtures cannot show: runs that cross the 0x40000-read batch seam
(bwtaln.c:193, bwape.c:476) and a repeat-rich genome whose SA intervals
are thousands of rows wide.  The reference binary is not part of this
repository, so here each device route of the port is held against the
port's own host route on the same inputs: `aln --device` against `aln
--engine native` (.sai byte-equal) and `sampe -R --device` (K5 walks the
SA rows on the card) against `sampe -R --engine native` (the host walks;
SAM byte-equal).  Every command runs through the port's `cli.main`, as a
user calls it.

Configurations (genomes and reads simulated with numpy from fixed seeds,
cached under .bench/parity_scale_torch/<scale>/<config>/):

  ecoli_seam       4,641,652 bp uniform random genome, one contig (E. coli
                   K-12 MG1655's length); 0x40000 + 16,384 pairs: `aln`
                   device-only, hybrid and native on both ends (two batches
                   an end), `sampe -R` with K5's walks and with the host
                   walks (two batches, 0 host walks, 0 refused values),
                   `samse` on mate 1 (two batches, a record a read, in read
                   order)
  repeat_pe        32 Mbp repeat-rich genome (`make_repeat_rich`: a 300 bp
                   unit x 4,000 in tandem, 40 x 50 kbp segmental
                   duplications at 0.05% divergence, a 300 bp element in 8%
                   of the fill blocks); 40,000 pairs: `aln` device-only
                   against native, `sampe -R` K5 against the host walks,
                   and K5 on the run's intervals in waves of `wave_rows`
                   bitwise equal to the run's one wave
  iterative_remap  iBWA's multi-reference remap: a 63,025,520 bp primary
                   (GRCh37 chr20's length, `simulate.make_genome`'s recipe)
                   and an alternate reference of 24 haplotypes of 50 kbp
                   (a SNP every ~300 bp, a 1-20 bp indel every ~2 kbp) with
                   their `.remap` CIGARs, plus 2 exact contigs of 20 kbp;
                   65,536 pairs (75% primary, 25% alternates, 5% of reads
                   with a 1-3 bp indel): `aln` of both ends against both
                   dbs device-only against native, `sampe -R` over the two
                   dbs K5 against the host walks (ZR tags, one walker a db
                   in DbSet order), and the rates of the two routes, three
                   rounds in turns on the first 32,768 pairs
  aln_options      the primary above; mate 1 of the first 16,384 pairs under
                   five option sets (default, -n 0, -o 2 -e 5 -n 6,
                   -l 20 -k 1, -N), and 16,384 reads of 36/76/100/150 bp
                   under the default: device-only against native, with the
                   arena size (ACAP) each run took

    python -m ibwa_tpu_torch.parity_scale [--device cuda] [--config NAME ...]
        [--scale full|tiny] [--json] [--work DIR]

`--scale tiny` shrinks the genomes and read counts so that the CPU tests
can run every check (`--device cpu`: the kernels' plain versions); it
changes no read length, insert size, error rate, option or batch size.
Each configuration ends with one JSON line (on stdout with --json); the
first inequality raises, and nothing passes over a failed comparison.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import itertools
import json
import os
import pathlib
import resource
import statistics
import sys
import tempfile
import time

import numpy as np

READ_LEN = 100
ISIZE_MEAN, ISIZE_SD = 300, 40     # scripts/parity_scale.py's sim_reads
SUB_RATE = 0.01
INDEL_READS = 0.05                 # iterative_remap: reads with an indel
MIXED_LENS = (36, 76, 100, 150)    # aln_options' mixed lengths
PRIMARY_SHARE = 0.75               # iterative_remap's pairs on the primary
HAP_LEN, EXACT_LEN = 50_000, 20_000
ROUNDS = 3                         # of every host-clock rate, in turns
WORK = pathlib.Path(__file__).resolve().parent.parent / ".bench" / \
    "parity_scale_torch"
CONFIGS = ("ecoli_seam", "repeat_pe", "iterative_remap", "aln_options")
# aln option sets: tests/test_engine_jax.py's CASES as `aln` flags
OPTION_SETS = {"default": [], "exact": ["-n", "0"],
               "gappy": ["-o", "2", "-e", "5", "-n", "6"],
               "seeded": ["-l", "20", "-k", "1"], "nonstop": ["-N"]}
WIDE_ARENA = ("gappy", "nonstop")  # option sets that need ACAP 1024
ALN_KERNELS = ("width_pass", "search_chunk")
LAUNCHES = collections.Counter()   # the commands' launches, a configuration


@dataclasses.dataclass(frozen=True)
class Scale:
    """Genome lengths and read counts of one scale."""

    ecoli_len: int
    ecoli_pairs: int
    repeat_len: int
    tandem_copies: int       # of make_repeat_rich's 300 bp unit
    segdups: int             # make_repeat_rich's 50 kbp duplications
    repeat_pairs: int
    primary_len: int
    primary_tandem: int      # of make_genome's 250 bp unit
    primary_segdups: int     # make_genome's 50 kbp duplications
    haplotypes: int          # alternate contigs of HAP_LEN
    exact_contigs: int       # alternate contigs of EXACT_LEN, exact
    remap_pairs: int
    rate_pairs: int          # iterative_remap's rates
    option_reads: int        # aln_options: mate 1 of the first pairs
    mixed_reads: int
    wave_rows: int           # K5's several-wave check on repeat_pe


SCALES = {
    "full": Scale(ecoli_len=4_641_652, ecoli_pairs=0x40000 + 16_384,
                  repeat_len=32_000_000, tandem_copies=4_000, segdups=40,
                  repeat_pairs=40_000, primary_len=63_025_520,
                  primary_tandem=3_840, primary_segdups=13, haplotypes=24,
                  exact_contigs=2, remap_pairs=65_536, rate_pairs=32_768,
                  option_reads=16_384, mixed_reads=16_384,
                  wave_rows=1 << 20),
    "tiny": Scale(ecoli_len=200_000, ecoli_pairs=40, repeat_len=400_000,
                  tandem_copies=40, segdups=2, repeat_pairs=32,
                  primary_len=1_000_000, primary_tandem=40,
                  primary_segdups=2, haplotypes=3, exact_contigs=2,
                  remap_pairs=48, rate_pairs=24, option_reads=24,
                  mixed_reads=24, wave_rows=64),
}

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b


def log(msg: str) -> None:
    print(f"[parity_scale] {msg}", file=sys.stderr, flush=True)


# ---- simulation (numpy) ----------------------------------------------------

def random_seq(rng, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def diverge(rng, seq: np.ndarray, n_sub: int) -> np.ndarray:
    """A copy of seq with n_sub positions set to a random base (which may
    be the base already there, as the reference script's rng.choice)."""
    out = seq.copy()
    out[rng.integers(0, len(out), n_sub)] = random_seq(rng, n_sub)
    return out


def fill_blocks(rng, target: int, element: np.ndarray, share: float,
                lo: int, hi: int) -> list[np.ndarray]:
    """Blocks until `target` bases: `element` with probability `share`,
    else a unique random block of lo to hi - 1 bases."""
    blocks, made = [], 0
    while made < target:
        if rng.random() < share:
            blocks.append(element)
        else:
            blocks.append(random_seq(rng, int(rng.integers(lo, hi))))
        made += len(blocks[-1])
    return blocks


def shuffled(rng, parts: list[np.ndarray], length: int) -> np.ndarray:
    return np.concatenate([parts[i] for i in
                           rng.permutation(len(parts))])[:length]


def make_repeat_rich(rng, length: int, tandem_copies: int, segdups: int
                     ) -> np.ndarray:
    """scripts/parity_scale.py::make_repeat_rich in numpy: a 300 bp unit
    repeated in tandem, 50 kbp segmental duplications at 0.05%
    divergence (25 substitutions each), a 300 bp interspersed element in
    8% of the fill blocks, unique fill of 2-12 kbp blocks, shuffled."""
    unit = random_seq(rng, 300)
    parts = [np.tile(unit, tandem_copies)]
    seg = random_seq(rng, 50_000)
    parts += [diverge(rng, seg, 25) for _ in range(segdups)]
    alu = random_seq(rng, 300)
    parts += fill_blocks(rng, length - sum(len(p) for p in parts), alu,
                         0.08, 2_000, 12_000)
    return shuffled(rng, parts, length)


def make_genome(rng, length: int, tandem_copies: int, segdups: int
                ) -> np.ndarray:
    """`simulate.make_genome`'s recipe in numpy: a 300 bp dispersed
    element in 10% of the blocks, a 250 bp unit in tandem, 50 kbp
    segmental duplications at ~0.1% divergence (50 substitutions each),
    unique blocks of 1.5-9 kbp, shuffled."""
    alu = random_seq(rng, 300)
    unit = random_seq(rng, 250)
    parts = [np.tile(unit, tandem_copies)]
    seg = random_seq(rng, 50_000)
    parts += [diverge(rng, seg, 50) for _ in range(segdups)]
    parts += fill_blocks(rng, length - sum(len(p) for p in parts), alu,
                         0.10, 1_500, 9_000)
    return shuffled(rng, parts, length)


def make_haplotype(rng, primary: np.ndarray, start: int, length: int
                   ) -> tuple[np.ndarray, str, int]:
    """An alternate haplotype of `length` bases from primary[start:]: a
    SNP every ~300 bp, a 1-20 bp insertion or deletion every ~2 kbp.
    Returns (sequence, its remap CIGAR onto the primary, the primary's
    position one past its end), as tests/test_torch_sam.py::_make_alt
    writes them."""
    alt, cig, pos, made = [], [], start, 0

    def push(op, n):
        if cig and cig[-1][0] == op:
            cig[-1][1] += n
        else:
            cig.append([op, n])

    while made < length:
        m = min(int(rng.integers(150, 450)), length - made)
        alt.append(primary[pos:pos + m])
        push("M", m)
        pos, made = pos + m, made + m
        if made >= length:
            break
        if rng.random() < 300 / 2000:
            n = int(rng.integers(1, 21))
            if rng.random() < 0.5:
                push("D", n)
                pos += n
            else:
                n = min(n, length - made)
                alt.append(random_seq(rng, n))
                push("I", n)
                made += n
        else:
            was = int(np.nonzero(BASES == primary[pos])[0][0])
            alt.append(BASES[[(was + int(rng.integers(1, 4))) % 4]])
            push("M", 1)
            pos, made = pos + 1, made + 1
    return (np.concatenate(alt), "".join(f"{n}{op}" for op, n in cig), pos)


def write_fasta(path: pathlib.Path, contigs) -> None:
    """contigs: (name, uint8 ASCII bases); 70 bases a line."""
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">%s\n" % name.encode())
            full = len(seq) // 70 * 70
            if full:
                body = np.empty((full // 70, 71), dtype=np.uint8)
                body[:, :70] = seq[:full].reshape(-1, 70)
                body[:, 70] = ord("\n")
                f.write(body.tobytes())
            if len(seq) > full:
                f.write(seq[full:].tobytes() + b"\n")


def write_fastq(path: pathlib.Path, prefix: bytes, reads) -> None:
    """reads: uint8 rows (or a list of arrays), named prefix + index."""
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s%d\n%s\n+\n%s\n" % (prefix, i, r.tobytes(),
                                                  b"I" * len(r))
                         for i, r in enumerate(reads)))


def substitute(rng, reads: np.ndarray) -> None:
    """SUB_RATE of the bases, in place, set to a random base."""
    sub = rng.random(reads.shape) < SUB_RATE
    reads[sub] = random_seq(rng, int(sub.sum()))


def with_indel(rng, genome: np.ndarray, start: int, end: int,
               from_end: bool) -> np.ndarray:
    """A READ_LEN read of genome[start:end]'s first (or, from_end, last)
    bases that carries a 1-3 bp insertion or deletion 10-90 bases in."""
    n = int(rng.integers(1, 4))
    p = int(rng.integers(10, 90))
    if rng.random() < 0.5:            # deletion: READ_LEN + n reference
        ref = (genome[end - READ_LEN - n:end] if from_end
               else genome[start:start + READ_LEN + n])
        return np.concatenate([ref[:p], ref[p + n:]])
    ref = (genome[end - READ_LEN + n:end] if from_end
           else genome[start:start + READ_LEN - n])
    return np.concatenate([ref[:p], random_seq(rng, n), ref[p:]])


def sim_pairs(rng, contigs: list[np.ndarray], weights, n: int,
              indel_reads: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """n pairs of READ_LEN bp (scripts/parity_scale.py::sim_reads): a
    contig drawn by weight, insert gauss(ISIZE_MEAN, ISIZE_SD) of at least
    2 x READ_LEN + 10, mate 1 the fragment's start, mate 2 the reverse
    complement of its end; `indel_reads` of each end carry a 1-3 bp
    indel; then SUB_RATE substitutions."""
    src = rng.choice(len(contigs), n, p=weights)
    isz = np.maximum(2 * READ_LEN + 10,
                     rng.normal(ISIZE_MEAN, ISIZE_SD, n).astype(np.int64))
    lens = np.array([len(c) for c in contigs], dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pad = 4                            # room for an indel's extra bases
    pos = pad + (rng.random(n) * (lens[src] - isz - 2 * pad)).astype(
        np.int64)
    genome = np.concatenate(contigs)
    start, end = base[src] + pos, base[src] + pos + isz
    col = np.arange(READ_LEN)
    mates = [genome[start[:, None] + col],
             genome[(end - READ_LEN)[:, None] + col]]
    for e, mate in enumerate(mates):
        for i in np.nonzero(rng.random(n) < indel_reads)[0]:
            mate[i] = with_indel(rng, genome, int(start[i]), int(end[i]),
                                 e == 1)
        substitute(rng, mate)
    return mates[0], COMP[mates[1][:, ::-1]]


def sim_mixed(rng, genome: np.ndarray, n: int) -> list[np.ndarray]:
    """n single-end reads of MIXED_LENS bp drawn uniformly, SUB_RATE
    substitutions, half reverse-complemented."""
    lens = rng.choice(MIXED_LENS, n)
    pos = (rng.random(n) * (len(genome) - lens)).astype(np.int64)
    rc = rng.random(n) < 0.5
    reads = []
    for i in range(n):
        r = genome[pos[i]:pos[i] + lens[i]].copy()
        substitute(rng, r)
        reads.append(COMP[r[::-1]] if rc[i] else r)
    return reads


# ---- inputs, cached ---------------------------------------------------------

def index(fa: pathlib.Path) -> None:
    from . import cli
    with stderr_text() as err:
        rc = cli.main(["index", str(fa)])
    if rc != 0:
        raise AssertionError(f"index {fa} exited {rc}:\n{err.getvalue()}")


def cached(done: pathlib.Path, make, say=log) -> None:
    """Run make() unless `done` exists; write `done` after it."""
    if done.exists():
        return
    t0 = time.perf_counter()
    make()
    done.write_text(f"{time.perf_counter() - t0:.1f} s\n")
    say(f"made and indexed the inputs of {done.parent.name} in "
        f"{time.perf_counter() - t0:.1f} s")


def pairs_inputs(work: pathlib.Path, name: str, seed: int, make_seq,
                 contig: str, n_pairs: int, say=log) -> tuple:
    """A one-contig genome from make_seq(rng), indexed, and n_pairs pairs
    of it: (fasta, (fq1, fq2))."""
    fa = work / f"{name}.fa"
    fqs = (work / f"{name}_1.fq", work / f"{name}_2.fq")

    def make():
        seq = make_seq(np.random.default_rng([seed, 0]))
        write_fasta(fa, [(contig, seq)])
        index(fa)
        for fq, mate in zip(fqs, sim_pairs(np.random.default_rng([seed, 1]),
                                           [seq], [1.0], n_pairs)):
            write_fastq(fq, b"p", mate)

    cached(work / "inputs.done", make, say)
    return fa, fqs


def remap_inputs(work: pathlib.Path, sc: Scale, say=log) -> dict:
    """iterative_remap's primary and alternate references (the latter
    with its .remap file), both indexed, and its pairs."""
    p = {"primary": work / "primary.fa", "alt": work / "alt.fa",
         "fq": (work / "remap_1.fq", work / "remap_2.fq")}

    def make():
        rng = np.random.default_rng([20261101, 0])
        primary = make_genome(rng, sc.primary_len, sc.primary_tandem,
                              sc.primary_segdups)
        write_fasta(p["primary"], [("chr20", primary)])
        contigs, remap = [], []
        n_alt = sc.haplotypes + sc.exact_contigs
        starts = [(2 * i + 1) * (sc.primary_len - 2 * HAP_LEN) // (2 * n_alt)
                  for i in range(n_alt)]
        for i, s in enumerate(starts[:sc.haplotypes]):
            seq, cig, stop = make_haplotype(rng, primary, s, HAP_LEN)
            contigs.append((f"hap{i}", seq))
            remap.append(f">h{i}-chr20|{s + 1}|{stop}\n"
                         + "".join(cig[j:j + 60] + "\n"
                                   for j in range(0, len(cig), 60)))
        for i, s in enumerate(starts[sc.haplotypes:]):
            contigs.append((f"exact{i}", primary[s:s + EXACT_LEN]))
            remap.append(f">x{i}-chr20|exact|0\n")
        write_fasta(p["alt"], contigs)
        (work / "alt.fa.remap").write_text("".join(remap))
        index(p["primary"])
        index(p["alt"])
        sources = [primary] + [c for _, c in contigs]
        weights = [PRIMARY_SHARE] + [(1 - PRIMARY_SHARE) / n_alt] * n_alt
        for fq, mate in zip(p["fq"], sim_pairs(
                np.random.default_rng([20261101, 1]), sources, weights,
                sc.remap_pairs, indel_reads=INDEL_READS)):
            write_fastq(fq, b"p", mate)

    cached(work / "inputs.done", make, say)
    return p


def fasta_len(fa: pathlib.Path) -> int:
    """Bases of a FASTA file (every contig)."""
    return sum(len(ln) - 1 for ln in open(fa, "rb") if ln[:1] != b">")


def fastq_records(fq: pathlib.Path) -> list[bytes]:
    """The read names of a FASTQ file, counted structurally: a record is
    four lines, its first starting with '@' and its third with '+'."""
    lines = fq.read_bytes().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        raise AssertionError(f"{fq}: {len(lines)} lines, not whole records")
    names = lines[0::4]
    if any(n[:1] != b"@" for n in names) or any(
            p[:1] != b"+" for p in lines[2::4]):
        raise AssertionError(f"{fq}: a record is not @name/seq/+/qual")
    return [n[1:].split()[0] for n in names]


def first_reads(fq: pathlib.Path, n: int, out: pathlib.Path) -> None:
    with open(fq, "rb") as f:
        out.write_bytes(b"".join(itertools.islice(f, 4 * n)))


def head_sai(sai_path: pathlib.Path, n: int, out: pathlib.Path) -> None:
    """The .sai of the first n reads: the 64-byte header and n records
    (an int32 count and 16 bytes a hit); `aln` is a read at a time, so it
    equals the .sai of `aln` on the first n reads."""
    raw = sai_path.read_bytes()
    off = 64
    for _ in range(n):
        off += 4 + 16 * int(np.frombuffer(raw, "<i4", 1, off)[0])
    out.write_bytes(raw[:off])


# ---- the commands -----------------------------------------------------------

@contextlib.contextmanager
def stderr_text():
    """Collect what is written to stderr inside the block, by Python
    (sys.stderr) and by the native library (file descriptor 2), into the
    StringIO it yields (Python's text first)."""
    sys.stderr.flush()
    saved = os.dup(2)
    buf = io.StringIO()
    with tempfile.TemporaryFile() as native:
        os.dup2(native.fileno(), 2)
        try:
            with contextlib.redirect_stderr(buf):
                yield buf
        finally:
            os.dup2(saved, 2)
            os.close(saved)
            native.seek(0)
            buf.write(native.read().decode("latin-1"))


def run_cli(cmd: str, args: list[str], out: pathlib.Path,
            env: dict | None = None) -> dict:
    """`ibwa_tpu_torch <cmd> ... -f out` in-process with `env` set for the
    call: {wall, err (its stderr, the native library's too), launches
    (kernel launches it made)}."""
    from . import cli, kernels
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with stderr_text() as err:
            rc = cli.main([cmd, *args, "-f", str(out)])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{cmd} {args} exited {rc}:\n"
                             f"{err.getvalue()[-3000:]}")
    launches = {k: v for k, v in kernels.launches.items() if v}
    LAUNCHES.update(launches)
    return {"wall": wall, "err": err.getvalue(), "launches": launches}


def aln(fa, fq, out: pathlib.Path, route: str, device: str,
        opts: list[str] = ()) -> dict:
    """One `aln` run by route: "native" (--engine native), "device_only"
    (IBWA_HOST_FRAC=0) or "hybrid" (the adaptive host share).  Returns its
    `[aln] stats` with the wall, the launches and the batches."""
    args = [*opts, str(fa), str(fq)]
    if route == "native":
        r = run_cli("aln", args + ["--engine", "native"], out)
    else:
        env = {"IBWA_HOST_FRAC": "0"} if route == "device_only" else {}
        r = run_cli("aln", args + ["--device", device], out, env)
    line = [ln for ln in r["err"].splitlines()
            if ln.startswith("[aln] stats ")]
    if not line:
        raise AssertionError(f"aln printed no stats:\n{r['err'][-2000:]}")
    stats = json.loads(line[-1][len("[aln] stats "):])
    stats.update(wall=r["wall"], launches=r["launches"],
                 n_batches=r["err"].count(" sequences processed"))
    if route != "native":
        check_aln_launches(stats, device)
    return stats


def check_aln_launches(stats: dict, device: str) -> None:
    """On a card a device run launches the width pass and the chunk search
    once a chunk of its device share and nothing else; on the CPU their
    plain versions run and nothing is launched."""
    from .align import engine
    if not device.startswith("cuda"):
        if stats["launches"]:
            raise AssertionError(f"aln on {device} launched "
                                 f"{stats['launches']}")
        return
    chunks = sum(-(-(b["reads"] - b["host_reads"]) // engine.PERSIST_N)
                 for b in stats["batches"])
    if stats["launches"] != dict.fromkeys(ALN_KERNELS, chunks):
        raise AssertionError(f"aln launched {stats['launches']}, not one "
                             f"width pass and one chunk search for each of "
                             f"{chunks} chunks")


def batches_of(n: int, batch: int) -> int:
    return -(-n // batch)


def same_bytes(what: str, got: pathlib.Path, want: pathlib.Path) -> int:
    a, b = got.read_bytes(), want.read_bytes()
    if a != b:
        la, lb = a.split(b"\n"), b.split(b"\n")
        at = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                  min(len(la), len(lb)))
        raise AssertionError(
            f"{what}: {got.name} differs from {want.name} ({len(a)} against "
            f"{len(b)} bytes; first differing line {at}: "
            f"{la[at][:200] if at < len(la) else b''!r} against "
            f"{lb[at][:200] if at < len(lb) else b''!r})")
    return len(a)


def aln_pair(tag: str, fa, fq, work: pathlib.Path, device: str,
             routes=("device_only",), opts: list[str] = ()) -> dict:
    """`aln --engine native` and each device route on one FASTQ; every
    device .sai byte-equal to the native one.  {route: stats}."""
    native = work / f"{tag}.native.sai"
    res = {"native": aln(fa, fq, native, "native", device, opts)}
    for route in routes:
        out = work / f"{tag}.{route}.sai"
        res[route] = aln(fa, fq, out, route, device, opts)
        same_bytes(f"aln {tag} {route}", out, native)
    return res


def aln_summary(st: dict) -> dict:
    """What a report keeps of an aln run."""
    keep = ("reads", "search_s", "wall", "device_reads", "fallback_reads",
            "fallback_by_cause", "host_reads", "launches", "n_batches")
    out = {k: st[k] for k in keep if k in st}
    if "batches" in st:
        out["batches"] = st["batches"]
        out["acap"] = sorted({b["acap"] for b in st["batches"]})
        dev = st["device_reads"] + st["fallback_reads"]
        out["fallback_share"] = st["fallback_reads"] / max(dev, 1)
    return out


PREFILL = ("rows", "waves", "launches", "refused", "host_walks")


def prefill_lines(err: str) -> list[dict]:
    import re
    pat = re.compile(r"\[sai2sam_pe\] prefill (\d+) rows in (\d+) waves, "
                     r"(\d+) launches; (\d+) values refused by the cache, "
                     r"(\d+) host walks since the last batch; ([\d.]+) s")
    return [dict(zip(PREFILL + ("s",), (*map(int, m.groups()[:5]),
                                        float(m.group(6)))))
            for m in pat.finditer(err)]


class WalkRecorder:
    """Records every `DeviceWalker.resolve_intervals` call while active:
    (walker, strand, ks, ls, values, walker.last)."""

    def __init__(self, keep_values: bool):
        self.calls, self.keep = [], keep_values

    def __enter__(self):
        from .fm import walk
        self._orig = orig = walk.DeviceWalker.resolve_intervals
        calls, keep = self.calls, self.keep

        def recorded(walker, strand, ks, ls, **kw):
            off, vals = orig(walker, strand, ks, ls, **kw)
            calls.append((walker, np.array(strand), np.array(ks),
                          np.array(ls), vals.copy() if keep else None,
                          dict(walker.last)))
            return off, vals

        walk.DeviceWalker.resolve_intervals = recorded
        return self

    def __exit__(self, *exc):
        from .fm import walk
        walk.DeviceWalker.resolve_intervals = self._orig


def sampe(args: list[str], out: pathlib.Path, device: str | None,
          n_pairs: int, keep_values: bool = False) -> dict:
    """`sampe -R`: with device None the host walks (--engine native), else
    K5 walks every batch's SA rows on `device`.  The device route must
    prefill every batch (ceil(n_pairs / sampe.BATCH)), leave 0 walks to
    the host and have 0 values refused in each and after the last, and
    on a card launch lf_walk and nothing else, once a wave.  Returns
    {wall, batches (the prefill lines), calls (the walker's), launches}."""
    from .sam import sampe as sampe_mod
    n_batches = batches_of(n_pairs, sampe_mod.BATCH)
    if device is None:
        r = run_cli("sampe", ["-R", "--engine", "native", *args], out)
        if r["launches"] or "prefill" in r["err"]:
            raise AssertionError(f"sampe --engine native launched "
                                 f"{r['launches']} or prefilled")
        r["batches"], r["calls"] = [], []
    else:
        with WalkRecorder(keep_values) as rec:
            r = run_cli("sampe", ["-R", "--device", device, *args], out)
        r["batches"], r["calls"] = prefill_lines(r["err"]), rec.calls
        last = r["err"].count("[sai2sam_pe] 0 host walks after the last "
                              "prefill")
        if len(r["batches"]) != n_batches or last != 1 or any(
                b["rows"] <= 0 or b["refused"] or b["host_walks"]
                for b in r["batches"]):
            raise AssertionError(f"sampe on {device}: not {n_batches} "
                                 f"prefilled batches with 0 refused and 0 "
                                 f"host walks:\n{r['err'][-3000:]}")
        waves = sum(b["waves"] for b in r["batches"])
        want = {"lf_walk": waves} if device.startswith("cuda") else {}
        if r["launches"] != want:
            raise AssertionError(f"sampe on {device} launched "
                                 f"{r['launches']}, not {want}")
    done = r["err"].count(" sequences have been processed.")
    if done != n_batches:
        raise AssertionError(f"sampe ran {done} batches, not {n_batches}")
    return r


def sam_records(sam: pathlib.Path) -> list[list[bytes]]:
    return [ln.split(b"\t") for ln in sam.read_bytes().splitlines()
            if ln[:1] != b"@"]


def sampe_pair(tag: str, args: list[str], work: pathlib.Path, device: str,
               n_pairs: int, keep_values: bool = False) -> dict:
    """`sampe -R` with the host walks and with K5's; SAM byte-equal, every
    pair's two records there, at least half of the records mapped."""
    host, dev = work / f"{tag}.host.sam", work / f"{tag}.k5.sam"
    h = sampe(args, host, None, n_pairs)
    d = sampe(args, dev, device, n_pairs, keep_values)
    size = same_bytes(f"sampe -R {tag}", dev, host)
    recs = sam_records(host)
    mapped = sum(1 for f in recs if not int(f[1]) & 4)
    if len(recs) != 2 * n_pairs or mapped < n_pairs:
        raise AssertionError(f"sampe {tag}: {len(recs)} records, {mapped} "
                             f"mapped, for {n_pairs} pairs")
    zr = sum(1 for f in recs if any(x.startswith(b"ZR:Z:") for x in f[11:]))
    # records whose CIGAR the alternate's remap CIGAR could not translate
    # (translate_cigar's refusals, written "{len}M" as the reference does)
    refused = [r["err"].count("Error translating cigar string")
               for r in (h, d)]
    if refused[0] != refused[1]:
        raise AssertionError(f"sampe {tag}: the remap refused {refused[0]} "
                             f"CIGARs with the host walks, {refused[1]} "
                             f"with K5's")
    return {"host_s": h["wall"], "k5_s": d["wall"], "bytes": size,
            "records": len(recs), "mapped": mapped, "zr_tags": zr,
            "untranslated_cigars": refused[0],
            "batches": d["batches"], "launches": d["launches"],
            "_calls": d["calls"]}


def spread(values) -> dict:
    v = sorted(values)
    return {"median": statistics.median(v), "min": v[0], "max": v[-1],
            "readings": len(v)}


# ---- the configurations -----------------------------------------------------

def ecoli_seam(sc: Scale, work: pathlib.Path, device: str, say) -> dict:
    """`aln` device-only, hybrid and native on both ends across the
    0x40000 seam; `sampe -R` K5 against the host walks; `samse` on mate
    1."""
    from .align import pipeline
    from .sam import bwase
    fa, fqs = pairs_inputs(
        work, "ecoli", 20260817,
        lambda rng: random_seq(rng, sc.ecoli_len), "U00096", sc.ecoli_pairs,
        say)
    n = sc.ecoli_pairs
    want_b = batches_of(n, pipeline.BATCH_SIZE)
    ends, sais = [], []
    for e, fq in enumerate(fqs, 1):
        res = aln_pair(f"end{e}", fa, fq, work, device,
                       ("device_only", "hybrid"))
        for route, st in res.items():
            if st["n_batches"] != want_b or st["reads"] != n:
                raise AssertionError(f"aln {route} end {e}: "
                                     f"{st['n_batches']} batches of "
                                     f"{st['reads']} reads, not {want_b}")
        shares = [round(b["host_share"], 4) for b in res["hybrid"]["batches"]]
        say(f"ecoli_seam end {e}: .sai byte-equal to native, device-only "
            f"and hybrid, {want_b} batches; hybrid's host share a batch "
            f"{shares}; fallback device-only "
            f"{res['device_only']['fallback_reads']}")
        ends.append({r: aln_summary(st) for r, st in res.items()})
        sais.append(work / f"end{e}.native.sai")
    # the process's peak so far: aln holds every read of a file at once
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    args = [str(fa), *map(str, sais), *map(str, fqs)]
    pe = sampe_pair("pairs", args, work, device, n)
    out = work / "end1.samse.sam"
    r = run_cli("samse", [str(fa), str(sais[0]), str(fqs[0])], out)
    names = [f[0] for f in sam_records(out)]
    if names != fastq_records(fqs[0]):
        raise AssertionError(f"samse: {len(names)} records, not one a read "
                             f"of {n} in read order")
    se_b = sum(1 for ln in r["err"].splitlines()
               if ln.startswith("[samse] ")
               and ln.endswith(" sequences processed"))
    if se_b != batches_of(n, bwase.BATCH) or r["launches"]:
        raise AssertionError(f"samse ran {se_b} batches, launched "
                             f"{r['launches']}")
    say(f"ecoli_seam: sampe -R SAM byte-equal, K5's walks and the host "
        f"walks, {len(pe['batches'])} batches, 0 host walks, 0 refused "
        f"(rows {[b['rows'] for b in pe['batches']]}); samse {len(names)} "
        f"records in read order, {se_b} batches; peak host RSS {rss:.0f} MB")
    return {"aln": ends, "sampe": pe, "samse": {
        "records": len(names), "batches": se_b, "wall": r["wall"]},
        "peak_rss_mb": rss}


def repeat_pe(sc: Scale, work: pathlib.Path, device: str, say) -> dict:
    """`aln` device-only against native on both ends; `sampe -R` K5
    against the host walks on wide intervals; K5 in waves of
    sc.wave_rows bitwise equal to the run's values."""
    from . import kernels
    fa, fqs = pairs_inputs(
        work, "repeats", 777333,
        lambda rng: make_repeat_rich(rng, sc.repeat_len, sc.tandem_copies,
                                     sc.segdups), "rep1", sc.repeat_pairs,
        say)
    ends, sais = [], []
    for e, fq in enumerate(fqs, 1):
        res = aln_pair(f"end{e}", fa, fq, work, device)
        ends.append({r: aln_summary(st) for r, st in res.items()})
        sais.append(work / f"end{e}.native.sai")
    args = [str(fa), *map(str, sais), *map(str, fqs)]
    pe = sampe_pair("pairs", args, work, device, sc.repeat_pairs,
                    keep_values=True)
    waves = []
    for walker, strand, ks, ls, vals, last in pe["_calls"]:
        before = dict(kernels.launches)
        _, got = walker.resolve_intervals(strand, ks, ls,
                                          wave_rows=sc.wave_rows)
        w = dict(walker.last)
        if w["waves"] < 2 or not np.array_equal(got, vals):
            raise AssertionError(f"K5 in {w['waves']} waves of "
                                 f"{sc.wave_rows} rows differs from the "
                                 f"run's {last['waves']} wave(s)")
        # a check's launches are not the path's
        kernels.launches.clear()
        kernels.launches.update(before)
        waves.append({"rows": w["rows"], "waves": w["waves"],
                      "launches": w["launches"], "run_waves": last["waves"],
                      "longest": last["longest"], "steps": last["steps"]})
    say(f"repeat_pe: .sai byte-equal to native on both ends; sampe -R SAM "
        f"byte-equal, K5 against the host walks (host {pe['host_s']:.1f} s, "
        f"K5 {pe['k5_s']:.1f} s); prefill {pe['batches']}; K5 in waves of "
        f"{sc.wave_rows} rows bitwise equal to the run's: {waves}")
    return {"aln": ends, "sampe": pe, "wave_check": waves}


def iterative_remap(sc: Scale, work: pathlib.Path, device: str, say
                    ) -> dict:
    """`aln` of both ends against both dbs, device-only against native;
    `sampe -R` over the two dbs, K5 against the host walks (ZR tags, one
    walker a db in DbSet order); the rates in three rounds in turns."""
    from .sam import sampe as sampe_mod
    p = remap_inputs(work, sc, say)
    dbs = {"primary": p["primary"], "alt": p["alt"]}
    lens = {db: fasta_len(fa) for db, fa in dbs.items()}
    ends, sais = {}, {}
    for db, fa in dbs.items():
        for e, fq in enumerate(p["fq"], 1):
            res = aln_pair(f"{db}{e}", fa, fq, work, device)
            ends[f"{db}{e}"] = {r: aln_summary(st) for r, st in res.items()}
            sais[db, e] = work / f"{db}{e}.native.sai"
    alt_acap = {a for e in (1, 2)
                for a in ends[f"alt{e}"]["device_only"]["acap"]}
    if alt_acap != {1024}:
        raise AssertionError(f"aln against the {lens['alt']} bp alternate "
                             f"took ACAP {alt_acap}, not 1024")

    def sampe_args(sai_of, fqs):
        # <primary> <1.sai> <2.sai> <1.fq> <2.fq> <alt> <1.sai> <2.sai>
        args = []
        for db, fa in dbs.items():
            args += [str(fa), str(sai_of(db, 1)), str(sai_of(db, 2))]
            if db == "primary":
                args += map(str, fqs)
        return args

    n = sc.remap_pairs
    pe = sampe_pair("remap", sampe_args(lambda db, e: sais[db, e], p["fq"]),
                    work, device, n)
    if pe["zr_tags"] <= 0:
        raise AssertionError("sampe -R over two dbs wrote no ZR tag")
    n_b = batches_of(n, sampe_mod.BATCH)
    order = [c[0].fm.seq_len for c in pe["_calls"]]
    if order != [lens["primary"], lens["alt"]] * n_b:
        raise AssertionError(f"the walkers ran on tables of {order} bases, "
                             f"not one a db in DbSet order a batch")
    waves = sum(c[5]["waves"] for c in pe["_calls"])
    if device.startswith("cuda") and pe["launches"] != {"lf_walk": waves}:
        raise AssertionError(f"lf_walk launched {pe['launches']}, not once "
                             f"a db, batch and wave ({waves})")

    # the rates: the first rate_pairs pairs, ROUNDS rounds in turns
    m = sc.rate_pairs
    sub_fq = [work / f"rate_{e}.fq" for e in (1, 2)]
    for fq, out in zip(p["fq"], sub_fq):
        first_reads(fq, m, out)
    for (db, e), sai in sais.items():
        head_sai(sai, m, work / f"rate_{db}{e}.sai")
    args = sampe_args(lambda db, e: work / f"rate_{db}{e}.sai", sub_fq)
    walls, want = {"host": [], "k5": []}, None
    for r in range(ROUNDS):
        for route in ("host", "k5") if r % 2 == 0 else ("k5", "host"):
            out = work / f"rate.{route}.sam"
            walls[route].append(sampe(args, out, None if route == "host"
                                      else device, m)["wall"])
        got = {route: (work / f"rate.{route}.sam").read_bytes()
               for route in walls}
        if got["k5"] != got["host"] or want not in (None, got["host"]):
            raise AssertionError(f"round {r}: the rate runs' SAM differ")
        want = got["host"]
    rates = {route: spread([2 * m / w for w in ws])
             for route, ws in walls.items()}
    say(f"iterative_remap: 4 .sai byte-equal to native (alternate at ACAP "
        f"1024); sampe -R over 2 dbs SAM byte-equal, {pe['zr_tags']} ZR "
        f"tags, {pe['mapped']} of {pe['records']} records mapped, "
        f"{pe['untranslated_cigars']} CIGARs the remap could not translate "
        f"(in both routes); walkers "
        f"in DbSet order, {len(pe['_calls'])} calls, lf_walk "
        f"{pe['launches']}; reads/s on the first {m} pairs, {ROUNDS} rounds "
        f"in turns: K5 {rates['k5']}, host walks {rates['host']}")
    return {"aln": ends, "sampe": pe, "rates": rates}


def aln_options(sc: Scale, work: pathlib.Path, device: str, say) -> dict:
    """Device-only against native under the five option sets on mate 1
    of the first pairs, and under the default on mixed lengths."""
    p = remap_inputs(work.parent / "iterative_remap", sc, say)
    fa = p["primary"]
    fq = work / "mate1.fq"
    first_reads(p["fq"][0], min(sc.option_reads, sc.remap_pairs), fq)
    mixed = work / "mixed.fq"
    if not mixed.exists():
        genome = np.frombuffer(b"".join(
            ln.rstrip(b"\n") for ln in open(fa, "rb") if ln[:1] != b">"),
            dtype=np.uint8)
        write_fastq(mixed, b"m", sim_mixed(np.random.default_rng(
            [20261102, 1]), genome, sc.mixed_reads))
    runs = {}
    for name, opts in [*OPTION_SETS.items(), ("mixed", [])]:
        res = aln_pair(name, fa, mixed if name == "mixed" else fq, work,
                       device, opts=opts)
        runs[name] = s = aln_summary(res["device_only"])
        s["native_search_s"] = res["native"]["search_s"]
        if name in WIDE_ARENA and s["acap"] != [1024]:
            raise AssertionError(f"aln {name} took ACAP {s['acap']}")
        say(f"aln_options {name} {' '.join(opts)}: .sai byte-equal to "
            f"native; ACAP {s['acap']}, launches {s['launches']}, fallback "
            f"share {s['fallback_share']:.4f}, search_s device-only "
            f"{s['search_s']:.3f}, native {s['native_search_s']:.3f}")
    return {"runs": runs, "_paths": {"fa": fa, "fq": fq, "mixed": mixed}}


RUNNERS = {"ecoli_seam": ecoli_seam, "repeat_pe": repeat_pe,
           "iterative_remap": iterative_remap, "aln_options": aln_options}


def run(configs=CONFIGS, device: str = "cuda", scale: str = "full",
        work: pathlib.Path = WORK, report=None, say=log) -> list[dict]:
    """Run the configurations in order, each line of progress through
    say(); each result (its private keys, those starting with "_", kept
    for the caller) is also passed to report(its public JSON line) as it
    ends.  A result's `launches` are the kernel launches of its commands.
    Raises on the first inequality."""
    sc = SCALES[scale]
    results = []
    for name in configs:
        d = pathlib.Path(work) / scale / name
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        LAUNCHES.clear()
        res = {"config": name, "scale": scale, "device": device,
               "equal": True, **RUNNERS[name](sc, d, device, say)}
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = dict(LAUNCHES)
        results.append(res)
        if report is not None:
            report(json.dumps(public(res)))
    return results


def public(res):
    """A result without its private keys (walkers, paths), for JSON."""
    if isinstance(res, dict):
        return {k: public(v) for k, v in res.items()
                if not str(k).startswith("_")}
    if isinstance(res, (list, tuple)):
        return [public(v) for v in res]
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.parity_scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the device routes (cuda, cuda:N, cpu)")
    ap.add_argument("--config", nargs="+", choices=CONFIGS,
                    default=list(CONFIGS))
    ap.add_argument("--scale", choices=sorted(SCALES), default="full")
    ap.add_argument("--json", action="store_true",
                    help="print each configuration's JSON line on stdout")
    ap.add_argument("--work", default=str(WORK),
                    help="directory of the cached inputs and the outputs")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("[parity_scale] no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 2
    run(args.config, args.device, args.scale, pathlib.Path(args.work),
        report=(lambda line: print(line, flush=True)) if args.json else log)
    log(f"every configuration equal: {', '.join(args.config)} "
        f"({args.scale}, {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
