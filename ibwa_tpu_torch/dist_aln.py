"""`aln` as several processes over FASTQ shards: the counterpart of
`scripts/dist_aln.py`.

That script splits `aln` into per-process FASTQ shards, the reference's
file contract (bwtaln.c:192, saiset.c:28) lifted to processes: each
process aligns its contiguous shard through the production pipeline
(`align/pipeline.py::aln_to_stream`) and writes its own `.sai`, and the
parent byte-compares shard 0 followed by the records of the other shards
(their 64-byte gap_opt_t header cut) against one process over the whole
FASTQ.  Here each worker runs the port's pipeline with the torch engine,
device-only (IBWA_HOST_FRAC=0, as the script pins it), on card
`devices[i % len(devices)]`: on a machine with one card every worker
shares `cuda:0`, the card time-slicing their contexts.

Inputs are the script's, byte for byte: the E. coli-scale genome and the
single-end reads of `scripts/parity_scale.py`, drawn in its order from
`random.Random(20260817)` (genome, then the pairs, which are not aligned
here but are drawn all the same, then the single-end reads), cached
under `.bench/dist_aln_torch/<N>/` and indexed by the port.

The parent
  * builds the kernel and native libraries once, before any worker
    starts (P builds would race to the same file);
  * starts P workers (`python -m ibwa_tpu_torch.dist_aln --worker I ...`:
    a new interpreter, never a fork, which a CUDA context does not
    survive), each with OMP_NUM_THREADS = cpu_count // P so that P native
    fallbacks do not each take every core;
  * waits for every worker's `ready` (its CUDA context made and the kernel
    library loaded), sends `go` and times go to the last worker's exit:
    the index load, the reads, the search and the `.sai` are inside that
    window, the interpreter's start and `import torch` are not;
  * runs the same worker alone over the whole FASTQ (the one-process
    run), merges the shards and byte-compares; and compares the
    one-process `.sai` with `--engine native`'s, the port's oracle.

    python -m ibwa_tpu_torch.dist_aln [--reads N] [--procs P]
        [--device cuda|cuda:0|cuda:0,cuda:1|cpu] [--sweep] [--rounds R]
        [--json] [--work DIR]

The record (last line of stdout with --json) keeps the script's keys
(`wall_s_2proc` is the P-process wall) and adds `device` (nvidia-smi's
name and power limit), `aggregate_reads_per_s` (reads / the P-process
wall), `aggregate_reads_per_s_1proc` and `native_sai_identical`.  Each
worker's record adds to the script's its `[aln] stats` counters, its
kernel launches (one width pass and one chunk search a chunk on a card,
checked by the worker) and its peak device memory.

`--sweep` runs P = 1, 2 and 4 on one card over 262,144 reads (one `aln`
batch in one process), device-only, R rounds in turns (1, 2, 4, 1, 2, 4,
...), every merged `.sai` byte-equal to the first one-process run's, then
one round with the adaptive host share; it reports the median and range
of the aggregate rate for each P and, on a card, `nvidia-smi`'s
utilization.gpu sampled during each run (a sample of the driver's own
counter, not a busy share: neither the profiler nor CUDA events see
across processes).

A worker that fails, a missing `ready` or any inequality exits 1; a
`cuda` device on a machine without one raises.  Nothing falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import random
import select
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
WORK = REPO / ".bench" / "dist_aln_torch"
SEED = 20260817            # scripts/parity_scale.py:238
GENOME_LEN = 4_600_000     # scripts/parity_scale.py:44
READS = 40_000             # scripts/dist_aln.py:104, the parity corpus
PROCS = 2                  # scripts/dist_aln.py:47
SWEEP_READS = 0x40000      # one aln batch (pipeline.BATCH_SIZE)
SWEEP_PROCS = (1, 2, 4)
ROUNDS = 3
READY_S = 600.0            # a worker's start, import and CUDA context
SAMPLE_MS = 100            # nvidia-smi's loop while a run is timed
DEVICE_ONLY = {"IBWA_HOST_FRAC": "0"}   # the script's pin (:120)


def log(msg: str) -> None:
    print(f"[dist_aln] {msg}", file=sys.stderr, flush=True)


class WorkerError(RuntimeError):
    """A worker exited non-zero, or never said `ready`."""


# ---- the inputs: scripts/parity_scale.py's recipe ---------------------------

def write_fa(path, contigs):
    """scripts/parity_scale.py::write_fa, unchanged."""
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")


def make_ecoli(rng, n: int = GENOME_LEN):
    """scripts/parity_scale.py::make_ecoli with its length an argument (the
    script's 4,600,000 by default)."""
    return "".join(rng.choice("ACGT") for _ in range(n))


def sim_reads(path_prefix, seq, n, rng, read_len=100, err=0.01,
              paired=True, isize_mean=300, isize_sd=40):
    """scripts/parity_scale.py::sim_reads, unchanged."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}

    def mut(s):
        return "".join(c if rng.random() > err else rng.choice("ACGT")
                       for c in s)

    if paired:
        f1 = open(f"{path_prefix}_1.fq", "w")
        f2 = open(f"{path_prefix}_2.fq", "w")
        for i in range(n):
            isz = max(2 * read_len + 10,
                      int(rng.gauss(isize_mean, isize_sd)))
            pos = rng.randrange(0, len(seq) - isz)
            frag = seq[pos:pos + isz]
            a = frag[:read_len]
            b = "".join(comp[c] for c in reversed(frag[-read_len:]))
            f1.write(f"@s{i}\n{mut(a)}\n+\n{'I' * read_len}\n")
            f2.write(f"@s{i}\n{mut(b)}\n+\n{'I' * read_len}\n")
        f1.close()
        f2.close()
        return [f"{path_prefix}_1.fq", f"{path_prefix}_2.fq"]
    with open(f"{path_prefix}.fq", "w") as f:
        for i in range(n):
            pos = rng.randrange(0, len(seq) - read_len)
            s = mut(seq[pos:pos + read_len])
            if rng.random() < 0.5:
                s = "".join(comp[c] for c in reversed(s))
            f.write(f"@s{i}\n{s}\n+\n{'I' * read_len}\n")
    return [f"{path_prefix}.fq"]


def write_inputs(d: pathlib.Path, n_reads: int,
                 genome_len: int = GENOME_LEN) -> tuple[pathlib.Path,
                                                        pathlib.Path]:
    """The genome and the single-end reads in the script's order
    (scripts/parity_scale.py:238-264): (fasta, fastq)."""
    d.mkdir(parents=True, exist_ok=True)
    rng = random.Random(SEED)
    fa = d / "ecoli.fa"
    write_fa(fa, [("U00096", make_ecoli(rng, genome_len))])
    with open(fa) as f:
        seq = "".join(ln.strip() for ln in f.readlines()[1:])
    sim_reads(str(d / f"ecoli_pe{n_reads}"), seq, n_reads, rng)
    sim_reads(str(d / f"ecoli_se{n_reads}"), seq, n_reads, rng,
              paired=False)
    return fa, d / f"ecoli_se{n_reads}.fq"


def ensure_inputs(work: pathlib.Path, n_reads: int,
                  genome_len: int = GENOME_LEN, say=log) -> dict:
    """The inputs of N reads under work/<N>/, made and indexed once:
    {fa, fq, genome_len}.  `inputs.json`, written last, marks them done
    and keeps the genome's length they were made at."""
    from . import parity_scale
    d = work / str(n_reads)
    done = d / "inputs.json"
    if not done.exists():
        t0 = time.perf_counter()
        fa, _ = write_inputs(d, n_reads, genome_len)
        parity_scale.index(fa)
        done.write_text(json.dumps({"genome_len": genome_len,
                                    "reads": n_reads}))
        say(f"made and indexed a {genome_len} bp genome and {n_reads} reads "
            f"in {time.perf_counter() - t0:.1f} s")
    meta = json.loads(done.read_text())
    return {"fa": d / "ecoli.fa", "fq": d / f"ecoli_se{n_reads}.fq",
            "genome_len": meta["genome_len"]}


def split_fastq(src: pathlib.Path, n_shards: int,
                out: pathlib.Path) -> list[pathlib.Path]:
    """scripts/dist_aln.py::split_fastq: n_shards contiguous shards of equal
    read counts, out/shard{i}.fq.  A count that n_shards does not divide is
    refused."""
    lines = src.read_bytes().split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    if len(lines) % 4:
        raise ValueError(f"{src}: {len(lines)} lines is not whole records")
    n = len(lines) // 4
    per = n // n_shards
    if per * n_shards != n:
        raise ValueError(f"{n} reads do not split into {n_shards} equal "
                         f"shards")
    out.mkdir(parents=True, exist_ok=True)
    shards = []
    for s in range(n_shards):
        p = out / f"shard{s}.fq"
        with open(p, "wb") as f:
            f.write(b"\n".join(lines[s * per * 4:(s + 1) * per * 4]))
            f.write(b"\n")
        shards.append(p)
    return shards


def merge_sai(parts: list[pathlib.Path]) -> bytes | None:
    """Shard 0's .sai, then the records of the others (each header cut with
    io/sai.py::read_header); None when a shard's header differs from shard
    0's."""
    from .io import sai
    blobs = [p.read_bytes() for p in parts]
    fp = io.BytesIO(blobs[0])
    sai.read_header(fp)
    hdr = fp.tell()
    if any(b[:hdr] != blobs[0][:hdr] for b in blobs[1:]):
        return None
    return blobs[0] + b"".join(b[hdr:] for b in blobs[1:])


# ---- the worker -------------------------------------------------------------

def worker(pid: int, prefix: str, fq: str, out: str, device: str) -> dict:
    """One shard through `aln_to_stream` (the torch engine on `device`),
    after the CUDA context and the kernel library are ready and the
    parent's `go` came.  Returns the worker's record."""
    import torch
    from . import kernels, native, parity_scale
    from .align import engine
    from .align.opts import GapOpt
    from .align.pipeline import aln_to_stream
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        kernels.lib()
    native.load()
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        raise WorkerError(f"worker {pid}: no go from the parent")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with open(out, "wb") as f, contextlib.redirect_stderr(err):
            n = aln_to_stream(prefix, fq, GapOpt(), f, engine="torch",
                              device=device)
    finally:
        sys.stderr.write(err.getvalue())
    dt = time.perf_counter() - t0
    line = [ln for ln in err.getvalue().splitlines()
            if ln.startswith("[aln] stats ")]
    stats = json.loads(line[-1][len("[aln] stats "):])
    stats["launches"] = dict(kernels.launches)
    parity_scale.check_aln_launches(stats, device)
    chunks = sum(-(-(b["reads"] - b["host_reads"]) // engine.PERSIST_N)
                 for b in stats["batches"])
    return {"pid": pid, "reads": n, "seconds": dt, "reads_per_s": n / dt,
            "search_s": stats["search_s"],
            "device_reads": stats["device_reads"],
            "fallback_reads": stats["fallback_reads"],
            "fallback_by_cause": stats["fallback_by_cause"],
            "host_reads": stats["host_reads"],
            "host_threads": stats["host_threads"],
            "host_share": [b["host_share"] for b in stats["batches"]],
            "chunks": chunks, "launches": stats["launches"],
            "device": str(dev),
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)}


# ---- the parent -------------------------------------------------------------

def resolve_devices(spec: str) -> list[str]:
    """The devices `spec` names (engine.devices_of: "cuda" is every visible
    card); raises when it names a card and there is none."""
    import torch
    from .align import engine
    if "cuda" in spec and not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec}: no CUDA device is visible")
    return [str(d) for d in engine.devices_of(spec)]


def build_libraries(devices: list[str]) -> None:
    """The native library, and the kernel library when a worker runs on a
    card, built here once so that the workers only load them."""
    from . import kernels, native
    native.load()
    if any(d.startswith("cuda") for d in devices):
        kernels.lib()


@contextlib.contextmanager
def gpu_samples(devices: list[str]):
    """nvidia-smi's utilization.gpu of the first card named, every
    SAMPLE_MS while the block runs, into the list it yields (empty when no
    card is named)."""
    samples: list[int] = []
    cards = [d for d in devices if d.startswith("cuda")]
    if not cards:
        yield samples
        return
    import torch
    index = torch.device(cards[0]).index or 0
    p = subprocess.Popen(
        ["nvidia-smi", f"--id={index}", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", f"--loop-ms={SAMPLE_MS}"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield samples
    finally:
        p.terminate()
        text, _ = p.communicate(timeout=30)
        samples.extend(int(x) for x in text.split() if x.isdigit())


def _tail(path: pathlib.Path, n: int = 3000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def run_procs(prefix: pathlib.Path, shards: list[pathlib.Path],
              devices: list[str], env: dict) -> dict:
    """One worker a shard (worker i on devices[i % len(devices)]), each
    writing shard{i}.sai and shard{i}.err beside its FASTQ; every `ready`
    awaited, then `go`, timed to the last exit.  {wall, per_process,
    gpu_util}.  Raises WorkerError on a failure; every worker still
    running is killed on the way out."""
    P = len(shards)
    base = {k: v for k, v in os.environ.items() if k != "IBWA_HOST_FRAC"}
    base.update(env, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // P)))
    procs, errs = [], []
    try:
        for i, fq in enumerate(shards):
            err = fq.with_suffix(".err")
            errs.append(err)
            with open(err, "w") as ef:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ibwa_tpu_torch.dist_aln",
                     "--worker", str(i), "--prefix", str(prefix),
                     "--fq", str(fq), "--out", str(fq.with_suffix(".sai")),
                     "--device", devices[i % len(devices)]],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=ef, text=True, cwd=REPO, env=base))
        deadline = time.monotonic() + READY_S
        for i, p in enumerate(procs):
            ready, _, _ = select.select(
                [p.stdout], [], [], max(0.0, deadline - time.monotonic()))
            line = p.stdout.readline() if ready else ""
            if line.strip() != "ready":
                raise WorkerError(
                    f"worker {i} did not say ready ({line.strip()!r}, rc "
                    f"{p.poll()}):\n{_tail(errs[i])}")
        with gpu_samples(devices) as util:
            t0 = time.perf_counter()
            for p in procs:
                p.stdin.write("go\n")
                p.stdin.close()
            outs = [p.stdout.read() for p in procs]
            rcs = [p.wait() for p in procs]
            wall = time.perf_counter() - t0
        recs = []
        for i, (out, rc) in enumerate(zip(outs, rcs)):
            if rc != 0 or not out.strip():
                raise WorkerError(f"worker {i} exited {rc}:\n"
                                  f"{_tail(errs[i])}")
            recs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in (p.stdin, p.stdout):
                if f and not f.closed:
                    f.close()
    return {"wall": wall, "per_process": recs, "gpu_util": util}


def run_split(inp: dict, shards: list[pathlib.Path], devices: list[str],
              env: dict) -> dict:
    """`run_procs` over the shards, then their merged .sai (None when the
    headers differ) in `merged`."""
    res = run_procs(inp["fa"], shards, devices, env)
    res["merged"] = merge_sai([s.with_suffix(".sai") for s in shards])
    res["aggregate_reads_per_s"] = \
        sum(r["reads"] for r in res["per_process"]) / res["wall"]
    return res


def native_sai(inp: dict, out: pathlib.Path) -> tuple[bytes, float]:
    """`aln --engine native` over the whole FASTQ in this process: its .sai
    and wall."""
    from . import parity_scale
    from .align.opts import GapOpt
    from .align.pipeline import aln_to_stream
    t0 = time.perf_counter()
    with open(out, "wb") as f, parity_scale.stderr_text():
        aln_to_stream(str(inp["fa"]), str(inp["fq"]), GapOpt(), f,
                      engine="native")
    return out.read_bytes(), time.perf_counter() - t0


def util_summary(util: list[int]) -> dict | None:
    from .parity_scale import spread
    return {**spread(util), "sample_ms": SAMPLE_MS} if util else None


def dist_run(inp: dict, n_reads: int, n_procs: int, devices: list[str],
             card: str, d: pathlib.Path, say=log) -> dict:
    """The script's run: P workers over P shards, one worker over the
    whole FASTQ, the merge and the native .sai.  Returns the record."""
    from . import native
    split = run_split(inp, split_fastq(inp["fq"], n_procs, d / f"p{n_procs}"),
                      devices, DEVICE_ONLY)
    say(f"{n_procs} processes on {devices}: {split['wall']:.3f} s, "
        f"{split['aggregate_reads_per_s']:.1f} reads/s")
    single = run_split(inp, split_fastq(inp["fq"], 1, d / "p1"), devices,
                       DEVICE_ONLY)
    say(f"one process: {single['wall']:.3f} s, "
        f"{single['aggregate_reads_per_s']:.1f} reads/s")
    (d / f"p{n_procs}" / "merged.sai").write_bytes(split["merged"] or b"")
    merged_ok = split["merged"] == single["merged"]
    ref, native_s = native_sai(inp, d / "native.sai")
    native_ok = single["merged"] == ref
    return {"ok": merged_ok and native_ok, "reads": n_reads,
            "n_processes": n_procs,
            "devices": [devices[i % len(devices)] for i in range(n_procs)],
            "merged_sai_identical": merged_ok,
            "native_sai_identical": native_ok,
            "wall_s_2proc": split["wall"], "wall_s_1proc": single["wall"],
            "wall_s_native": native_s,
            "native_host_threads": native.get_threads(),
            "aggregate_reads_per_s": split["aggregate_reads_per_s"],
            "aggregate_reads_per_s_1proc": single["aggregate_reads_per_s"],
            "per_process": split["per_process"],
            "single_process": single["per_process"][0],
            "gpu_util": util_summary(split["gpu_util"]),
            "gpu_util_1proc": util_summary(single["gpu_util"]),
            "device": card, "genome_len": inp["genome_len"],
            "cpu_count": os.cpu_count()}


def sweep(inp: dict, n_reads: int, rounds: int, devices: list[str],
          card: str, d: pathlib.Path, say=log) -> dict:
    """P in SWEEP_PROCS on `devices`, device-only, `rounds` rounds in turns,
    then one round with the adaptive host share; every merged .sai equal to
    the first one-process run's and that to native's."""
    shards = {P: split_fastq(inp["fq"], P, d / f"sweep_p{P}")
              for P in SWEEP_PROCS}
    ref, runs, equal = None, [], True
    plan = [(r, P, "device_only") for r in range(rounds)
            for P in SWEEP_PROCS]
    plan += [(rounds, P, "adaptive") for P in SWEEP_PROCS]
    for r, P, share in plan:
        res = run_split(inp, shards[P], devices,
                        DEVICE_ONLY if share == "device_only" else {})
        if ref is None:
            ref = res["merged"]
        same = res["merged"] is not None and res["merged"] == ref
        equal &= same
        per = res["per_process"]
        runs.append({"round": r, "procs": P, "share": share,
                     "wall": res["wall"],
                     "aggregate_reads_per_s": res["aggregate_reads_per_s"],
                     "merged_sai_identical": same,
                     "gpu_util": util_summary(res["gpu_util"]),
                     "per_process": per})
        say(f"round {r} {share}, {P} processes: {res['wall']:.3f} s, "
            f"{res['aggregate_reads_per_s']:.1f} reads/s, merged .sai "
            f"{'equal' if same else 'DIFFERENT'}; search_s "
            f"{[round(x['search_s'], 3) for x in per]}, fallback "
            f"{[x['fallback_reads'] for x in per]}, peak device bytes "
            f"{[x['peak_mem_bytes'] for x in per]}, utilization.gpu "
            f"{runs[-1]['gpu_util']}")
    native, _ = native_sai(inp, d / "native.sai")
    native_ok = ref == native
    from .parity_scale import spread
    rates = {share: {str(P): spread([x["aggregate_reads_per_s"]
                                     for x in runs if x["procs"] == P
                                     and x["share"] == share])
                     for P in SWEEP_PROCS}
             for share in ("device_only", "adaptive")}
    return {"ok": equal and native_ok, "sweep": True, "reads": n_reads,
            "procs": list(SWEEP_PROCS), "rounds": rounds,
            "devices": devices, "merged_sai_identical": equal,
            "native_sai_identical": native_ok, "rates": rates,
            "runs": runs, "device": card, "genome_len": inp["genome_len"],
            "cpu_count": os.cpu_count()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.dist_aln",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=None,
                    help=f"reads of the corpus [{READS}; {SWEEP_READS} with "
                         f"--sweep]")
    ap.add_argument("--procs", type=int, default=PROCS,
                    help="worker processes (at least 2; --sweep runs "
                         f"{', '.join(map(str, SWEEP_PROCS))})")
    ap.add_argument("--device", default="cuda",
                    help="the workers' devices, worker i on entry i mod "
                         "their count (cuda: every visible card; cpu)")
    ap.add_argument("--sweep", action="store_true",
                    help=f"P in {SWEEP_PROCS} on one card, in rounds")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="rounds of the sweep, in turns (at least 1)")
    ap.add_argument("--json", action="store_true",
                    help="print the record as the last line of stdout")
    ap.add_argument("--work", default=str(WORK),
                    help="directory of the cached inputs and the outputs")
    # a worker, started by the parent
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--prefix", help=argparse.SUPPRESS)
    ap.add_argument("--fq", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        rec = worker(args.worker, args.prefix, args.fq, args.out,
                     args.device)
        print(json.dumps(rec), flush=True)
        return 0
    if args.procs < 2:
        ap.error(f"--procs must be at least 2, not {args.procs}")
    if args.rounds < 1:
        ap.error(f"--rounds must be at least 1, not {args.rounds}")
    devices = resolve_devices(args.device)
    from .bench import card_of
    card = card_of(devices[0])
    n_reads = args.reads or (SWEEP_READS if args.sweep else READS)

    def say(msg: str) -> None:
        log(f"{card}: {msg}")

    build_libraries(devices)
    inp = ensure_inputs(pathlib.Path(args.work), n_reads, say=say)
    d = pathlib.Path(args.work) / str(n_reads)
    try:
        if args.sweep:
            rec = sweep(inp, n_reads, args.rounds, devices, card, d, say)
        else:
            rec = dist_run(inp, n_reads, args.procs, devices, card, d, say)
    except WorkerError as e:
        say(f"a worker failed: {e}")
        return 1
    say(f"merged .sai {'equal' if rec['merged_sai_identical'] else 'DIFFERS'}"
        f" to one process; one process "
        f"{'equal' if rec['native_sai_identical'] else 'DIFFERS'} to "
        f"--engine native")
    if args.json:
        print(json.dumps(rec), flush=True)
    else:
        say(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
