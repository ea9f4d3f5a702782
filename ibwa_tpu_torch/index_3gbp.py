"""Bounded-memory indexing of a large genome, and `aln` / `sampe -R` on its
table: the counterpart of `scripts/index_3gbp.py`.

That script generates a 3.1 Gbp synthetic FASTA (32 contigs chr1..chr32,
a 300 bp element repeated in 8% of the blocks, otherwise random blocks of
20-200 kbp, 70-column lines, `RandomState(20260817)`), indexes it and
reports the index's wall time, peak RSS and artifact sizes, failing above
16 GB.  Here the same FASTA (byte-equal at the same `--gbp`) is indexed
through the port's `cli.main(["index", fa])` in a child process that
reports its own peak RSS (`RUSAGE_SELF`: not this process's, not the g++
build's), and the report names the path the builder took (frugal
packed-text SA-IS from IBWA_FRUGAL_MIN bytes of FASTA on, default
2^31 - 2, `index/builder.py:294`; SA-IS below).

`--align` then runs the large-table configuration on the index, every
command through the port's `cli.main`, every device route byte-equal to
`--engine native` (the first inequality raises):

  aln      both ends of `--pairs` simulated pairs (`parity_scale.sim_pairs`:
           100 bp, insert gauss(300, 40) >= 210, 1% substitutions, mate 2
           reverse-complemented; contigs drawn by length) device-only
           (IBWA_HOST_FRAC=0), hybrid and native: .sai byte-equal, one
           width pass and one chunk search launch a chunk, the fallback
           share and the arena size (ACAP) reported
  rates    end 1, device-only, hybrid and native, ROUNDS rounds in turns:
           reads/s of search wall, median and range
  sampe -R with K5's walks (`--device`) against the host walks: SAM
           byte-equal, 0 host walks and 0 refused values in each batch,
           records mapped on several contigs; the walker's calls are kept
           for the caller (`chip_smoke.py` 4h holds K5 on them)
  memory   the block table's and the sampled arrays' bytes and the
           seconds to load, build and upload them, apart from the index;
           `torch.cuda.max_memory_allocated` of the aln and the sampe
           command on a card; the index's peak RSS and bytes a base

    python -m ibwa_tpu_torch.index_3gbp [--gbp 3.1] [--align]
        [--device cuda] [--pairs 16384] [--json] [--work DIR] [--reuse]
    python -m ibwa_tpu_torch.index_3gbp --gbp 0.5 --compare-paths

The work directory (default .bench/index3g_torch/) is emptied of an
earlier call's files first: each call generates and indexes anew.  With
`--reuse` a complete index there is kept: the record written after the
index (`index.json`) names the genome's size, the FASTA's bytes and
sha256 and the artifacts' bytes, and the index is kept when all of them
match this `--gbp` and the files (so an index built in one call can be
aligned on in the next, where the work directory survives between them).
On a genome above 2^31 bases, `sampe -R` must map records on contigs whose
packed offset is at or above 2^31 (the report counts them).

`--compare-paths` indexes the FASTA by both paths of the builder (SA-IS
and the frugal packed-text SA-IS, IBWA_FRUGAL_MIN=0) in child processes:
the eight artifacts byte-equal, each path's wall and peak RSS.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

from . import parity_scale

REPO = pathlib.Path(__file__).resolve().parent.parent
WORK = REPO / ".bench" / "index3g_torch"
PAIRS = 16_384
ROUNDS = 3                 # of the aln rates, in turns
RSS_LIMIT_GB = 16.0        # the script's budget
ARTIFACTS = ("pac", "rpac", "ann", "amb", "bwt", "rbwt", "sa", "rsa")
ROUTES = ("device_only", "hybrid")
POS_MARK = 1 << 26         # coordinates above it are reported
HIGH = 1 << 31
RECORD = "index.json"      # the index's record, written after it: its
                           # FASTA's bytes and sha256, the artifacts' bytes

# the index, in a child process that imports the port alone and reports
# its own peak RSS (RUSAGE_SELF).  A process keeps the peak of the address
# space it execs from, so the child is started by a small interpreter of
# its own (_SPAWN), never straight from this process, whose peak it would
# report
_CHILD = """\
import json, resource, sys, time
for m in ("jax", "ibwa_tpu"):
    sys.modules[m] = None
from ibwa_tpu_torch import cli
t0 = time.perf_counter()
rc = cli.main(["index", sys.argv[1]])
wall = time.perf_counter() - t0
print(json.dumps({"rc": rc, "wall_s": wall, "max_rss_kb":
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))
"""
_SPAWN = """\
import subprocess, sys
sys.exit(subprocess.run([sys.executable, "-c", *sys.argv[1:]]).returncode)
"""


def log(msg: str) -> None:
    print(f"[index3g] {msg}", file=sys.stderr, flush=True)


def gen_fasta(path: pathlib.Path, n_total: int) -> None:
    """scripts/index_3gbp.py::gen_fasta, unchanged: byte-equal output."""
    rng = np.random.RandomState(20260817)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_contigs = 32
    per = n_total // n_contigs
    alu = rng.randint(0, 4, 300)
    with open(path, "wb") as f:
        for c in range(n_contigs):
            f.write(f">chr{c + 1}\n".encode())
            made = 0
            while made < per:
                if rng.rand() < 0.08:
                    block = alu
                else:
                    block = rng.randint(0, 4, int(rng.randint(20_000,
                                                              200_000)))
                block = block[:per - made]
                line = bases[block]
                # 70-col wrap
                pad = (-len(line)) % 70
                if pad:
                    line = np.concatenate([line, np.zeros(pad, np.uint8)])
                arr = line.reshape(-1, 70)
                out = np.empty((arr.shape[0], 71), dtype=np.uint8)
                out[:, :70] = arr
                out[:, 70] = ord("\n")
                raw = out.tobytes()
                if pad:
                    raw = raw[:-(pad + 1)] + b"\n"
                f.write(raw)
                made += len(block)


def read_contigs(fa: pathlib.Path) -> list[tuple[str, np.ndarray]]:
    """(name, ASCII bases) of each contig of a FASTA file."""
    raw = np.fromfile(fa, dtype=np.uint8)
    heads = np.flatnonzero(raw == ord(">"))
    out = []
    for i, h in enumerate(heads.tolist()):
        nl = h + int(np.argmax(raw[h:h + 4096] == ord("\n")))
        end = int(heads[i + 1]) if i + 1 < len(heads) else len(raw)
        seq = raw[nl + 1:end]
        out.append((raw[h + 1:nl].tobytes().decode().split()[0],
                    seq[seq != ord("\n")]))
    return out


def index_path(fa: pathlib.Path, frugal_min: str | None = None) -> str:
    """The index path `index/builder.py:294`'s rule takes for this FASTA
    (at IBWA_FRUGAL_MIN = `frugal_min`, else the environment's)."""
    if frugal_min is None:
        frugal_min = os.environ.get("IBWA_FRUGAL_MIN", (1 << 31) - 2)
    return "frugal" if fa.stat().st_size >= int(frugal_min) else "sais"


def index(fa: pathlib.Path, n_total: int, say=log,
          frugal_min: str | None = None) -> dict:
    """Index `fa` through `cli.main` in a child process (IBWA_FRUGAL_MIN =
    `frugal_min` there, if given); its wall, its peak RSS and the
    artifacts' bytes, as the script reports them (with `under_16gb`: the
    caller fails above RSS_LIMIT_GB)."""
    from . import native
    native.load()          # built here, so that the child only loads it
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    if frugal_min is not None:
        env["IBWA_FRUGAL_MIN"] = frugal_min
    r = subprocess.run([sys.executable, "-c", _SPAWN, _CHILD, str(fa)],
                       env=env, capture_output=True, text=True)
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        raise AssertionError(f"index {fa} exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    got = json.loads(lines[-1])
    if got["rc"] != 0:
        raise AssertionError(f"index {fa} returned {got['rc']}:\n"
                             f"{r.stderr[-3000:]}")
    rss_gb = got["max_rss_kb"] / 1e6
    with open(f"{fa}.ann") as f:
        bases = int(f.readline().split()[0])      # l_pac
    report = {
        "genome_bp": n_total,
        "bases": bases,
        "fasta_bytes": fa.stat().st_size,
        "path": index_path(fa, frugal_min),
        "index_wall_s": round(got["wall_s"], 1),
        "max_rss_gb": round(rss_gb, 2),
        "under_16gb": rss_gb <= RSS_LIMIT_GB,
        "artifacts_bytes": {ext: pathlib.Path(f"{fa}.{ext}").stat().st_size
                            for ext in ARTIFACTS},
    }
    report["rss_bytes_per_base"] = round(
        got["max_rss_kb"] * 1024 / max(bases, 1), 2)
    say(f"indexed {bases} bp ({report['path']} path) in "
        f"{got['wall_s']:.1f} s, peak RSS {rss_gb:.2f} GB "
        f"({report['rss_bytes_per_base']} bytes a base); artifacts "
        f"{report['artifacts_bytes']}")
    return report


def table_memory(fa: pathlib.Path, device: str) -> dict:
    """The device table of `fa` as `aln` and `sampe` build it: seconds to
    load the index, to build the block table (numpy) and to upload it and
    the sampled arrays; their bytes."""
    import torch
    from .fm.device import build_blocks
    from .fm.fmindex import FmIndex
    from .index.builder import load_index
    t0 = time.perf_counter()
    fms = (FmIndex(load_index(str(fa), 0)), FmIndex(load_index(str(fa), 1)))
    t1 = time.perf_counter()
    blocks, _ = build_blocks(fms[0], fms[1],
                             int(os.environ.get("IBWA_DEV_INTV", "64")))
    t2 = time.perf_counter()
    on = [torch.from_numpy(blocks.view(np.int32)).to(device),
          torch.from_numpy(np.stack([fms[0].sa, fms[1].sa]).astype(
              np.uint32).view(np.int32)).to(device)]
    if on[0].is_cuda:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    return {"load_s": t1 - t0, "blocks_s": t2 - t1, "upload_s": t3 - t2,
            "blocks_bytes": on[0].numel() * 4,
            "sampled_bytes": on[1].numel() * 4,
            "sa_intv": int(fms[0].sa_intv)}


def peak_of(device: str, fn):
    """fn() and the most memory torch held on `device` while it ran (None
    off a card)."""
    import torch
    if not device.startswith("cuda"):
        return fn(), None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def make_pairs(contigs, work: pathlib.Path, n: int) -> tuple:
    """n pairs from the contigs, drawn by length; (fq1, fq2)."""
    seqs = [s for _, s in contigs]
    lens = np.array([len(s) for s in seqs], dtype=np.float64)
    fqs = (work / "end1.fq", work / "end2.fq")
    mates = parity_scale.sim_pairs(np.random.default_rng([20260817, 1]),
                                   seqs, lens / lens.sum(), n)
    for fq, mate in zip(fqs, mates):
        parity_scale.write_fastq(fq, b"p", mate)
    return fqs


def sam_places(sam: pathlib.Path, offsets: dict) -> dict:
    """Of the mapped records: the contigs they lie on, and how many lie
    above POS_MARK by SAM POS and by the coordinate of the whole packed
    text (the contig's offset + POS - 1)."""
    contigs, pos_hi, packed_hi, high = set(), 0, 0, 0
    for f in parity_scale.sam_records(sam):
        if int(f[1]) & 4:
            continue
        name, pos = f[2].decode(), int(f[3])
        contigs.add(name)
        pos_hi += pos > POS_MARK
        packed_hi += offsets[name] + pos - 1 > POS_MARK
        high += offsets[name] >= HIGH
    return {"contigs": len(contigs), "pos_above_2_26": pos_hi,
            "packed_above_2_26": packed_hi,
            "on_contigs_above_2_31": high}


def align(fa: pathlib.Path, work: pathlib.Path, device: str, pairs: int,
          rounds: int, say=log) -> dict:
    """The large-table configuration on an indexed `fa` (the module's
    docstring); raises on the first inequality."""
    from .align import engine
    from .align.opts import GapOpt, cal_maxdiff
    parity_scale.LAUNCHES.clear()
    contigs = read_contigs(fa)
    offsets, at = {}, 0
    for name, seq in contigs:
        offsets[name], at = at, at + len(seq)
    seq_len = at
    t0 = time.perf_counter()
    fqs = make_pairs(contigs, work, pairs)
    del contigs
    say(f"{pairs} pairs simulated in {time.perf_counter() - t0:.1f} s")
    mem = table_memory(fa, device)
    say(f"the table on {device}: index loaded in {mem['load_s']:.2f} s, "
        f"block table built in {mem['blocks_s']:.2f} s, uploaded with the "
        f"sampled arrays in {mem['upload_s']:.2f} s; {mem['blocks_bytes']} "
        f"bytes of block table, {mem['sampled_bytes']} of sampled arrays "
        f"(sa_intv {mem['sa_intv']})")

    # aln, both ends: each device route byte-equal to native, at the
    # arena the engine's rule gives 100 bp reads under the default options
    opt = GapOpt()
    want_acap = [engine.caps(cal_maxdiff(100, thres=opt.fnr), opt, seq_len,
                             device.split(":")[0])[0]]
    ends, sais, aln_peak = [], [], 0
    for e, fq in enumerate(fqs, 1):
        res, peak = peak_of(device, lambda: parity_scale.aln_pair(
            f"end{e}", fa, fq, work, device, ROUTES))
        aln_peak = max(aln_peak, peak or 0)
        summary = {r: parity_scale.aln_summary(st) for r, st in res.items()}
        for route in ROUTES:
            if summary[route]["acap"] != want_acap:
                raise AssertionError(f"aln {route} end {e} took ACAP "
                                     f"{summary[route]['acap']} on "
                                     f"{seq_len} bases, not {want_acap}")
        say(f"aln end {e}: .sai byte-equal to native, device-only and "
            f"hybrid; one width pass and one chunk search a chunk "
            f"({summary['device_only']['launches']}); ACAP "
            f"{summary['device_only']['acap'][0]} on {seq_len} bases; "
            f"fallback share device-only "
            f"{summary['device_only']['fallback_share']:.4f} (by cause "
            f"{summary['device_only']['fallback_by_cause']}), hybrid "
            f"{summary['hybrid']['fallback_share']:.4f}, the hybrid's "
            f"host share {[b['host_share'] for b in res['hybrid']['batches']]}")
        ends.append(summary)
        sais.append(work / f"end{e}.native.sai")

    # the rates: end 1, in turns
    order = ("device_only", "hybrid", "native")
    rates = {r: [] for r in order}
    for i in range(rounds):
        for route in order if i % 2 == 0 else order[::-1]:
            out = work / f"rate.{route}.sai"
            st = parity_scale.aln(fa, fqs[0], out, route, device)
            parity_scale.same_bytes(f"aln rate round {i} {route}", out,
                                    sais[0])
            rates[route].append(st["reads"] / st["search_s"])
    rates = {r: parity_scale.spread(v) for r, v in rates.items()}
    say(f"aln end 1, reads/s of search wall, {rounds} rounds in turns, "
        f".sai byte-equal every round: {rates}")

    # sampe -R: K5's walks against the host walks
    args = [str(fa), *map(str, sais), *map(str, fqs)]
    pe, sampe_peak = peak_of(device, lambda: parity_scale.sampe_pair(
        "pairs", args, work, device, pairs, keep_values=True))
    places = sam_places(work / "pairs.host.sam", offsets)
    if places["contigs"] < 2:
        raise AssertionError(f"sampe mapped records on {places['contigs']} "
                             f"contig(s) of {len(offsets)}")
    if seq_len > HIGH and places["on_contigs_above_2_31"] <= 0:
        raise AssertionError("sampe mapped no record on a contig whose "
                             "packed offset is at or above 2^31")
    say(f"sampe -R: SAM byte-equal, K5's walks and the host walks (host "
        f"{pe['host_s']:.1f} s, K5 {pe['k5_s']:.1f} s); {pe['mapped']} of "
        f"{pe['records']} records mapped on {places['contigs']} of "
        f"{len(offsets)} contigs, {places['pos_above_2_26']} above 2^26 by "
        f"POS, {places['packed_above_2_26']} by packed coordinate, "
        f"{places['on_contigs_above_2_31']} on contigs at or above 2^31 in "
        f"the packed text; prefill "
        f"{pe['batches']}; launches {pe['launches']}")
    mem.update(aln_max_allocated=aln_peak if device.startswith("cuda")
               else None, sampe_max_allocated=sampe_peak)
    if device.startswith("cuda"):
        say(f"torch.cuda.max_memory_allocated: aln {aln_peak} bytes, sampe "
            f"{sampe_peak} bytes")
    return {"aln": ends, "rates": rates, "sampe": {**pe, **places},
            "memory": mem, "launches": dict(parity_scale.LAUNCHES),
            "_paths": {"fa": fa, "fqs": fqs}}


def fasta_sha256(fa: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(fa, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def reusable(work: pathlib.Path, n_total: int) -> dict | None:
    """The record of `work`'s index (RECORD, written after the index) if it
    names a FASTA of `n_total` bases whose bytes and sha256 are those of
    `work`/huge.fa now, and every artifact at the bytes it names; else
    None."""
    fa = work / "huge.fa"
    try:
        rec = json.loads((work / RECORD).read_text())
    except (OSError, ValueError):
        return None
    if (rec.get("genome_bp") != n_total or not fa.is_file()
            or fa.stat().st_size != rec.get("fasta_bytes")):
        return None
    for ext, size in rec.get("artifacts_bytes", {}).items():
        art = pathlib.Path(f"{fa}.{ext}")
        if not art.is_file() or art.stat().st_size != size:
            return None
    if set(rec.get("artifacts_bytes", {})) != set(ARTIFACTS):
        return None
    return rec if fasta_sha256(fa) == rec.get("fasta_sha256") else None


def run(gbp: float = 3.1, align_too: bool = False, device: str = "cuda",
        pairs: int = PAIRS, work: pathlib.Path = WORK, rounds: int = ROUNDS,
        say=log, reuse: bool = False) -> dict:
    """Generate, index and report; with `align_too` the large-table
    configuration on the index.  With `reuse`, an index that `work` holds
    already is kept when its record (`reusable`) matches this `gbp` and
    its FASTA; else (and without `reuse`) the work directory's files are
    deleted first and the FASTA made and indexed anew.  Returns the report
    (private keys, those starting with "_", for the caller)."""
    n_total = int(gbp * 1e9)
    work = pathlib.Path(work)
    work.mkdir(parents=True, exist_ok=True)
    fa = work / "huge.fa"
    kept = reusable(work, n_total) if reuse else None
    keep = ({fa.name, RECORD, *(f"{fa.name}.{e}" for e in ARTIFACTS)}
            if kept else set())
    for old in work.iterdir():      # nothing else of an earlier call is read
        if old.is_file() and old.name not in keep:
            old.unlink()
    t0 = time.perf_counter()
    if kept:
        say(f"reusing the index of {fa} ({kept['bases']} bases, FASTA "
            f"sha256 {kept['fasta_sha256'][:16]}..., indexed in "
            f"{kept['index_wall_s']} s)")
        res = {"gbp": gbp, "device": device, **kept, "reused": True}
        gen_s = 0.0
    else:
        say(f"generating {gbp} Gbp FASTA")
        gen_fasta(fa, n_total)
        gen_s = time.perf_counter() - t0
        say(f"generated in {gen_s:.1f} s ({fa.stat().st_size / 1e9:.3f} "
            f"GB)")
        t0 = time.perf_counter()
        rec = {"gen_s": round(gen_s, 1), **index(fa, n_total, say),
               "fasta_sha256": fasta_sha256(fa)}
        tmp = work / f"{RECORD}.tmp"
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, work / RECORD)
        res = {"gbp": gbp, "device": device, **rec, "reused": False}
    if align_too:
        res.update(align(fa, work, device, pairs, rounds, say))
    res["seconds"] = time.perf_counter() - t0 + gen_s
    return res


def compare_paths(gbp: float, work: pathlib.Path, say=log) -> dict:
    """The FASTA of `gbp` indexed by both paths of `index/builder.py:294`
    (SA-IS, IBWA_FRUGAL_MIN above the FASTA's bytes; the frugal packed-text
    SA-IS, IBWA_FRUGAL_MIN=0), each in its own child process: the eight
    artifacts byte-equal (raises otherwise), each path's wall and peak
    RSS.  `work`'s files are deleted first."""
    import filecmp
    n_total = int(gbp * 1e9)
    work = pathlib.Path(work)
    work.mkdir(parents=True, exist_ok=True)
    for old in work.iterdir():
        if old.is_file():
            old.unlink()
    fas = {"sais": work / "sais.fa", "frugal": work / "frugal.fa"}
    t0 = time.perf_counter()
    gen_fasta(fas["sais"], n_total)
    os.link(fas["sais"], fas["frugal"])     # one FASTA, two prefixes
    say(f"generated {gbp} Gbp in {time.perf_counter() - t0:.1f} s")
    out = {"gbp": gbp, "fasta_bytes": fas["sais"].stat().st_size}
    for path, frugal_min in (("sais", str(1 << 62)), ("frugal", "0")):
        rep = index(fas[path], n_total, say, frugal_min=frugal_min)
        if rep["path"] != path:
            raise AssertionError(f"the {path} run took the {rep['path']} "
                                 f"path")
        out[path] = {k: rep[k] for k in ("index_wall_s", "max_rss_gb",
                                         "rss_bytes_per_base", "bases")}
    for ext in ARTIFACTS:
        if not filecmp.cmp(f"{fas['sais']}.{ext}", f"{fas['frugal']}.{ext}",
                           shallow=False):
            raise AssertionError(f"the frugal path's .{ext} differs from "
                                 f"the SA-IS path's")
    out["equal"] = True
    out["frugal_over_sais_wall"] = (out["frugal"]["index_wall_s"]
                                    / out["sais"]["index_wall_s"])
    say(f"the two index paths at {gbp} Gbp: the eight artifacts byte-equal; "
        f"SA-IS {out['sais']['index_wall_s']} s, {out['sais']['max_rss_gb']} "
        f"GB; frugal {out['frugal']['index_wall_s']} s, "
        f"{out['frugal']['max_rss_gb']} GB "
        f"({out['frugal_over_sais_wall']:.2f}x the wall)")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.index_3gbp",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--align", action="store_true",
                    help="run aln and sampe -R on the index")
    ap.add_argument("--device", default="cuda",
                    help="device of the device routes (cuda, cuda:N, cpu)")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--json", action="store_true",
                    help="print the report's JSON line on stdout")
    ap.add_argument("--work", default=str(WORK),
                    help="directory of the FASTA, index and outputs")
    ap.add_argument("--reuse", action="store_true",
                    help="keep the work directory's index where its record "
                         "names this --gbp and its FASTA's bytes and hash")
    ap.add_argument("--compare-paths", action="store_true",
                    help="index the FASTA by the SA-IS and the frugal path "
                         "instead, artifacts byte-equal, wall and peak RSS "
                         "of each (no --align)")
    args = ap.parse_args(argv)
    if args.compare_paths:
        res = compare_paths(args.gbp, pathlib.Path(args.work))
        if args.json:
            print(json.dumps(res), flush=True)
        else:
            log(json.dumps(res))
        return 0
    if args.align and args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log("no CUDA device; pass --device cpu")
            return 2
    res = run(args.gbp, args.align, args.device, args.pairs,
              pathlib.Path(args.work), reuse=args.reuse)
    (pathlib.Path(args.work) / "report.json").write_text(
        json.dumps(parity_scale.public(res), indent=1, default=str))
    line = json.dumps(parity_scale.public(res), default=str)
    if args.json:
        print(line, flush=True)
    else:
        log(line)
    if not res["under_16gb"]:       # after the report, as the script
        raise SystemExit(f"memory budget exceeded: {res['max_rss_gb']} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
