"""`bwasw`'s native driver, staged against sequential, on simulated long reads.

    python -m ibwa_tpu_torch.bwasw_ab [--genome-len N] [--reads N]
                                      [--rounds N] [--workdir DIR]

The staged driver (`bsw2.cpp`, `staged=True`, the reference's default)
batches the seed extensions of a segment of up to 1,024 reads; the
sequential one runs the reads one by one.  With no device route installed
both run every extension on the host, and their SAM must be equal.  This
runs the two in turns, `--rounds` times each, on a genome made by
`simulate.make_genome` from seed 20261016 and `--reads` long reads made by
`make_long_reads` (the smoke's recipe), and prints one JSON line: the
walls and the driver's stage split of each run, and whether the SAM was
equal.  Inputs are cached under `--workdir` (default `.bench/bwasw_ab/`
of the checkout).  `chip_smoke.py` runs the
same comparison (`staged_ab`) on the card's host.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import random
import sys
import time

import numpy as np

GENOME_SEED = 20261016
READS_SEED = GENOME_SEED + 3


def make_long_reads(fa, n: int, out: pathlib.Path,
                    seed: int = READS_SEED) -> pathlib.Path:
    """n long reads of the one-sequence FASTA `fa`, made as the JAX
    package's benchmark makes its bwasw reads (`bench.py`: lengths 400 to
    999, 2% of the bases replaced by a random base, half
    reverse-complemented), with numpy from `seed`; written to `out` unless
    it exists."""
    if out.exists():
        return out
    with open(fa, "rb") as f:
        f.readline()
        genome = np.frombuffer(f.read().replace(b"\n", b""), dtype=np.uint8)
    rng = np.random.default_rng(seed)
    lens = rng.integers(400, 1000, n)
    pos = (rng.random(n) * (len(genome) - lens)).astype(np.int64)
    flip = rng.random(n) < 0.5
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = []
    for i in range(n):
        s = genome[pos[i]:pos[i] + lens[i]].copy()
        sub = rng.random(len(s)) < 0.02
        s[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
        if flip[i]:
            s = comp[s[::-1]]
        recs.append(b"@L%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * len(s)))
    out.write_bytes(b"".join(recs))
    return out


STAGES = ("core", "ext", "device_route", "host_loop", "cigar", "all")
CORE = ("core_pre", "core_fill", "core_save")


def staged_ab(prefix: str, fq: str, rounds: int,
              profile: bool = False) -> dict:
    """The native driver sequential and staged, in turns (sequential
    first), `rounds` times each: their walls (s) and stage splits (s, as
    `bsw2_aln` prints them; with `profile` the core's sections too, on
    both sides), and the SAM (bytes); raises if a SAM differs."""
    import re

    from .bwasw.aux import bsw2_aln
    from .bwasw.core import Bsw2Opt
    if rounds < 1:
        raise ValueError(f"rounds must be positive: {rounds}")
    line = re.compile(r"\[bsw2_aln\] stages: core ([\d.]+) s, extensions "
                      r"([\d.]+) s \(device route ([\d.]+) s, host loop "
                      r"([\d.]+) s\), cigar ([\d.]+) s, all ([\d.]+) s"
                      r"(?:; core: pre ([\d.]+) s, fill ([\d.]+) s, save "
                      r"([\d.]+) s)?")
    opt = Bsw2Opt()
    opt.t *= opt.a
    opt.coef *= opt.a
    res = {"sequential": [], "staged": []}
    sam = None
    for _ in range(rounds):
        for staged in (False, True):
            buf, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                bsw2_aln(opt, prefix, fq, out=buf, engine="native",
                         staged=staged, profile=profile)
            wall = time.perf_counter() - t0
            if sam is None:
                sam = buf.getvalue()
            elif buf.getvalue() != sam:
                raise AssertionError("bwasw: the staged and the sequential "
                                     "driver's SAM differ")
            stages = {k: float(v) for k, v in zip(
                STAGES + CORE, line.search(err.getvalue()).groups()) if v}
            res["staged" if staged else "sequential"].append(
                {"wall_s": wall, **stages})
    res["sam"] = sam.encode()
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ibwa_tpu_torch.bwasw_ab")
    ap.add_argument("--genome-len", type=int, default=2_000_000)
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--workdir", default=str(
        pathlib.Path(__file__).resolve().parent.parent / ".bench" /
        "bwasw_ab"))
    args = ap.parse_args(argv)
    from . import cli, simulate
    work = pathlib.Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    fa = work / f"genome_{GENOME_SEED}_{args.genome_len}.fa"
    if not pathlib.Path(str(fa) + ".bwt").exists():
        seq = simulate.make_genome(random.Random(GENOME_SEED),
                                   args.genome_len)
        with open(fa, "w") as f:
            f.write(">ab_chr\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.main(["index", str(fa)]) != 0:
                raise RuntimeError("index failed")
    fq = make_long_reads(fa, args.reads,
                         work / f"long_{READS_SEED}_{args.reads}.fq")
    res = staged_ab(str(fa), str(fq), args.rounds)
    res["sam_bytes"] = len(res.pop("sam"))
    print(json.dumps({"genome_len": args.genome_len, "reads": args.reads,
                      "sam_equal": True, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
