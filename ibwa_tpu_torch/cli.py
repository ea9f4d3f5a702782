"""Command-line interface of the port: `index`, `aln`, `samse` and `sampe`.

Usage: python -m ibwa_tpu_torch <command> [options]

The other stages of `ibwa_tpu`'s CLI (`bwasw` and the tools) are not
ported yet: they print that to stderr and return 2.
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = ("bwasw", "fa2pac", "pac2bwt", "pac2bwtgen", "bwtupdate",
              "pac_rev", "bwt2sa", "pac2cspac", "stdsw", "qualfa2fq",
              "solid2fastq", "prepare-remap")


def cmd_index(argv: list[str]) -> int:
    """`index` with the option surface of ibwa_tpu.cli.cmd_index."""
    ap = argparse.ArgumentParser(prog="ibwa-tpu-torch index")
    ap.add_argument("fasta", help="input FASTA")
    ap.add_argument("-p", "--prefix", default=None,
                    help="index prefix [fasta path]")
    ap.add_argument("-c", action="store_true",
                    help="build for color-space (SOLiD) reads")
    ap.add_argument("-a", default="is", choices=["is", "bwtsw", "div"],
                    help="construction algorithm (all via SA-IS; the "
                         "BWT is unique so artifacts are identical)")
    args = ap.parse_args(argv)
    from .index.builder import bwa_index
    bwa_index(args.fasta, args.prefix, color=args.c)
    return 0


def cmd_aln(argv: list[str]) -> int:
    """`aln` with the reference option surface (ibwa_tpu.cli.cmd_aln) plus
    --device; --engine picks torch (default), native or ref."""
    ap = argparse.ArgumentParser(prog="ibwa-tpu-torch aln")
    ap.add_argument("prefix")
    ap.add_argument("fastq")
    ap.add_argument("-n", default=None,
                    help="max #diff (int) or missing prob (float)")
    ap.add_argument("-o", type=int, default=None, help="max gap opens")
    ap.add_argument("-e", type=int, default=-1, help="max gap extensions")
    ap.add_argument("-i", type=int, default=None, help="indel end skip")
    ap.add_argument("-d", type=int, default=None, help="max del occ")
    ap.add_argument("-l", type=int, default=None, help="seed length")
    ap.add_argument("-k", type=int, default=None, help="max seed diff")
    ap.add_argument("-m", type=int, default=None, help="max entries")
    ap.add_argument("-M", type=int, default=None, help="mismatch penalty")
    ap.add_argument("-O", type=int, default=None, help="gap open penalty")
    ap.add_argument("-E", type=int, default=None, help="gap extend penalty")
    ap.add_argument("-R", type=int, default=None, help="max equally-best")
    ap.add_argument("-q", type=int, default=None, help="trim quality")
    ap.add_argument("-N", action="store_true", help="non-iterative mode")
    ap.add_argument("-t", type=int, default=1,
                    help="host threads (sets OMP_NUM_THREADS, as "
                         "ibwa_tpu aln does)")
    ap.add_argument("-c", action="store_true", help="color-space reads")
    ap.add_argument("-b", action="store_true", help="BAM input")
    ap.add_argument("-B", type=int, default=0, help="barcode length")
    ap.add_argument("-I", action="store_true",
                    help="input is Illumina 1.3+ quality (64-based)")
    ap.add_argument("-0", dest="b0", action="store_true",
                    help="BAM: use single-end reads only")
    ap.add_argument("-1", dest="b1", action="store_true",
                    help="BAM: use read1 only")
    ap.add_argument("-2", dest="b2", action="store_true",
                    help="BAM: use read2 only")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    ap.add_argument("--engine", default="torch",
                    choices=["torch", "native", "ref"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)

    from .align.opts import BWA_MODE_GAPE, BWA_MODE_NONSTOP, GapOpt
    from .align.pipeline import aln_to_stream
    opt = GapOpt()
    if args.n is not None:
        if "." in args.n:
            opt.fnr, opt.max_diff = float(args.n), -1
        else:
            opt.max_diff, opt.fnr = int(args.n), -1.0
    if args.o is not None:
        opt.max_gapo = args.o
    if args.e > 0:
        opt.max_gape = args.e
        opt.mode &= ~BWA_MODE_GAPE
    for flag, attr in [("i", "indel_end_skip"), ("d", "max_del_occ"),
                       ("l", "seed_len"), ("k", "max_seed_diff"),
                       ("m", "max_entries"), ("M", "s_mm"), ("O", "s_gapo"),
                       ("E", "s_gape"), ("R", "max_top2"), ("q", "trim_qual")]:
        v = getattr(args, flag)
        if v is not None:
            setattr(opt, attr, v)
    if args.N:
        opt.mode |= BWA_MODE_NONSTOP
        opt.max_top2 = 0x7FFFFFFF
    opt.n_threads = args.t
    if args.t > 0:
        import os
        os.environ.setdefault("OMP_NUM_THREADS", str(args.t))
    if args.c:
        opt.mode &= ~0x02  # clear BWA_MODE_COMPREAD (bwtaln.c:262)
    for on, bit in ((args.b, 0x20), (args.b0, 0x40), (args.b1, 0x80),
                    (args.b2, 0x100), (args.I, 0x200)):
        if on:
            opt.mode |= bit
    if args.B:
        opt.mode |= args.B << 24
    out = open(args.f, "wb") if args.f else sys.stdout.buffer
    try:
        aln_to_stream(args.prefix, args.fastq, opt, out, engine=args.engine,
                      device=args.device)
    finally:
        if args.f:
            out.close()
    return 0


def cmd_samse(argv: list[str]) -> int:
    """`samse` with the option surface of ibwa_tpu.cli.cmd_samse.  Nothing
    of it runs on a device, as in the reference."""
    ap = argparse.ArgumentParser(prog="ibwa-tpu-torch samse")
    ap.add_argument("prefix")
    ap.add_argument("sai")
    ap.add_argument("fastq")
    ap.add_argument("-n", type=int, default=3, help="max XA hits")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    ap.add_argument("-r", default=None, help="@RG header line")
    args = ap.parse_args(argv)
    from .sam.bwase import parse_rg, sai2sam_se
    rg_line = rg_id = None
    if args.r is not None:
        rg_line, rg_id = parse_rg(args.r)
        if rg_id is None:
            print(f"[{__name__}] malformated @RG line", file=sys.stderr)
            return 1
    out = open(args.f, "w") if args.f else sys.stdout
    try:
        sai2sam_se(args.prefix, args.sai, args.fastq, n_occ=args.n,
                   out=out, rg_line=rg_line, rg_id=rg_id)
    finally:
        if args.f:
            out.close()
    return 0


def cmd_sampe(argv: list[str]) -> int:
    """`sampe` with the option surface of ibwa_tpu.cli.cmd_sampe plus
    --engine and --device: `torch` walks each batch's SA rows with K5 on
    --device (cpu: its plain version), `native` walks them on the host
    inside the native stage (the reference's default)."""
    ap = argparse.ArgumentParser(prog="ibwa-tpu-torch sampe")
    ap.add_argument("args", nargs="+",
                    help="<prefix> <1.sai> <2.sai> <1.fq> <2.fq> "
                         "[<prefix2> <sai> <sai> ...]")
    ap.add_argument("-a", type=int, default=500, help="max insert size")
    ap.add_argument("-o", type=int, default=100000, help="max occ per end")
    ap.add_argument("-n", type=int, default=3, help="max multi hits")
    ap.add_argument("-N", type=int, default=10, help="max discordant hits")
    ap.add_argument("-c", type=float, default=1e-5, help="chimeric prior")
    ap.add_argument("-f", default=None, help="output file [stdout]")
    ap.add_argument("-r", default=None, help="@RG header line")
    ap.add_argument("-s", action="store_true", help="disable mate SW")
    ap.add_argument("-A", action="store_true", help="disable isize estimate")
    ap.add_argument("-R", action="store_true", help="enable remapping")
    ap.add_argument("-P", action="store_true", help="preload index")
    ap.add_argument("-t", type=int, default=1, help="threads")
    ap.add_argument("--engine", default="torch", choices=["torch", "native"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the SA walks (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)
    pos = args.args
    if len(pos) < 5 or (len(pos) - 5) % 3 != 0:
        print("usage: sampe <prefix> <1.sai> <2.sai> <1.fq> <2.fq> ...",
              file=sys.stderr)
        return 1
    prefixes = [pos[0]]
    sai_pairs = [(pos[1], pos[2])]
    fq1, fq2 = pos[3], pos[4]
    i = 5
    while i < len(pos):
        prefixes.append(pos[i])
        sai_pairs.append((pos[i + 1], pos[i + 2]))
        i += 3
    from .sam.bwase import parse_rg
    from .sam.sampe import PeOpt, sai2sam_pe
    popt = PeOpt(max_isize=args.a, max_occ=args.o, n_multi=args.n,
                 N_multi=args.N, ap_prior=args.c,
                 is_sw=0 if args.s else 1, force_isize=1 if args.A else 0,
                 remapping=1 if args.R else 0, n_threads=args.t)
    rg_line = rg_id = None
    if args.r is not None:
        rg_line, rg_id = parse_rg(args.r)
        if rg_id is None:
            print("[sampe] malformated @RG line", file=sys.stderr)
            return 1
    out = open(args.f, "w") if args.f else sys.stdout
    try:
        sai2sam_pe(prefixes, sai_pairs, fq1, fq2, popt, out=out,
                   rg_line=rg_line, rg_id=rg_id,
                   device=args.device if args.engine == "torch" else None)
    finally:
        if args.f:
            out.close()
    return 0


COMMANDS = {"index": cmd_index, "aln": cmd_aln, "samse": cmd_samse,
            "sampe": cmd_sampe}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("ibwa-tpu-torch — the ibwa_tpu aligner on PyTorch + CUDA",
              file=sys.stderr)
        print(f"commands: {', '.join(COMMANDS)}", file=sys.stderr)
        return 1
    cmd = argv[0]
    if cmd in COMMANDS:
        return COMMANDS[cmd](argv[1:])
    if cmd in NOT_PORTED:
        print(f"[ibwa-tpu-torch] '{cmd}' is not ported yet (use ibwa_tpu)",
              file=sys.stderr)
        return 2
    print(f"[ibwa-tpu-torch] unrecognized command '{cmd}'", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
