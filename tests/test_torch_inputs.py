"""The input routes no other port test holds, against ibwa_tpu on the CPU.

The pre-port tests of these routes (`tests/test_adversarial.py`,
`tests/test_bam.py`) call the reference binary, which is not in the
tree, so they skip.  Here each of their recipes is rebuilt with the same
seeds and the port's output is held against ibwa_tpu's on the same
input, byte for byte:

  * a soft-masked FASTA with IUPAC codes: the eight index artifacts of
    both builders; `aln` .sai; `samse` SAM; `sampe -R` SAM of pairs from
    the same genome on the port's host walks and its walker (K5's plain
    version);
  * a genome with N holes and reads with N runs; offset-64 qualities with
    trimming (`-q 20 -I`), barcodes (`-B 5`) and both (`-B 5 -I`): `aln`
    .sai and `samse` SAM, one of them through both CLIs in subprocesses;
  * BAM input: `-b` across the batch seam (both packages' pipeline
    BATCH_SIZE set to 32) and `-b -0`, `-b -1`, `-b -2` on paired and
    single-end records;
  * three dbs in `sampe -R`: SAM on the native, walker and pure-Python
    routes, one walker a db in DbSet's order, 0 host walks and 0 refused
    values after each prefill;
  * hits at and above 2^31 through `_decode` and `native_align_batch`
    into the .sai writer.

The port's `aln` runs two routes: `engine="torch", device="cpu"` with
IBWA_HOST_FRAC=0 (every read through the plain versions of the width
pass and the chunk search) and `engine="native"`; ibwa_tpu's runs its JAX
engine (`engine="jax"`, its stack update through the plain XLA version
and 64 lanes, as tests/test_torch_dist.py runs it).  The oracle binary is
never called.  Then `ibwa_tpu_torch.input_routes`, the card's phase 4k,
runs at its tiny scale with jax and ibwa_tpu blocked.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import random
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from ibwa_tpu.align import engine_jax
from ibwa_tpu.align import pipeline as j_pipeline
from ibwa_tpu.align.opts import GapOpt as JGapOpt
from ibwa_tpu.index import builder as j_builder
from ibwa_tpu.sam.bwase import sai2sam_se as j_sai2sam_se
from ibwa_tpu.sam.sampe import PeOpt as JPeOpt
from ibwa_tpu.sam.sampe import sai2sam_pe as j_sai2sam_pe

from ibwa_tpu_torch import parity_scale
from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.align import pipeline as t_pipeline
from ibwa_tpu_torch.align.opts import (BWA_MODE_BAM, BWA_MODE_BAM_READ1,
                                       BWA_MODE_BAM_READ2, BWA_MODE_BAM_SE,
                                       BWA_MODE_IL13, GapOpt)
from ibwa_tpu_torch.index import builder as t_builder
from ibwa_tpu_torch.sam.bwase import sai2sam_se as t_sai2sam_se
from ibwa_tpu_torch.sam.sampe import PeOpt
from ibwa_tpu_torch.sam.sampe import sai2sam_pe as t_sai2sam_pe

from conftest import REPO, make_genome
from test_bam import COMP, write_bam
from test_remap import _make_alt, _write_fa
from test_torch_sam import _prefill_lines
from test_torch_tools import run_cli

torch.set_num_threads(1)

CPU = torch.device("cpu")
LANES = 64          # CPU-sized persistent lanes in both packages
EXTS = ("pac", "rpac", "ann", "amb", "bwt", "rbwt", "sa", "rsa")
MODE = GapOpt().mode


@pytest.fixture(autouse=True)
def small_lanes(monkeypatch):
    monkeypatch.setattr(engine, "DEV_BATCH", LANES)
    monkeypatch.setattr(engine_jax, "PALLAS_STACK", False)
    monkeypatch.setattr(engine_jax, "DEV_BATCH", LANES)
    monkeypatch.setattr(engine_jax, "PERSIST_N", 640)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kw)


def aln_three(prefix, reads, mode: int, tmp, tag: str, trim: int = 0
              ) -> bytes:
    """The .sai of the port's torch route on the CPU (every read on the
    plain kernels), the port's native route and ibwa_tpu's JAX engine,
    equal; returns it."""
    opt = GapOpt(mode=mode, trim_qual=trim)
    got = {}
    for route in ("torch", "native"):
        buf = io.BytesIO()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("IBWA_HOST_FRAC", "0")
            _quiet(t_pipeline.aln_to_stream, str(prefix), str(reads), opt,
                   buf, engine=route, device="cpu")
        got[route] = buf.getvalue()
    buf = io.BytesIO()
    _quiet(j_pipeline.aln_to_stream, str(prefix), str(reads),
           JGapOpt(mode=mode, trim_qual=trim), buf, engine="jax")
    want = buf.getvalue()
    assert got["torch"] == want, f"{tag}: torch route"
    assert got["native"] == want, f"{tag}: native route"
    (tmp / f"{tag}.sai").write_bytes(want)
    return want


def samse_both(prefix, sai, reads) -> str:
    out_t, out_j = io.StringIO(), io.StringIO()
    _quiet(t_sai2sam_se, str(prefix), str(sai), str(reads), out=out_t)
    _quiet(j_sai2sam_se, str(prefix), str(sai), str(reads), out=out_j)
    assert out_t.getvalue() == out_j.getvalue()
    return out_t.getvalue()


def mapped(sam: str) -> int:
    return sum(1 for ln in sam.splitlines()
               if ln and ln[0] != "@" and not int(ln.split("\t")[1]) & 4)


def records_of(sai: bytes) -> int:
    """Reads in a .sai (after the 64-byte header, a count and its hits)."""
    off, n = 64, 0
    while off < len(sai):
        off += 4 + 16 * struct.unpack_from("<i", sai, off)[0]
        n += 1
    return n


# ---- a soft-masked FASTA with IUPAC codes (test_adversarial.py:184) -------

@pytest.fixture(scope="module")
def iupac_case(tmp_path_factory):
    """The recipe of test_softmask_iupac: 30,000 bases, 30% lower case,
    0.3% IUPAC codes, lines of 61, one contig `iu ctg`; indexed by each
    package under its own prefix; its 150 reads of 72 bp; and 120 pairs
    of 72 bp from the same genome (fragments of gauss(220, 20))."""
    tmp = tmp_path_factory.mktemp("tin_iupac")
    rng = random.Random(5)
    chars = []
    for _ in range(30000):
        c = rng.choice("ACGT")
        if rng.random() < 0.3:
            c = c.lower()
        if rng.random() < 0.003:
            c = rng.choice("MRWSYKVHDBN")
        chars.append(c)
    s = "".join(chars)
    (tmp / "t").mkdir()
    (tmp / "j").mkdir()
    fa, jfa = tmp / "t" / "g.fa", tmp / "j" / "g.fa"
    for p in (fa, jfa):
        with open(p, "w") as f:
            f.write(">iu ctg\n")
            for i in range(0, len(s), 61):
                f.write(s[i:i + 61] + "\n")
    t_builder.bwa_index(str(fa))
    j_builder.bwa_index(str(jfa))
    comp = dict(zip("ACGTacgt", "TGCAtgca"))
    rc = lambda r: "".join(comp.get(c, "N") for c in reversed(r))
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for i in range(150):
            p = rng.randrange(0, len(s) - 80)
            r = s[p:p + 72]
            if rng.random() < 0.5:
                r = rc(r)
            q = "".join(chr(33 + rng.randrange(2, 41)) for _ in r)
            f.write(f"@u{i}\n{r}\n+\n{q}\n")
    prng = random.Random(6)
    fqs = (tmp / "p_1.fq", tmp / "p_2.fq")
    with open(fqs[0], "w") as o1, open(fqs[1], "w") as o2:
        for i in range(120):
            isize = max(160, int(prng.gauss(220, 20)))
            p = prng.randrange(0, len(s) - isize)
            frag = s[p:p + isize]
            r1, r2 = frag[:72], rc(frag[-72:])
            if prng.random() < 0.5:
                r1, r2 = r2, r1
            o1.write(f"@v{i}/1\n{r1}\n+\n{'I' * 72}\n")
            o2.write(f"@v{i}/2\n{r2}\n+\n{'I' * 72}\n")
    return tmp, fa, jfa, fq, fqs


@pytest.mark.parametrize("ext", EXTS)
def test_iupac_index_artifacts_equal(iupac_case, ext):
    tmp, fa, jfa, _, _ = iupac_case
    got = open(f"{fa}.{ext}", "rb").read()
    assert len(got) > 0 and got == open(f"{jfa}.{ext}", "rb").read()


def test_iupac_aln_samse(iupac_case):
    tmp, fa, jfa, fq, _ = iupac_case
    sai = aln_three(fa, fq, MODE, tmp, "iupac")
    assert records_of(sai) == 150
    sam = samse_both(fa, tmp / "iupac.sai", fq)
    assert mapped(sam) > 100


@pytest.mark.parametrize("route", ["native", "device_cpu"])
def test_iupac_sampe(iupac_case, route):
    """sampe -R of the pairs: the port's host walks and its walker (K5's
    plain version) against ibwa_tpu's, on the port's native .sai."""
    tmp, fa, jfa, _, fqs = iupac_case
    sais = []
    for e, fq in enumerate(fqs, 1):
        out = tmp / f"pe{e}.sai"
        if not out.exists():
            with open(out, "wb") as f:
                _quiet(t_pipeline.aln_to_stream, str(fa), str(fq), GapOpt(),
                       f, engine="native")
        sais.append(str(out))
    got, want = io.StringIO(), io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        t_sai2sam_pe([str(fa)], [tuple(sais)], *map(str, fqs),
                     PeOpt(remapping=1), out=got,
                     device=CPU if route == "device_cpu" else None)
    _quiet(j_sai2sam_pe, [str(jfa)], [tuple(sais)], *map(str, fqs),
           JPeOpt(remapping=1), out=want)
    assert got.getvalue() == want.getvalue()
    assert mapped(got.getvalue()) > 160
    if route == "device_cpu":
        lines, last = _prefill_lines(err.getvalue())
        assert all(ln[0] > 0 and ln[3] == ln[4] == 0 for ln in lines)
        assert last == 0


# ---- N holes, N runs, -q -I, -B (test_adversarial.py:27-111) -------------

@pytest.fixture(scope="module")
def adv_case(tmp_path_factory):
    """adv_case's genome (60 kbp with N holes, seed 777), indexed, and the
    reads of each case: test_nrun_reads_samse's (Random(11)),
    test_trim_plus_illumina64's (Random(22)), and the same recipe with a
    5-base barcode before each read, with offset-33 qualities (Random(23))
    and with offset-64 ones (Random(24))."""
    tmp = tmp_path_factory.mktemp("tin_adv")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("achr", "", 60000, 0.002)], seed=777)
    t_builder.bwa_index(str(fa))
    seq = genome["achr"]
    assert "N" in seq
    rng = random.Random(11)
    rc = lambda s: "".join(COMP[c] for c in reversed(s))
    with open(tmp / "nrun.fq", "w") as f:
        for i in range(150):
            pos = rng.randrange(0, len(seq) - 90)
            s = list(seq[pos:pos + 80])
            at = rng.randrange(0, 70)
            run = rng.choice([1, 2, 3, 5, 8, 15, 30])
            s[at:at + run] = "N" * min(run, 80 - at)
            s = "".join(s)
            if rng.random() < 0.5:
                s = rc(s)
            q = "".join(chr(33 + rng.randrange(2, 41)) for _ in s)
            f.write(f"@n{i}\n{s}\n+\n{q}\n")

    def trimmed(name, seed, barcode, offset):
        rng = random.Random(seed)
        with open(tmp / name, "w") as f:
            for i in range(120):
                pos = rng.randrange(0, len(seq) - 90)
                s = "".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                            for c in seq[pos:pos + 76])
                # a decaying 3' tail so that -q trims
                q = "".join(chr(offset + max(2, 40 - rng.randrange(0, j + 2)))
                            for j in range(len(s)))
                if barcode:
                    bc = "".join(rng.choice("ACGT") for _ in range(5))
                    s, q = bc + s, chr(offset + 30) * 5 + q
                f.write(f"@i{i}\n{s}\n+\n{q}\n")

    trimmed("i64.fq", 22, False, 64)
    trimmed("bc.fq", 23, True, 33)
    trimmed("bc64.fq", 24, True, 64)
    return tmp, fa


ADV_CASES = {
    # reads, mode, -q
    "nrun": ("nrun.fq", MODE, 0),
    "q20_I": ("i64.fq", MODE | BWA_MODE_IL13, 20),
    "B5": ("bc.fq", MODE | 5 << 24, 0),
    "B5_I": ("bc64.fq", MODE | BWA_MODE_IL13 | 5 << 24, 0),
}


@pytest.mark.parametrize("case", list(ADV_CASES))
def test_adversarial_aln_samse(adv_case, case):
    tmp, fa = adv_case
    name, mode, trim = ADV_CASES[case]
    fq = tmp / name
    sai = aln_three(fa, fq, mode, tmp, case, trim)
    assert records_of(sai) == (150 if case == "nrun" else 120)
    sam = samse_both(fa, tmp / f"{case}.sai", fq)
    # the long N runs leave most of their reads unmapped
    assert mapped(sam) > (40 if case == "nrun" else 80)
    if case.startswith("B5"):
        assert "\tBC:Z:" in sam


def test_cli_barcode_illumina64(adv_case, tmp_path):
    """`aln -B 5 -I -q 20` and `samse` through both CLIs in subprocesses,
    the port's with jax, ibwa_tpu and bench blocked: .sai and SAM
    byte-equal."""
    tmp, fa = adv_case
    outs = {}
    for package in ("ibwa_tpu", "ibwa_tpu_torch"):
        d = tmp_path / package
        d.mkdir()
        sai, sam = d / "r.sai", d / "r.sam"
        run_cli(package, ["aln", "-B", "5", "-I", "-q", "20", "--engine",
                          "native", str(fa), str(tmp / "bc64.fq"), "-f",
                          str(sai)], d)
        run_cli(package, ["samse", str(fa), str(sai), str(tmp / "bc64.fq"),
                          "-f", str(sam)], d)
        outs[package] = (sai.read_bytes(), sam.read_text())
    assert outs["ibwa_tpu_torch"] == outs["ibwa_tpu"]
    assert records_of(outs["ibwa_tpu"][0]) == 120
    assert mapped(outs["ibwa_tpu"][1]) > 80


# ---- BAM input (test_adversarial.py:114, test_bam.py) ---------------------

def test_bam_across_the_batch_seam(adv_case, monkeypatch):
    """test_bam_input_batch_seam's 90 records (Random(33)) with both
    packages' pipeline BATCH_SIZE at 32: three seams."""
    tmp, fa = adv_case
    rng = random.Random(33)
    seq = "".join(ln.strip() for ln in open(fa) if ln[0] != ">")
    records = []
    for i in range(90):
        pos = rng.randrange(0, len(seq) - 90)
        s = "".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                    for c in seq[pos:pos + 70]).replace("N", "A")
        flag = 0
        if rng.random() < 0.5:
            s = "".join(COMP[c] for c in reversed(s))
            flag = 0x10
        records.append((f"m{i}", flag, s, "I" * len(s)))
    bam = tmp / "seam.bam"
    write_bam(str(bam), records)
    monkeypatch.setattr(t_pipeline, "BATCH_SIZE", 32)
    monkeypatch.setattr(j_pipeline, "BATCH_SIZE", 32)
    sai = aln_three(fa, bam, MODE | BWA_MODE_BAM, tmp, "seam")
    assert records_of(sai) == 90


@pytest.fixture(scope="module")
def bam_case(tmp_path_factory):
    """bam_case's genome (30 kbp, seed 121) and its 60 paired records
    (Random(8): read1 / read2 in turns, half stored reverse-complemented
    with 0x10), then 30 single-end records of the same recipe
    (Random(9), flag 0 or 0x10), so that -0 selects reads too."""
    tmp = tmp_path_factory.mktemp("tin_bam")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("bchr", "", 30000, 0.0)], seed=121)
    t_builder.bwa_index(str(fa))
    seq = genome["bchr"]
    records = []
    for seed, n, paired in ((8, 60, True), (9, 30, False)):
        rng = random.Random(seed)
        for i in range(n):
            pos = rng.randrange(0, len(seq) - 80)
            s = "".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                        for c in seq[pos:pos + 75])
            flag = (0x40 if i % 2 == 0 else 0x80) if paired else 0
            if rng.random() < 0.5:
                s = "".join(COMP[c] for c in reversed(s))
                flag |= 0x10
            name = f"b{i}" if paired else f"s{i}"
            records.append((name, flag | (0x1 if paired else 0), s,
                            "I" * len(s)))
    bam = tmp / "r.bam"
    write_bam(str(bam), records)
    return tmp, fa, bam


BAM_FLAGS = {
    # the aln flag, its mode bit, the reads it selects
    "-0": (BWA_MODE_BAM_SE, 30),
    "-1": (BWA_MODE_BAM_READ1, 30),
    "-2": (BWA_MODE_BAM_READ2, 30),
}


@pytest.mark.parametrize("flag", list(BAM_FLAGS))
def test_bam_flag_filters(bam_case, flag):
    tmp, fa, bam = bam_case
    bit, n = BAM_FLAGS[flag]
    sai = aln_three(fa, bam, MODE | BWA_MODE_BAM | bit, tmp, f"bam{flag}")
    assert records_of(sai) == n


# ---- three dbs in sampe -R (test_adversarial.py:241) ---------------------

@pytest.fixture(scope="module")
def remap3_case(tmp_path_factory):
    """remap3_case's primary (c1 40 kbp + c2 15 kbp, seed 888) and two
    alternates with .remap CIGARs (Random(555)), indexed by the port, its
    160 pairs of 70 bp from all of them, and the .sai of both ends
    against each db by the port's native search."""
    tmp = tmp_path_factory.mktemp("tin_remap3")
    rng = random.Random(555)
    pfa = tmp / "p.fa"
    genome = make_genome(str(pfa), [("c1", "", 40000, 0.0),
                                    ("c2", "", 15000, 0.0)], seed=888)
    c1, c2 = genome["c1"], genome["c2"]
    alt1, cig1, stop1 = _make_alt(c1, 8000, [
        ("snp", 300, 0), ("del", 400, 2), ("ins", 350, 3),
        ("snp", 250, 0)], rng)
    a1fa = tmp / "alt1.fa"
    _write_fa(str(a1fa), [("a1", alt1)])
    with open(str(a1fa) + ".remap", "w") as f:
        f.write(f">x1-c1|{8000 + 1}|{stop1}\n")
        for i in range(0, len(cig1), 60):
            f.write(cig1[i:i + 60] + "\n")
    alt2, cig2, stop2 = _make_alt(c2, 3000, [
        ("snp", 200, 0), ("ins", 300, 2), ("del", 280, 1),
        ("snp", 150, 0)], rng)
    a2fa = tmp / "alt2.fa"
    _write_fa(str(a2fa), [("a2", alt2)])
    with open(str(a2fa) + ".remap", "w") as f:
        f.write(f">x2-c2|{3000 + 1}|{stop2}\n")
        for i in range(0, len(cig2), 60):
            f.write(cig2[i:i + 60] + "\n")
    fas = [pfa, a1fa, a2fa]
    for fa in fas:
        t_builder.bwa_index(str(fa))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = lambda s: "".join(comp[c] for c in reversed(s))
    fqs = (tmp / "r_1.fq", tmp / "r_2.fq")
    sources = [c1, c2, alt1, alt2]
    with open(fqs[0], "w") as o1, open(fqs[1], "w") as o2:
        for i in range(160):
            src = sources[i % len(sources)]
            isize = max(170, int(rng.gauss(250, 20)))
            pos = rng.randrange(0, len(src) - isize)
            frag = src[pos:pos + isize]
            r1, r2 = frag[:70], rc(frag[-70:])
            if rng.random() < 0.5:
                r1, r2 = r2, r1
            o1.write(f"@q{i}/1\n{r1}\n+\n{'I' * 70}\n")
            o2.write(f"@q{i}/2\n{r2}\n+\n{'I' * 70}\n")
    sais = []
    for j, fa in enumerate(fas):
        pair = []
        for e, fq in enumerate(fqs):
            out = tmp / f"d{j}e{e}.sai"
            with open(out, "wb") as f:
                _quiet(t_pipeline.aln_to_stream, str(fa), str(fq), GapOpt(),
                       f, engine="native")
            pair.append(str(out))
        sais.append(tuple(pair))
    return [str(f) for f in fas], sais, tuple(map(str, fqs))


@pytest.mark.parametrize("route", ["native", "device_cpu", "pure_py"])
def test_sampe_remap_three_dbs(remap3_case, route, monkeypatch):
    prefixes, sais, fqs = remap3_case
    if route == "pure_py":
        monkeypatch.setenv("IBWA_PURE_PY", "1")
    got, err = io.StringIO(), io.StringIO()
    with parity_scale.WalkRecorder(False) as rec, \
            contextlib.redirect_stderr(err):
        t_sai2sam_pe(prefixes, sais, *fqs, PeOpt(remapping=1), out=got,
                     device=CPU if route == "device_cpu" else None)
    want = io.StringIO()
    _quiet(j_sai2sam_pe, prefixes, sais, *fqs, JPeOpt(remapping=1),
           out=want)
    assert got.getvalue() == want.getvalue()
    assert mapped(got.getvalue()) > 250 and "\tZR:Z:" in got.getvalue()
    if route == "device_cpu":
        lens = [parity_scale.fasta_len(pathlib.Path(p)) for p in prefixes]
        assert [c[0].fm.seq_len for c in rec.calls] == lens
        lines, last = _prefill_lines(err.getvalue())
        assert len(lines) == 1 and lines[0][0] > 0
        assert lines[0][3] == lines[0][4] == last == 0
    else:
        assert not rec.calls


# ---- hits at and above 2^31 into the .sai (C5) ---------------------------

HIGH = 1 << 31


def _high_hits(rng, n_reads: int, cap: int):
    """(meta, k, l) planes of n_reads reads with 0-cap hits each, k and l
    in [2^31, 2^32), and each read's count."""
    nh = rng.integers(0, cap + 1, n_reads)
    meta = (rng.integers(0, 6, (n_reads, cap))
            | rng.integers(0, 3, (n_reads, cap)) << 8
            | rng.integers(0, 3, (n_reads, cap)) << 16
            | rng.integers(0, 2, (n_reads, cap)) << 24)
    k = rng.integers(HIGH, 1 << 32, (n_reads, cap))
    ln = np.minimum(k + rng.integers(0, 50, (n_reads, cap)), (1 << 32) - 1)
    return np.stack([meta, k, ln], axis=-1).astype(np.int64), nh


def _sai_of(sai_mod, opt, results) -> bytes:
    buf = io.BytesIO()
    sai_mod.write_header(buf, opt)
    for hits in results:
        sai_mod.write_read_hits(buf, hits)
    return buf.getvalue()


def _want_sai(opt, planes, nh, scores) -> bytes:
    """The .sai by hand: the u32 words of each hit, little-endian."""
    out = [opt.pack()]
    for r, n in enumerate(nh):
        out.append(struct.pack("<i", int(n)))
        for j in range(n):
            meta, k, ln = (int(x) for x in planes[r, j])
            out.append(struct.pack("<IIIi", meta, k, ln, int(scores[r][j])))
    return b"".join(out)


def test_decode_hits_above_2_31(monkeypatch):
    """The device hit planes at and above 2^31 (int64, as the card's u32
    bits come down) through `engine._decode` and the port's writer give
    ibwa_tpu's writer's bytes, and the words by hand."""
    from ibwa_tpu.align.engine_ref import Hit as JHit
    from ibwa_tpu.io import sai as j_sai
    from ibwa_tpu_torch.io import sai as t_sai
    rng = np.random.default_rng(31)
    opt = GapOpt()
    planes, nh = _high_hits(rng, 40, 6)
    fb = rng.random(40) < 0.2
    nh_kept = np.where(fb, 0, nh)
    out = [[] for _ in range(40)]
    engine._decode(planes, nh, fb, opt, out, 0)
    scores = [[h.score for h in hits] for hits in out]
    got = _sai_of(t_sai, opt, out)
    j_hits = [[JHit(*dataclasses.astuple(h)) for h in hits]
              for hits in out]
    assert got == _sai_of(j_sai, JGapOpt(), j_hits)
    assert got == _want_sai(opt, planes, nh_kept, scores)
    assert min(h.k for hits in out for h in hits) >= HIGH


def test_native_align_batch_hits_above_2_31(monkeypatch):
    """The native search's u32 hit words at and above 2^31 (the search
    itself stubbed: no table here has 2^31 bases) through both packages'
    `native_align_batch` and writers: the same bytes, and the words by
    hand."""
    from ibwa_tpu import native as j_native
    from ibwa_tpu.io import sai as j_sai
    from ibwa_tpu_torch import native as t_native
    from ibwa_tpu_torch.io import sai as t_sai
    rng = np.random.default_rng(32)
    planes, nh = _high_hits(rng, 30, 5)
    scores = rng.integers(-5, 120, (30, 5))
    words = np.concatenate([planes, scores[..., None]], axis=-1)
    words = (words & 0xFFFFFFFF).astype(np.uint32)
    stub = lambda *a, **k: (words.copy(), nh.astype(np.int32))
    monkeypatch.setattr(t_native, "match_gap_batch", stub)
    monkeypatch.setattr(j_native, "match_gap_batch", stub)
    seqs, no_fms = [np.zeros(50, np.uint8)] * 30, (None, None)
    got = _sai_of(t_sai, GapOpt(),
                  engine.native_align_batch(no_fms, seqs, seqs, GapOpt()))
    want = _sai_of(j_sai, JGapOpt(),
                   engine_jax.native_align_batch(no_fms, seqs, seqs,
                                                 JGapOpt()))
    assert got == want
    assert got == _want_sai(GapOpt(), planes, nh, scores)


# ---- phase 4k's module at its tiny scale ---------------------------------

def test_input_routes_tiny_without_jax(tmp_path):
    """`python -m ibwa_tpu_torch.input_routes --device cpu --scale tiny`
    with jax, ibwa_tpu and bench blocked, the pipeline's batch lowered so
    that the BAM run crosses it: every route equal, one JSON line a
    route."""
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'ibwa_tpu', 'bench')\n"
        "for m in BLOCKED:\n"
        "    sys.modules[m] = None\n"
        "from ibwa_tpu_torch import input_routes\n"
        "from ibwa_tpu_torch.align import engine, pipeline\n"
        f"engine.DEV_BATCH = {LANES}\n"
        "pipeline.BATCH_SIZE = 32\n"
        "rc = input_routes.main(['--device', 'cpu', '--scale', 'tiny', "
        f"'--json', '--work', {str(tmp_path / 'w')!r}])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None "
        "and m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(ln) for ln in r.stdout.splitlines()]
    from ibwa_tpu_torch import input_routes
    assert [x["route"] for x in recs] == list(input_routes.ROUTES)
    assert all(x["equal"] for x in recs)
    for x in recs:
        if x["route"] in input_routes.ALN_ROUTES:
            assert x["device_reads"] > 0 and x["reads"] > 0
    bam = next(x for x in recs if x["route"] == "bam_seam")
    assert bam["batches"] >= 2
