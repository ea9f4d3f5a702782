"""The port's own copies of the host code against ibwa_tpu's originals.

`ibwa_tpu_torch` imports nothing of `ibwa_tpu`: it keeps a copy of the
index build, the read and .sai I/O, the search emulator, the native C++
library and the libc RNG.  Each copy must give what its original gives on
the same inputs: index files byte for byte, reads field by field, hits
tuple by tuple.  Exact comparison throughout.
"""

import dataclasses
import io
import os
import random
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ibwa_tpu import native as jnative
from ibwa_tpu import rng as jrng
from ibwa_tpu.align import engine_ref as jref
from ibwa_tpu.align.opts import GapOpt as JGapOpt
from ibwa_tpu.fm.fmindex import FmIndex as JFmIndex
from ibwa_tpu.index import builder as jbuilder
from ibwa_tpu.io import reads as jreads
from ibwa_tpu.io import sai as jsai

from ibwa_tpu_torch import cli as tcli
from ibwa_tpu_torch import native as tnative
from ibwa_tpu_torch import rng as trng
from ibwa_tpu_torch.align import engine_ref as tref
from ibwa_tpu_torch.align.opts import GapOpt as TGapOpt
from ibwa_tpu_torch.fm.fmindex import FmIndex as TFmIndex
from ibwa_tpu_torch.index import builder as tbuilder
from ibwa_tpu_torch.io import reads as treads
from ibwa_tpu_torch.io import sai as tsai

from conftest import REPO, make_genome, simulate_reads
from test_torch_tools import (TOOL_COMMANDS, check_command,  # noqa: F401
                              tool_src, write_stdsw_inputs)

EXTS = ("pac", "rpac", "ann", "amb", "bwt", "rbwt", "sa", "rsa")


@pytest.fixture(scope="module")
def host_inputs(tmp_path_factory):
    """A 42 kbp two-contig genome with N runs, indexed once by each
    package under its own prefix, and a FASTQ whose reads carry an N and
    low-quality tails (for trimming)."""
    tmp = tmp_path_factory.mktemp("thost")
    fa = tmp / "g.fa"
    genome = make_genome(fa, [("chrA", "test", 30000, 0.0005),
                              ("chrB", "", 12000, 0.0)], seed=20261017)
    jfa = tmp / "j" / "g.fa"
    jfa.parent.mkdir()
    shutil.copy(fa, jfa)
    jbuilder.bwa_index(str(jfa))
    assert tcli.main(["index", str(fa)]) == 0
    rng = random.Random(5)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for i in range(24):
            name = rng.choice(sorted(genome))
            seq = genome[name]
            n = rng.randrange(50, 91)
            pos = rng.randrange(0, len(seq) - n)
            s = list(seq[pos:pos + n])
            for j in range(n):
                if rng.random() < 0.02:
                    s[j] = rng.choice("ACGT")
            if i % 5 == 0:
                s[rng.randrange(n)] = "N"
            if rng.random() < 0.5:
                s = [comp[c] for c in reversed(s)]
            tail = rng.randrange(0, 12)
            qual = "I" * (n - tail) + "#" * tail
            f.write(f"@q{i}/1\n{''.join(s)}\n+\n{qual}\n")
    return fa, jfa, fq


def _tuples(results):
    return [[dataclasses.astuple(h) for h in hits] for hits in results]


def _fms(cls, builder, fa):
    return (cls(builder.load_index(str(fa), 0)),
            cls(builder.load_index(str(fa), 1)))


@pytest.mark.parametrize("ext", EXTS)
def test_index_files_byte_equal(host_inputs, ext):
    fa, jfa, _ = host_inputs
    got = open(f"{fa}.{ext}", "rb").read()
    assert len(got) > 0
    assert got == open(f"{jfa}.{ext}", "rb").read()


def test_load_index_fields_equal(host_inputs):
    fa, jfa, _ = host_inputs
    for strand in (0, 1):
        t = tbuilder.load_index(str(fa), strand)
        j = jbuilder.load_index(str(jfa), strand)
        assert (t.primary, t.seq_len, t.sa_intv) == \
            (j.primary, j.seq_len, j.sa_intv)
        np.testing.assert_array_equal(t.L2, j.L2)
        np.testing.assert_array_equal(t.interleaved, j.interleaved)
        np.testing.assert_array_equal(t.sa, j.sa)


@pytest.mark.parametrize("trim_qual", [0, 20])
def test_load_reads_fields_equal(host_inputs, trim_qual):
    _, _, fq = host_inputs
    got = treads.load_reads(str(fq), trim_qual=trim_qual)
    want = jreads.load_reads(str(fq), trim_qual=trim_qual)
    assert len(got) == len(want) == 24
    if trim_qual:
        assert any(r.clip_len < r.full_len for r in got)
    assert any((r.orig > 3).any() for r in got)          # an N survives
    for g, w in zip(got, want):
        assert (g.name, g.qual, g.full_len, g.clip_len, g.bc) == \
            (w.name, w.qual, w.full_len, w.clip_len, w.bc)
        for field in ("seq", "rseq", "orig"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))


def test_search_hits_and_sai_bytes_equal(host_inputs):
    """engine_ref.align_batch and native.match_gap_batch of both packages
    on the same reads, and the .sai both writers make of the hits."""
    fa, jfa, fq = host_inputs
    tfms = _fms(TFmIndex, tbuilder, fa)
    jfms = _fms(JFmIndex, jbuilder, jfa)
    reads = treads.load_reads(str(fq))
    seqs = [r.seq for r in reads]
    rseqs = [r.rseq for r in reads]
    topt, jopt = TGapOpt(), JGapOpt()
    assert dataclasses.astuple(topt) == dataclasses.astuple(jopt)
    assert topt.pack() == jopt.pack()

    got = tref.align_batch(tfms, seqs, rseqs, topt)
    want = jref.align_batch(jfms, seqs, rseqs, jopt)
    assert _tuples(got) == _tuples(want)
    assert sum(1 for hits in got if hits) >= 12

    md = np.full(len(seqs), 4, dtype=np.int32)
    sl = np.full(len(seqs), 32, dtype=np.int32)
    th, tn = tnative.match_gap_batch(tfms[0], tfms[1], seqs, rseqs, md, sl,
                                     topt)
    jh, jn = jnative.match_gap_batch(jfms[0], jfms[1], seqs, rseqs, md, sl,
                                     jopt)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(th, jh)
    assert int(tn.max()) > 0

    bufs = []
    for sai, opt, results in ((tsai, topt, got), (jsai, jopt, want)):
        buf = io.BytesIO()
        sai.write_header(buf, opt)
        for hits in results:
            sai.write_read_hits(buf, hits)
        bufs.append(buf.getvalue())
    assert len(bufs[0]) > 64 + 4 * len(seqs)
    assert bufs[0] == bufs[1]
    # and the port's reader gives the hits back
    path = fa.parent / "t.sai"
    path.write_bytes(bufs[0])
    assert _tuples(tsai.iter_sai(str(path))) == _tuples(got)


def test_native_sa_lookup_equal(host_inputs):
    fa, jfa, _ = host_inputs
    t = tbuilder.load_index(str(fa), 0)
    j = jbuilder.load_index(str(jfa), 0)
    ks = np.random.default_rng(2).integers(0, t.seq_len + 1, 500).astype(
        np.uint32)
    got = tnative.sa_lookup(t.interleaved, t.primary, t.L2, t.seq_len,
                            t.sa_intv, t.sa, ks)
    want = jnative.sa_lookup(j.interleaved, j.primary, j.L2, j.seq_len,
                             j.sa_intv, j.sa, ks)
    np.testing.assert_array_equal(got, want)
    fm = TFmIndex(t)
    assert [int(v) for v in got[:50]] == \
        [fm.sa_at(int(k)) & 0xFFFFFFFF for k in ks[:50]]


def test_rand48_streams_equal():
    for seed in (0, 11, 0xFFFFFFFF):
        t, j = trng.Rand48(seed), jrng.Rand48(seed)
        assert [t.lrand48() for _ in range(8)] == \
            [j.lrand48() for _ in range(8)]
        assert [t.drand48() for _ in range(8)] == \
            [j.drand48() for _ in range(8)]
        np.testing.assert_array_equal(t.lrand48_array(1000),
                                      j.lrand48_array(1000))
        np.testing.assert_array_equal(t.drand48_array(1000),
                                      j.drand48_array(1000))
        assert t.x == j.x


def test_simulated_genome_equals_the_harness_recipe(monkeypatch):
    """`simulate.make_genome` gives the genome of `bench.py::make_genome`
    from the same seed (at 2 Mbp here; the smoke run uses 32 Mbp)."""
    import bench
    from ibwa_tpu_torch import simulate
    assert simulate.GENOME_LEN == bench.GENOME_LEN
    n = 2_000_000
    monkeypatch.setattr(bench, "GENOME_LEN", n)
    want = bench.make_genome(random.Random(20261016))
    got = simulate.make_genome(random.Random(20261016), n)
    assert len(got) == n and got == want


def test_native_library_builds_outside_the_package():
    tnative.load()
    pkg = REPO / "ibwa_tpu_torch"
    assert not list(pkg.rglob("*.so"))
    assert list((REPO / "build" / "ibwa_tpu_torch").glob(
        "libibwa_native_*.so"))


@pytest.mark.parametrize("cmd", TOOL_COMMANDS)
def test_unported_commands_return_2(cmd, tool_src, tmp_path):
    """The eleven commands that were not ported before the tools' slice:
    each now runs, and `python -m ibwa_tpu_torch <cmd>` (jax and ibwa_tpu
    blocked) writes what `python -m ibwa_tpu <cmd>` writes on the same
    inputs, stdout and files byte-equal."""
    assert cmd in tcli.COMMANDS
    check_command(cmd, tool_src, tmp_path)


def test_load_read_batch_fields_equal(host_inputs):
    """The flat-blob FASTQ loader of the SAM stages (`ibwa_fastq_scan` of
    `native/src/sam_text.cpp`)."""
    _, _, fq = host_inputs
    got = treads.load_read_batch(str(fq))
    want = jreads.load_read_batch(str(fq))
    assert got.n == want.n == 24
    for f in ("name_blob", "name_off", "orig_blob", "orig_off", "qual_blob",
              "qual_off", "lens", "fulls"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for i in (0, 5, 23):
        g, w = got.read(i), want.read(i)
        assert (g.name, g.qual) == (w.name, w.qual)
        np.testing.assert_array_equal(g.rseq, w.rseq)


def test_cli_never_imports_the_jax_package(host_inputs, tmp_path):
    """A tool (`stdsw`, its alignment text equal to ibwa_tpu's), and
    `index`, `aln`, `samse`,
    `sampe -R --device cpu` (K5's plain version prefilling the SA walks)
    and `sampe -R --engine native` (no prefill, whatever IBWA_PE_DEVICE
    says) run, in a process where `ibwa_tpu`, `jax` and `bench` cannot be
    imported; the SAM text equals ibwa_tpu's on the same .sai."""
    fa, jfa, fq = host_inputs
    prefix = fa.parent / "sub" / "g"
    prefix.parent.mkdir()
    genome, name = {}, None
    for line in fa.read_text().splitlines():
        if line.startswith(">"):
            name = line[1:].split()[0]
            genome[name] = ""
        else:
            genome[name] += line
    fq1, fq2 = simulate_reads(str(tmp_path / "pe"), genome, 40, read_len=70,
                              seed=12, paired=True)
    sai, sai1, sai2, se, pe, pe_host = (tmp_path / n for n in (
        "r.sai", "1.sai", "2.sai", "se.sam", "pe.sam", "pe_host.sam"))
    write_stdsw_inputs(tmp_path, random.Random(3))
    p = str(prefix)
    code = (
        "import sys\n"
        "for m in ('jax', 'ibwa_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "import ibwa_tpu_torch.sam.bwase, ibwa_tpu_torch.sam.cs2nt\n"
        "import ibwa_tpu_torch.sam.dbset, ibwa_tpu_torch.sam.pe_native\n"
        "import ibwa_tpu_torch.sam.remap, ibwa_tpu_torch.sam.sampe\n"
        "from ibwa_tpu_torch import cli\n"
        f"rc = cli.main(['stdsw', {str(tmp_path / 'target.fa')!r}, "
        f"{str(tmp_path / 'query.fa')!r}])\n"
        "sys.stdout.flush()\n"
        f"rc2 = cli.main(['index', '-p', {p!r}, {str(fa)!r}])\n"
        f"rc2 += cli.main(['aln', '--engine', 'native', {p!r}, {str(fq)!r},"
        f" '-f', {str(sai)!r}])\n"
        f"rc2 += cli.main(['samse', {p!r}, {str(sai)!r}, {str(fq)!r}, '-f',"
        f" {str(se)!r}])\n"
        f"for q, s in (({fq1!r}, {str(sai1)!r}), ({fq2!r}, {str(sai2)!r})):\n"
        f"    rc2 += cli.main(['aln', '--engine', 'native', {p!r}, q, '-f', "
        "s])\n"
        f"rc2 += cli.main(['sampe', '-R', '--device', 'cpu', {p!r}, "
        f"{str(sai1)!r}, {str(sai2)!r}, {fq1!r}, {fq2!r}, '-f', "
        f"{str(pe)!r}])\n"
        "import contextlib, io\n"
        "err = io.StringIO()\n"
        "with contextlib.redirect_stderr(err):\n"
        f"    rc2 += cli.main(['sampe', '-R', '--engine', 'native', {p!r}, "
        f"{str(sai1)!r}, {str(sai2)!r}, {fq1!r}, {fq2!r}, '-f', "
        f"{str(pe_host)!r}])\n"
        "assert 'prefill' not in err.getvalue(), err.getvalue()\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "m.split('.')[0] in ('jax', 'ibwa_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "sys.exit(10 * rc + rc2)\n")
    # the reference's switch of the device walks: the port never reads it
    env = dict(os.environ, PYTHONPATH=str(REPO), IBWA_PE_DEVICE="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    from ibwa_tpu.tools.stdsw import stdsw
    want_sw = io.StringIO()
    stdsw(str(tmp_path / "target.fa"), str(tmp_path / "query.fa"),
          out=want_sw)
    # stdsw's alignment text is all that the run writes to stdout
    assert r.stdout == want_sw.getvalue() != ""
    assert re.search(r"\[sai2sam_pe\] prefill [1-9]\d* rows", r.stderr)
    for ext in EXTS:
        assert open(f"{prefix}.{ext}", "rb").read() == \
            open(f"{fa}.{ext}", "rb").read()
    from ibwa_tpu.sam.bwase import sai2sam_se
    from ibwa_tpu.sam.sampe import PeOpt, sai2sam_pe
    want_se, want_pe = io.StringIO(), io.StringIO()
    sai2sam_se(str(jfa), str(sai), str(fq), out=want_se)
    sai2sam_pe([str(jfa)], [(str(sai1), str(sai2))], fq1, fq2,
               PeOpt(remapping=1), out=want_pe)
    assert se.read_text() == want_se.getvalue()
    assert pe.read_text() == pe_host.read_text() == want_pe.getvalue()
    mapped = [ln for ln in pe.read_text().splitlines()
              if ln[0] != "@" and not int(ln.split("\t")[1]) & 4]
    assert len(mapped) > 40
