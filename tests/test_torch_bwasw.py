"""The port's `bwasw` (`ibwa_tpu_torch/bwasw/`) against ibwa_tpu's.

Both packages index the same genome and align the same long reads; the
SAM text must be equal byte for byte.  The corpus and the option sets are
those of `tests/test_bwasw.py` (whose oracle is the reference binary;
here `ibwa_tpu` takes its place), and `tests/test_bwasw_device.py`'s
corpus, whose reads with N keep the staged driver's sequential path busy.
`--engine torch` runs with the seed extensions on a torch device: on the
CPU the glue runs K9's plain version (`ops/dp.py::extend_scan_plain`), and
with a minimum batch of 1 every batch goes through it.
"""

import contextlib
import io
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ibwa_tpu.bwasw.aux import bsw2_aln as j_bsw2_aln
from ibwa_tpu.bwasw.core import Bsw2Opt as JBsw2Opt
from ibwa_tpu.index import builder as jbuilder

from ibwa_tpu_torch import cli as tcli
from ibwa_tpu_torch.bwasw import dp_glue
from ibwa_tpu_torch.bwasw.aux import bsw2_aln as t_bsw2_aln
from ibwa_tpu_torch.bwasw.core import Bsw2Opt
from ibwa_tpu_torch.index import builder
from ibwa_tpu_torch.ops import dp

from conftest import REPO, make_genome

torch.set_num_threads(1)

# tests/test_bwasw.py's CASES: (flags, options)
CASES = {
    "default": ([], {}),
    "z10": (["-z", "10"], {"z": 10}),
    "pacbioish": (["-b", "5", "-q", "2", "-r", "1", "-z", "4"],
                  {"b": 5, "q": 2, "r": 1, "z": 4}),
    "hardclip": (["-H"], {"hard_clip": 1}),
}
EXT_LINE = re.compile(
    r"\[bsw2_aln\] extensions: (\d+) jobs in (\d+) batches on (\S+) \((\d+) "
    r"launches\), (\d+) on the host \(gate (\d+), under the minimum (\d+), "
    r"empty (\d+)\); (\d+) jobs in all")
NATIVE_LINE = re.compile(r"\[bsw2_aln\] extensions: (\d+) jobs, all on the "
                         r"host \(engine native; empty (\d+)\)")


def _opt(cls, case):
    opt = cls(**CASES[case][1])
    opt.t *= opt.a
    opt.coef *= opt.a
    return opt


def _run(fn, *args, **kw):
    """(SAM text, stderr) of one bwasw run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(*args, out=out, **kw)
    return out.getvalue(), err.getvalue()


def _ext_counts(err: str) -> tuple:
    """The extension line's numbers; they must add up."""
    m = EXT_LINE.search(err)
    assert m, err[-2000:]
    jobs, batches, _, launches, host, gate, small, empty, total = (
        int(x) if x.isdigit() else x for x in m.groups())
    assert host == gate + small + empty
    assert jobs + host == total
    return jobs, batches, launches, gate, small, empty


@pytest.fixture(scope="module")
def long_case(tmp_path_factory):
    """tests/test_bwasw.py's corpus: a 45 kbp contig with Ns and a 15 kbp
    one, 20 reads of 250-700 bp with substitutions and indels, half
    reverse-complemented, ~10% with an N; indexed by both packages."""
    tmp = tmp_path_factory.mktemp("tbwasw")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("lr1", "", 45000, 0.001),
                                   ("lr2", "", 15000, 0.0)], seed=616)
    jfa = tmp / "g_jax.fa"
    jfa.write_bytes(fa.read_bytes())
    builder.bwa_index(str(fa))
    jbuilder.bwa_index(str(jfa))
    rng = random.Random(99)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    fq = tmp / "long.fq"
    with open(fq, "w") as f:
        for i in range(20):
            ctg = rng.choice(list(genome))
            src = genome[ctg]
            ln = rng.randrange(250, 700)
            pos = rng.randrange(0, len(src) - ln)
            out = []
            for ch in src[pos:pos + ln]:
                r = rng.random()
                if r < 0.012:
                    continue
                out.append(ch if rng.random() > 0.02
                           else rng.choice("ACGT"))
                if r > 0.988:
                    out.append(rng.choice("ACGT"))
            s = "".join(out)
            if rng.random() < 0.5:
                s = "".join(comp[c] for c in reversed(s))
            if rng.random() < 0.1:  # occasional N
                p = rng.randrange(len(s))
                s = s[:p] + "N" + s[p + 1:]
            f.write(f"@L{i}\n{s}\n+\n{'I' * len(s)}\n")
    return fa, jfa, fq, {}


def _want(long_case, case):
    """ibwa_tpu's SAM of a case, made once."""
    _, jfa, fq, cache = long_case
    if case not in cache:
        cache[case] = _run(j_bsw2_aln, _opt(JBsw2Opt, case), str(jfa),
                           str(fq))[0]
    return cache[case]


@pytest.mark.parametrize("engine", ["native", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwasw_equals_ibwa_tpu(long_case, case, engine):
    """SAM byte-equal to ibwa_tpu's for every option set of
    tests/test_bwasw.py; on the torch route every batch (minimum 1) runs
    the plain version of K9 and the job counts add up."""
    fa, _, fq, _ = long_case
    got, err = _run(t_bsw2_aln, _opt(Bsw2Opt, case), str(fa), str(fq),
                    engine=engine, device="cpu", min_jobs=1)
    want = _want(long_case, case)
    assert got == want
    assert sum(1 for ln in got.splitlines() if ln[0] != "@") >= 20
    if engine == "torch":
        jobs, batches, launches, gate, small, empty = _ext_counts(err)
        assert jobs > 0 and batches > 0 and small == 0 and launches == 0
    else:
        assert NATIVE_LINE.search(err), err[-2000:]
    assert dp_glue._active is None


def test_bwasw_pure_py_equals_ibwa_tpu(long_case, monkeypatch):
    """IBWA_PURE_PY=1: the Python pipeline (core.py's oracle, host
    extensions), equal to ibwa_tpu's SAM; it says so and installs no
    device route."""
    fa, _, fq, _ = long_case
    want = _want(long_case, "default")
    monkeypatch.setenv("IBWA_PURE_PY", "1")
    monkeypatch.setattr(dp, "extend_jobs", None)   # never called
    got, err = _run(t_bsw2_aln, _opt(Bsw2Opt, "default"), str(fa), str(fq),
                    device="cpu")
    assert got == want
    assert "IBWA_PURE_PY=1: the Python pipeline, seed extensions on the " \
        "host" in err


@pytest.fixture(scope="module")
def device_corpus(tmp_path_factory):
    """tests/test_bwasw_device.py's corpus: 60 long reads with errors and
    indels over two contigs, every 17th with an N."""
    tmp = tmp_path_factory.mktemp("tbswdev")
    fa = tmp / "g.fa"
    genome = make_genome(fa, [("c1", "", 60000, 0.0), ("c2", "", 25000, 0.0)],
                         seed=77)
    jfa = tmp / "g_jax.fa"
    jfa.write_bytes(fa.read_bytes())
    builder.bwa_index(str(fa))
    jbuilder.bwa_index(str(jfa))
    rng = np.random.default_rng(5)
    items = list(genome.items())
    comp = str.maketrans("ACGTN", "TGCAN")
    fq = tmp / "long.fq"
    with open(fq, "w") as f:
        for i in range(60):
            name, s = items[rng.integers(0, len(items))]
            L = int(rng.integers(200, 900))
            p = int(rng.integers(0, len(s) - L))
            r = list(s[p:p + L])
            for _ in range(L // 40):
                r[rng.integers(0, len(r))] = "ACGT"[rng.integers(0, 4)]
            if rng.random() < 0.5 and len(r) > 30:
                q = int(rng.integers(10, len(r) - 10))
                if rng.random() < 0.5:
                    del r[q:q + int(rng.integers(1, 6))]
                else:
                    r[q:q] = ["ACGT"[rng.integers(0, 4)]
                              for _ in range(int(rng.integers(1, 6)))]
            if i % 17 == 0:
                r[int(rng.integers(0, len(r)))] = "N"
            rs = "".join(r)
            if rng.random() < 0.5:
                rs = rs.translate(comp)[::-1]
            f.write(f"@L{i}\n{rs}\n+\n{'I' * len(rs)}\n")
    return fa, jfa, fq


def test_staged_equals_sequential(device_corpus):
    """The staged driver (a segment's extensions in one batch) and the
    sequential one (read by read) give the same SAM, equal to ibwa_tpu's,
    with no device route installed; the reads with N run sequentially."""
    fa, jfa, fq = device_corpus
    want = _run(j_bsw2_aln, JBsw2Opt(), str(jfa), str(fq))[0]
    staged, err = _run(t_bsw2_aln, Bsw2Opt(), str(fa), str(fq),
                       engine="native")
    seq, _ = _run(t_bsw2_aln, Bsw2Opt(), str(fa), str(fq), engine="native",
                  staged=False)
    assert staged == seq == want
    assert re.search(r"\[bsw2_aln\] stages: core [\d.]+ s, extensions "
                     r"[\d.]+ s \(device route 0\.0000 s, host loop [\d.]+ "
                     r"s\), cigar [\d.]+ s, all [\d.]+ s", err)


def test_device_route_on_staged_batches(device_corpus):
    """The torch route at the default minimum: the staged batches (and
    only those of at least 64 jobs) go to the device, SAM equal to the
    host loop's; the reads with N give batches under the minimum."""
    fa, _, fq = device_corpus
    host = _run(t_bsw2_aln, Bsw2Opt(), str(fa), str(fq), engine="native")[0]
    got, err = _run(t_bsw2_aln, Bsw2Opt(), str(fa), str(fq), device="cpu")
    assert got == host
    jobs, batches, launches, gate, small, empty = _ext_counts(err)
    assert batches >= 1 and jobs >= 64 and small > 0


def test_failing_callback_raises(long_case, monkeypatch):
    """A batch that fails on the device route fails the run with that
    batch's exception; no record of the chunk is written, and the route
    is uninstalled."""
    fa, _, fq, _ = long_case

    class Boom(Exception):
        pass

    def boom(*a, **k):
        raise Boom("the device route failed")

    monkeypatch.setattr(dp, "extend_jobs", boom)
    out = io.StringIO()
    with pytest.raises(Boom), contextlib.redirect_stderr(io.StringIO()):
        t_bsw2_aln(_opt(Bsw2Opt, "default"), str(fa), str(fq), out=out,
                   device="cpu", min_jobs=1)
    assert all(ln.startswith("@SQ") for ln in out.getvalue().splitlines())
    assert dp_glue._active is None


def test_native_after_torch_hands_nothing_over(long_case, monkeypatch):
    """The extension hook is one global of the native library: a native
    run after a torch run in the same process must not reach the device
    route (every batch on the host loop)."""
    fa, _, fq, _ = long_case
    opt = _opt(Bsw2Opt, "default")
    _, err = _run(t_bsw2_aln, opt, str(fa), str(fq), device="cpu",
                  min_jobs=1)
    assert _ext_counts(err)[0] > 0
    calls = []
    monkeypatch.setattr(dp, "extend_jobs",
                        lambda *a, **k: calls.append(1))
    got, err = _run(t_bsw2_aln, opt, str(fa), str(fq), engine="native")
    assert not calls
    assert got == _want(long_case, "default")
    assert re.search(r"device route 0\.0000 s", err)


def test_cuda_without_a_card_raises(long_case):
    """`--device cuda` needs a card: without one the run raises before
    it writes anything, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the route would run on it")
    fa, _, fq, _ = long_case
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bsw2_aln(_opt(Bsw2Opt, "default"), str(fa), str(fq), out=out)
    assert out.getvalue() == ""
    assert dp_glue._active is None


def test_cli_bwasw_never_imports_the_jax_package(long_case, tmp_path):
    """`bwasw --device cpu` and `--engine native` through the CLI, in a
    process where `jax`, `ibwa_tpu` and `bench` cannot be imported, with
    the JAX package's switches of the device route set (the port never
    reads them); SAM equal to ibwa_tpu's."""
    fa, _, fq, _ = long_case
    outs = [tmp_path / "torch.sam", tmp_path / "native.sam"]
    code = (
        "import sys\n"
        "for m in ('jax', 'ibwa_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "from ibwa_tpu_torch import cli\n"
        f"rc = cli.main(['bwasw', '--device', 'cpu', {str(fa)!r}, "
        f"{str(fq)!r}, '-f', {str(outs[0])!r}])\n"
        f"rc += cli.main(['bwasw', '--engine', 'native', {str(fa)!r}, "
        f"{str(fq)!r}, '-f', {str(outs[1])!r}])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "m.split('.')[0] in ('jax', 'ibwa_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), IBWA_BSW_DEVICE="1",
               IBWA_EXT_DEV_MIN="1", IBWA_BSW2_STAGED="0")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = _want(long_case, "default")
    assert outs[0].read_text() == outs[1].read_text() == want
    assert re.search(r"on cpu \(0 launches\)", r.stderr)
    assert "bwasw" in tcli.COMMANDS


def test_bwasw_ab_module(tmp_path):
    """`python -m ibwa_tpu_torch.bwasw_ab`'s parts: the smoke's long-read
    recipe (lengths 400 to 999, well-formed records) and the staged /
    sequential comparison with the core's section timers, its SAM equal
    to a native run's."""
    from ibwa_tpu_torch import bwasw_ab
    fa = tmp_path / "g.fa"
    make_genome(fa, [("c1", "", 40000, 0.0)], seed=41)
    builder.bwa_index(str(fa))
    fq = bwasw_ab.make_long_reads(fa, 12, tmp_path / "long.fq")
    lines = fq.read_text().splitlines()
    assert len(lines) == 48 and lines[0] == "@L0"
    assert all(400 <= len(s) < 1000 for s in lines[1::4])
    assert all(len(q) == len(s) for q, s in zip(lines[3::4], lines[1::4]))
    res = bwasw_ab.staged_ab(str(fa), str(fq), 1, profile=True)
    want = _run(t_bsw2_aln, Bsw2Opt(), str(fa), str(fq), engine="native")[0]
    assert res["sam"] == want.encode()
    for side in ("sequential", "staged"):
        (run,) = res[side]
        assert run["wall_s"] > 0 and run["core_fill"] > 0
        assert run["device_route"] == 0
