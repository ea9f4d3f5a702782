"""The port's `aln` slice end to end on the CPU: `ibwa_tpu_torch aln
--device cpu` writes a .sai byte-equal to ibwa_tpu's `aln` with the JAX
engine, for single-end reads and for both ends of paired-end reads, and
the port's whole path (`index`, `aln` through `run_search_persistent`,
which on CPU tensors is the phased loop over `search_steps`, the SA walker)
runs in a process where neither jax nor the JAX package can be imported."""

import os
import random
import subprocess
import sys

import pytest
import torch

from ibwa_tpu.align import pipeline as jax_pipeline
from ibwa_tpu.align.opts import GapOpt

from ibwa_tpu_torch import cli
from ibwa_tpu_torch.align import engine

from conftest import REPO, make_genome

# small tensors: one intra-op thread (the suite runs files in parallel
# workers, and more threads only spin)
torch.set_num_threads(1)

LANES = 64   # CPU-sized persistent lanes (the card's default is 1024)


COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def _jax_sai(fa, fq) -> bytes:
    out = fq.with_suffix(".jax.sai")
    with open(out, "wb") as f:
        jax_pipeline.aln_to_stream(str(fa), str(fq), GapOpt(), f,
                                   engine="jax")
    return out.read_bytes()


@pytest.fixture(scope="module")
def genome_index(tmp_path_factory):
    """A fresh seeded genome with N runs, indexed."""
    from ibwa_tpu.index import builder
    tmp = tmp_path_factory.mktemp("taln")
    fa = tmp / "g.fa"
    genome = make_genome(fa, [("chrA", "test", 30000, 0.0005),
                              ("chrB", "", 12000, 0.0)], seed=20261016)
    builder.bwa_index(str(fa))
    return tmp, fa, genome


@pytest.fixture(scope="module")
def aln_inputs(genome_index):
    """SE reads with N bases and variable lengths (all <= 100 bp, so the
    JAX engine compiles once)."""
    tmp, fa, genome = genome_index
    rng = random.Random(77)
    comp = COMP
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for i in range(96):
            name = rng.choice(sorted(genome))
            seq = genome[name]
            n = 100 if i % 4 == 0 else rng.randrange(40, 101)
            pos = rng.randrange(0, len(seq) - n)
            s = list(seq[pos:pos + n])
            for j in range(n):
                if rng.random() < 0.015:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.2:
                s[rng.randrange(n)] = "N"
            if rng.random() < 0.5:
                s = [comp[c] for c in reversed(s)]
            f.write(f"@q{i}\n{''.join(s)}\n+\n{'I' * n}\n")
    return fa, fq, _jax_sai(fa, fq)


@pytest.fixture(scope="module")
def pe_inputs(genome_index):
    """Paired-end reads as `aln` takes them, one FASTQ per end: 96
    fragments of 180-320 bp, end 1 from the fragment's start, end 2 the
    reverse complement of its end, 100 bp each (the SE batch's shape, so
    the JAX engine does not compile again), with substitutions and a few
    N bases.  Returns the index and, per end, its FASTQ and the JAX
    package's .sai."""
    tmp, fa, genome = genome_index
    rng = random.Random(78)
    ends = [[], []]
    for i in range(96):
        seq = genome[rng.choice(sorted(genome))]
        frag = rng.randrange(180, 321)
        pos = rng.randrange(0, len(seq) - frag)
        s = seq[pos:pos + frag]
        pair = [list(s[:100]), [COMP[c] for c in reversed(s[-100:])]]
        for e, r in enumerate(pair):
            for j in range(100):
                if rng.random() < 0.015:
                    r[j] = rng.choice("ACGT")
            if rng.random() < 0.1:
                r[rng.randrange(100)] = "N"
            ends[e].append(f"@p{i}/{e + 1}\n{''.join(r)}\n+\n{'I' * 100}\n")
    out = []
    for e in (0, 1):
        fq = tmp / f"pe_{e + 1}.fq"
        fq.write_text("".join(ends[e]))
        out.append((fq, _jax_sai(fa, fq)))
    return fa, out


def test_aln_sai_byte_equal_to_jax(aln_inputs, tmp_path, monkeypatch):
    fa, fq, want = aln_inputs
    monkeypatch.setattr(engine, "DEV_BATCH", LANES)
    out = tmp_path / "torch.sai"
    assert cli.main(["aln", "--device", "cpu", str(fa), str(fq),
                     "-f", str(out)]) == 0
    got = out.read_bytes()
    assert len(got) > 64 + 4 * 96        # header + one count per read
    assert got == want


@pytest.mark.parametrize("end", [1, 2])
def test_aln_sai_byte_equal_to_jax_paired_end(pe_inputs, tmp_path,
                                              monkeypatch, end):
    fa, per_end = pe_inputs
    fq, want = per_end[end - 1]
    monkeypatch.setattr(engine, "DEV_BATCH", LANES)
    out = tmp_path / f"torch_{end}.sai"
    assert cli.main(["aln", "--device", "cpu", str(fa), str(fq),
                     "-f", str(out)]) == 0
    got = out.read_bytes()
    assert len(got) > 64 + 4 * 96        # header + one count per read
    assert got == want


def test_port_never_imports_jax(aln_inputs, tmp_path):
    """Import the port and run its `index`, its `aln` (which must go
    through `engine.launch_search`: on CUDA tensors that call is the
    `width_pass` and `search_chunk` launches, on the CPU tensors here the
    plain version, the phased loop over `engine.search_steps`) and one
    `DeviceWalker.resolve` with
    `jax`, `ibwa_tpu` and `bench` blocked: any import of one of them (or of
    a module that imports one) fails the run."""
    fa, fq, want = aln_inputs
    out = tmp_path / "nojax.sai"
    prefix = tmp_path / "own" / "g"
    prefix.parent.mkdir()
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'ibwa_tpu', 'bench')\n"
        "for m in BLOCKED:\n"
        "    sys.modules[m] = None\n"
        "import ibwa_tpu_torch, ibwa_tpu_torch.__main__, ibwa_tpu_torch.cli\n"
        "import ibwa_tpu_torch.convert, ibwa_tpu_torch.kernels\n"
        "import ibwa_tpu_torch.bench_chase, ibwa_tpu_torch.simulate\n"
        "import numpy as np\n"
        "from ibwa_tpu_torch.align import engine\n"
        "from ibwa_tpu_torch.fm.fmindex import FmIndex\n"
        "from ibwa_tpu_torch.fm.walk import DeviceWalker\n"
        "from ibwa_tpu_torch.index.builder import load_index\n"
        f"engine.DEV_BATCH = {LANES}\n"
        "calls, steps = [], engine.search_steps\n"
        "engine.search_steps = lambda *a: (calls.append(a[-1]), "
        "steps(*a))[1]\n"
        "chunks, run = [], engine.launch_search\n"
        "engine.launch_search = lambda *a, **k: "
        "(chunks.append(k['n_lanes']), run(*a, **k))[1]\n"
        "from ibwa_tpu_torch import cli\n"
        f"rc = cli.main(['index', '-p', {str(prefix)!r}, {str(fa)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = cli.main(['aln', '--device', 'cpu', {str(prefix)!r}, "
        f"{str(fq)!r}, '-f', {str(out)!r}])\n"
        f"fms = [FmIndex(load_index({str(prefix)!r}, s)) for s in (0, 1)]\n"
        "assert calls and set(calls) == {engine.SWITCH_K}, calls\n"
        f"assert chunks == [{LANES}], chunks\n"
        "rows = np.arange(0, fms[0].seq_len + 1, 97, dtype=np.uint32)\n"
        "strand = (np.arange(len(rows)) % 2).astype(np.uint32)\n"
        "got = DeviceWalker(fms[0], fms[1], 'cpu').resolve(strand, rows)\n"
        "sa = [fms[int(s)].sa_at(int(k)) & 0xFFFFFFFF "
        "for s, k in zip(strand, rows)]\n"
        "assert got.tolist() == sa\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None "
        "and m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert out.read_bytes() == want
