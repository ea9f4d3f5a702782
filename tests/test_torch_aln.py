"""The port's `aln` slice end to end on the CPU: `ibwa_tpu_torch aln
--device cpu` writes a .sai byte-equal to ibwa_tpu's `aln` with the JAX
engine, and the port's whole path (`index`, `aln`, the SA walker) runs in a
process where neither jax nor the JAX package can be imported."""

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


@pytest.fixture(scope="module")
def aln_inputs(tmp_path_factory):
    """A fresh seeded genome with N runs, and SE reads with N bases and
    variable lengths (all <= 100 bp, so the JAX engine compiles once)."""
    from ibwa_tpu.index import builder
    tmp = tmp_path_factory.mktemp("taln")
    fa = tmp / "g.fa"
    genome = make_genome(fa, [("chrA", "test", 30000, 0.0005),
                              ("chrB", "", 12000, 0.0)], seed=20261016)
    builder.bwa_index(str(fa))
    rng = random.Random(77)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
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
    jax_sai = tmp / "jax.sai"
    with open(jax_sai, "wb") as out:
        jax_pipeline.aln_to_stream(str(fa), str(fq), GapOpt(), out,
                                   engine="jax")
    return fa, fq, jax_sai.read_bytes()


def test_aln_sai_byte_equal_to_jax(aln_inputs, tmp_path, monkeypatch):
    fa, fq, want = aln_inputs
    monkeypatch.setattr(engine, "DEV_BATCH", LANES)
    out = tmp_path / "torch.sai"
    assert cli.main(["aln", "--device", "cpu", str(fa), str(fq),
                     "-f", str(out)]) == 0
    got = out.read_bytes()
    assert len(got) > 64 + 4 * 96        # header + one count per read
    assert got == want


def test_port_never_imports_jax(aln_inputs, tmp_path):
    """Import the port and run its `index`, its `aln` and one
    `DeviceWalker.resolve` with `jax`, `ibwa_tpu` and `bench` blocked: any
    import of one of them (or of a module that imports one) fails the run."""
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
        "from ibwa_tpu_torch import cli\n"
        f"rc = cli.main(['index', '-p', {str(prefix)!r}, {str(fa)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = cli.main(['aln', '--device', 'cpu', {str(prefix)!r}, "
        f"{str(fq)!r}, '-f', {str(out)!r}])\n"
        f"fms = [FmIndex(load_index({str(prefix)!r}, s)) for s in (0, 1)]\n"
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
