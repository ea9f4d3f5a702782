"""`ibwa_tpu_torch/parity_scale.py` on the CPU, and what it exercises
across batch seams, held against `ibwa_tpu`.

The scale configurations' generators are seeded and deterministic; the
port's `aln`, `samse` and `sampe -R` across lowered batch sizes are
byte-equal to `ibwa_tpu`'s with the same batch sizes (the JAX package's
constants lowered by monkeypatch, not edited), so the drand48 draws carry
over each seam as the JAX package carries them; iterative_remap's two dbs
give the same `sampe -R` SAM in both packages; and the module itself runs
every configuration at `--scale tiny` on the CPU, in a process where
neither jax nor the JAX package can be imported.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ibwa_tpu.align import engine_jax
from ibwa_tpu.align import pipeline as j_pipeline
from ibwa_tpu.align.opts import GapOpt as JGapOpt
from ibwa_tpu.sam import bwase as j_bwase
from ibwa_tpu.sam import sampe as j_sampe

from ibwa_tpu_torch import cli, parity_scale
from ibwa_tpu_torch.align import engine, pipeline
from ibwa_tpu_torch.align.opts import GapOpt
from ibwa_tpu_torch.sam import bwase, sampe
from ibwa_tpu_torch.sam.remap import load_remap

from conftest import REPO

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY = parity_scale.SCALES["tiny"]
SEAM = 32              # the lowered batch size: 3 batches and a tail
SEAM_PAIRS = 3 * SEAM + 8


def _run(fn, *args, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(*args, out=out, **kw)
    return out.getvalue(), err.getvalue()


def _native_sai(fa, fq, path) -> str:
    with open(path, "wb") as f, contextlib.redirect_stderr(io.StringIO()):
        pipeline.aln_to_stream(str(fa), str(fq), GapOpt(), f,
                               engine="native")
    return str(path)


@pytest.fixture(scope="module")
def seam_inputs(tmp_path_factory):
    """The tiny ecoli genome, indexed, and SEAM_PAIRS pairs of it."""
    work = tmp_path_factory.mktemp("tscale_seam")
    fa, fqs = parity_scale.pairs_inputs(
        work, "ecoli", 20260817,
        lambda rng: parity_scale.random_seq(rng, TINY.ecoli_len), "U00096",
        SEAM_PAIRS)
    sais = [_native_sai(fa, fq, work / f"{e}.sai")
            for e, fq in enumerate(fqs)]
    return work, fa, fqs, sais


@pytest.fixture(scope="module")
def remap_inputs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tscale_remap")
    return work, parity_scale.remap_inputs(work, TINY)


# ---- (a) the generators ----------------------------------------------------

def test_full_scale_is_the_configurations_size():
    full = parity_scale.SCALES["full"]
    assert full.ecoli_pairs == 0x40000 + 16_384 > pipeline.BATCH_SIZE
    assert full.ecoli_pairs > sampe.BATCH and full.ecoli_pairs > bwase.BATCH
    assert (full.ecoli_len, full.repeat_len, full.primary_len) == (
        4_641_652, 32_000_000, 63_025_520)
    assert (full.tandem_copies, full.segdups, full.haplotypes,
            full.exact_contigs) == (4_000, 40, 24, 2)
    assert (full.repeat_pairs, full.remap_pairs, full.rate_pairs,
            full.option_reads, full.mixed_reads) == (
        40_000, 65_536, 32_768, 16_384, 16_384)
    assert full.wave_rows == 1 << 20


@pytest.mark.parametrize("make", ["repeat_rich", "genome"])
def test_genomes_are_seeded_with_their_tandem_array(make):
    """Same seed, same genome; another seed, another; the length asked
    for; the tandem unit repeated end to end (a run of bases equal to the
    base one unit before, over all but one copy)."""
    if make == "repeat_rich":
        fn = lambda rng: parity_scale.make_repeat_rich(
            rng, TINY.repeat_len, TINY.tandem_copies, TINY.segdups)
        length, unit, copies = TINY.repeat_len, 300, TINY.tandem_copies
    else:
        fn = lambda rng: parity_scale.make_genome(
            rng, TINY.primary_len, TINY.primary_tandem, TINY.primary_segdups)
        length, unit, copies = TINY.primary_len, 250, TINY.primary_tandem
    a, b = (fn(np.random.default_rng([7, 0])) for _ in range(2))
    c = fn(np.random.default_rng([8, 0]))
    assert len(a) == length and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert set(np.unique(a).tobytes()) <= set(b"ACGT")
    same = np.concatenate([[0], (a[unit:] == a[:-unit]).astype(np.int8), [0]])
    edges = np.flatnonzero(np.diff(same))
    assert (edges[1::2] - edges[0::2]).max() >= (copies - 1) * unit


def test_pairs_are_seeded_and_counted_by_record(seam_inputs, tmp_path):
    work, fa, fqs, _ = seam_inputs
    assert parity_scale.fasta_len(fa) == TINY.ecoli_len
    names = [parity_scale.fastq_records(fq) for fq in fqs]
    assert names[0] == names[1] == [b"p%d" % i for i in range(SEAM_PAIRS)]
    again = parity_scale.sim_pairs(np.random.default_rng([20260817, 1]),
                                   [parity_scale.random_seq(
                                       np.random.default_rng([20260817, 0]),
                                       TINY.ecoli_len)], [1.0], SEAM_PAIRS)
    for fq, mate in zip(fqs, again):
        out = tmp_path / fq.name
        parity_scale.write_fastq(out, b"p", mate)
        assert out.read_bytes() == fq.read_bytes()
    # a quality line may start with '@' or '+': records are 4 lines
    odd = tmp_path / "odd.fq"
    odd.write_bytes(b"@r0\nACGT\n+\n@+II\n@r1\nACGT\n+\n+III\n")
    assert parity_scale.fastq_records(odd) == [b"r0", b"r1"]


def test_alternate_reference_and_its_remap(remap_inputs):
    """The alternate's .remap parses with the port's load_remap, one
    record a contig: each haplotype's CIGAR spans its contig and its
    primary stretch, which equals the contig but for the SNPs; each exact
    contig is the primary's bases."""
    work, p = remap_inputs
    assert parity_scale.fasta_len(p["primary"]) == TINY.primary_len
    seqs = {}
    for fa in (p["primary"], p["alt"]):
        name = None
        for ln in open(fa, "rb").read().split(b"\n"):
            if ln[:1] == b">":
                name = ln[1:].decode()
                seqs[name] = []
            elif ln:
                seqs[name].append(ln)
    seqs = {k: b"".join(v) for k, v in seqs.items()}
    primary = seqs.pop("chr20")
    remap = load_remap(str(p["alt"]))
    assert len(remap) == len(seqs) == TINY.haplotypes + TINY.exact_contigs
    for i, (name, alt) in enumerate(seqs.items()):
        rec = remap[i]
        assert rec.target == "chr20"
        if name.startswith("exact"):
            assert rec.exact and alt in primary and len(alt) == \
                parity_scale.EXACT_LEN
            continue
        assert len(alt) == parity_scale.HAP_LEN
        ops = {op: sum(n for n, o in rec.cigar if o == op) for op in "MID"}
        assert ops["M"] + ops["I"] == len(alt)
        assert ops["M"] + ops["D"] == rec.stop - 1 - rec.start
        assert ops["I"] and ops["D"]
        a = r = diffs = 0
        for n, op in rec.cigar:
            if op == "M":
                seg_a = np.frombuffer(alt[a:a + n], np.uint8)
                seg_r = np.frombuffer(
                    primary[rec.start + r:rec.start + r + n], np.uint8)
                diffs += int((seg_a != seg_r).sum())
            a += n if op in "MI" else 0
            r += n if op in "MD" else 0
        assert len(alt) / 600 < diffs < len(alt) / 150   # a SNP ~300 bp


# ---- (b) aln across the seam --

def test_aln_across_batches_equals_jax(seam_inputs, monkeypatch):
    """The port's aln (torch engine on CPU tensors) over SEAM-read batches,
    device-only and hybrid (the hybrid's floor lowered so that each batch
    has a host share, which adapts between batches): .sai byte-equal to
    ibwa_tpu's aln_to_stream with the JAX engine at the same batch size;
    one `[aln] batch` line a batch."""
    work, fa, fqs, _ = seam_inputs
    monkeypatch.setattr(j_pipeline, "BATCH_SIZE", SEAM)
    monkeypatch.setattr(engine_jax, "DEV_BATCH", 64)
    monkeypatch.setattr(engine_jax, "PERSIST_N", 64)
    want = work / "jax.sai"
    with open(want, "wb") as f, contextlib.redirect_stderr(io.StringIO()):
        j_pipeline.aln_to_stream(str(fa), str(fqs[0]), JGapOpt(), f,
                                 engine="jax")
    monkeypatch.setattr(pipeline, "BATCH_SIZE", SEAM)
    monkeypatch.setattr(engine, "DEV_BATCH", 64)
    monkeypatch.setattr(engine, "HYBRID_MIN", 8)
    monkeypatch.setattr(engine, "HOST_CHUNK", 8)
    n_batches = -(-SEAM_PAIRS // SEAM)
    for route in ("device_only", "hybrid"):
        if route == "device_only":
            monkeypatch.setenv("IBWA_HOST_FRAC", "0")
        else:
            monkeypatch.delenv("IBWA_HOST_FRAC", raising=False)
        st = parity_scale.aln(fa, fqs[0], work / f"{route}.sai", route,
                              "cpu")
        assert (work / f"{route}.sai").read_bytes() == want.read_bytes()
        assert st["n_batches"] == len(st["batches"]) == n_batches
        assert [b["reads"] for b in st["batches"]] == \
            [SEAM] * (n_batches - 1) + [SEAM_PAIRS % SEAM]
        host = [b["host_reads"] for b in st["batches"]]
        assert (sum(host) == 0) == (route == "device_only"), host
        assert st["launches"] == {}


# ---- (c) samse and sampe across the seam ------------------------------------

def test_samse_across_batches_equals_jax(seam_inputs, monkeypatch):
    work, fa, fqs, sais = seam_inputs
    monkeypatch.setattr(bwase, "BATCH", SEAM)
    monkeypatch.setattr(j_bwase, "BATCH", SEAM)
    got, err = _run(bwase.sai2sam_se, str(fa), sais[0], str(fqs[0]))
    want, _ = _run(j_bwase.sai2sam_se, str(fa), sais[0], str(fqs[0]))
    assert got == want
    assert len(re.findall(r"\[samse\] \d+ sequences processed", err)) == \
        -(-SEAM_PAIRS // SEAM)
    names = [ln.split("\t")[0].encode() for ln in got.splitlines()
             if ln[:1] != "@"]
    assert names == parity_scale.fastq_records(fqs[0])


def test_sampe_across_batches_equals_jax(seam_inputs, monkeypatch):
    """The device route on CPU (K5's plain version) prefills every batch
    and leaves no walk to the host; the SAM equals ibwa_tpu's."""
    work, fa, fqs, sais = seam_inputs
    monkeypatch.setattr(sampe, "BATCH", SEAM)
    monkeypatch.setattr(j_sampe, "BATCH", SEAM)
    args = ([str(fa)], [tuple(sais)], str(fqs[0]), str(fqs[1]))
    got, err = _run(sampe.sai2sam_pe, *args, sampe.PeOpt(remapping=1),
                    device=CPU)
    want, _ = _run(j_sampe.sai2sam_pe, *args, j_sampe.PeOpt(remapping=1))
    assert got == want
    batches = parity_scale.prefill_lines(err)
    assert len(batches) == -(-SEAM_PAIRS // SEAM)
    assert all(b["rows"] > 0 and not b["host_walks"] and not b["refused"]
               for b in batches)
    assert "[sai2sam_pe] 0 host walks after the last prefill" in err


# ---- (d) iterative_remap's two dbs --

def test_iterative_remap_sampe_equals_jax(remap_inputs):
    work, p = remap_inputs
    dbs = [str(p["primary"]), str(p["alt"])]
    sais = [tuple(_native_sai(db, fq, work / f"{i}{e}.sai")
                  for e, fq in enumerate(p["fq"]))
            for i, db in enumerate(dbs)]
    fqs = tuple(map(str, p["fq"]))
    got, err = _run(sampe.sai2sam_pe, dbs, sais, *fqs,
                    sampe.PeOpt(remapping=1), device=CPU)
    want, _ = _run(j_sampe.sai2sam_pe, dbs, sais, *fqs,
                   j_sampe.PeOpt(remapping=1))
    assert got == want
    assert "\tZR:Z:" in got
    assert parity_scale.prefill_lines(err)[0]["host_walks"] == 0


# ---- (e) the module, tiny, in a process without jax --

def test_parity_scale_tiny_on_cpu_without_jax(tmp_path):
    code = (
        "import sys\n"
        "for m in ('jax', 'ibwa_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "from ibwa_tpu_torch import parity_scale\n"
        "rc = parity_scale.main(['--device', 'cpu', '--scale', 'tiny', "
        f"'--json', '--work', {str(tmp_path)!r}])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "m.split('.')[0] in ('jax', 'ibwa_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert [x["config"] for x in lines] == list(parity_scale.CONFIGS)
    assert all(x["equal"] and x["scale"] == "tiny" for x in lines)
    res = {x["config"]: x for x in lines}
    assert res["iterative_remap"]["sampe"]["zr_tags"] > 0
    assert all(w["waves"] >= 2 for w in res["repeat_pe"]["wave_check"])
    runs = res["aln_options"]["runs"]
    assert set(runs) == {*parity_scale.OPTION_SETS, "mixed"}
    assert all(runs[name]["acap"] == [1024]
               for name in parity_scale.WIDE_ARENA)
