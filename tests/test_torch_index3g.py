"""`ibwa_tpu_torch/index_3gbp.py` on the CPU, held against
`scripts/index_3gbp.py` and `ibwa_tpu`.

The generator writes the script's FASTA byte for byte; the port's frugal
packed-text index path gives the artifacts of its SA-IS path and of
`ibwa_tpu.index.builder.bwa_index`; the module's large-table configuration
runs at a tiny size in a process where neither jax nor the JAX package
can be imported, its device routes byte-equal to `--engine native`, and
mate 1's `.sai` on its 32-contig genome equals `ibwa_tpu`'s `aln`; and
the walker carries SA values at and above 2^31 as u32.
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import os
import resource
import subprocess
import sys

import numpy as np
import pytest
import torch

from ibwa_tpu.align import pipeline as j_pipeline
from ibwa_tpu.align.opts import GapOpt as JGapOpt
from ibwa_tpu.index import builder as j_builder

from ibwa_tpu_torch import index_3gbp, native
from ibwa_tpu_torch.fm import walk
from ibwa_tpu_torch.fm.fmindex import FmIndex
from ibwa_tpu_torch.index import builder
from ibwa_tpu_torch.u32 import MASK, from_bits

from conftest import REPO, make_genome

torch.set_num_threads(1)

TINY_GBP = 0.005       # 5 Mbp: at or above 2^22 bases, so ACAP 256 as on
TINY_PAIRS = 24        # the card
HIGH = 0x80000000
ARTIFACTS = index_3gbp.ARTIFACTS


def _script():
    spec = importlib.util.spec_from_file_location(
        "index_3gbp_script", REPO / "scripts" / "index_3gbp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- (a) the generator --

def test_gen_fasta_equals_script(tmp_path):
    n = 2_000_000
    ours, theirs = tmp_path / "ours.fa", tmp_path / "theirs.fa"
    index_3gbp.gen_fasta(ours, n)
    _script().gen_fasta(theirs, n)
    assert ours.read_bytes() == theirs.read_bytes()
    contigs = index_3gbp.read_contigs(ours)
    assert [c for c, _ in contigs] == [f"chr{i}" for i in range(1, 33)]
    assert all(len(s) == n // 32 for _, s in contigs)


# ---- (b) the frugal path --

def _fasta(path):
    """tests/test_index.py::test_frugal_bwt_matches_sais's two contigs: a
    random one and one with a run of N."""
    rng = np.random.RandomState(77)
    bases = np.array(list("ACGT"))
    seq1 = "".join(bases[rng.randint(0, 4, 40011)])
    seq2 = ("".join(bases[rng.randint(0, 4, 503)]) + "N" * 7
            + "".join(bases[rng.randint(0, 4, 9000)]))
    path.write_text(f">c1\n{seq1}\n>c2 two\n{seq2}\n")


def test_frugal_path_equals_sais_and_jax(tmp_path, monkeypatch):
    sais, frugal, jax_fa = (tmp_path / f"{n}.fa"
                            for n in ("sais", "frugal", "jax"))
    for fa in (sais, frugal, jax_fa):
        _fasta(fa)
    assert index_3gbp.index_path(sais) == "sais"
    builder.bwa_index(str(sais))
    j_builder.bwa_index(str(jax_fa))
    monkeypatch.setenv("IBWA_FRUGAL_MIN", "1")
    # through the module: a child process, the path by builder.py's rule
    report = index_3gbp.index(frugal, 49_521, say=lambda msg: None)
    assert report["path"] == "frugal"
    assert report["bases"] == 49_521 and report["under_16gb"]
    # the child's own peak, not this process's (which has jax and torch)
    assert report["max_rss_gb"] * 1e6 < resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    for ext in ARTIFACTS:
        assert report["artifacts_bytes"][ext] == os.path.getsize(
            f"{sais}.{ext}")
        assert filecmp.cmp(f"{frugal}.{ext}", f"{sais}.{ext}",
                           shallow=False), ext
        assert filecmp.cmp(f"{jax_fa}.{ext}", f"{sais}.{ext}",
                           shallow=False), ext


# ---- (c), (d) the module, tiny, in a process without jax --

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("ti3g")
    code = (
        "import sys\n"
        "for m in ('jax', 'ibwa_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "from ibwa_tpu_torch import index_3gbp\n"
        f"rc = index_3gbp.main(['--gbp', '{TINY_GBP}', '--align', "
        f"'--device', 'cpu', '--pairs', '{TINY_PAIRS}', '--json', "
        f"'--work', {str(work)!r}])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        "m.split('.')[0] in ('jax', 'ibwa_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=work,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return work, json.loads(r.stdout.splitlines()[-1]), r.stderr


def test_module_tiny_on_cpu_without_jax(tiny_run):
    work, res, err = tiny_run
    assert res["device"] == "cpu" and res["path"] == "sais"
    assert res["bases"] == int(TINY_GBP * 1e9) // 32 * 32
    for e in (1, 2):
        native_sai = (work / f"end{e}.native.sai").read_bytes()
        for route in index_3gbp.ROUTES:
            assert (work / f"end{e}.{route}.sai").read_bytes() == native_sai
            st = res["aln"][e - 1][route]
            assert st["acap"] == [256] and st["launches"] == {}
            assert st["reads"] == TINY_PAIRS
    assert "ACAP 256" in err
    assert ((work / "pairs.k5.sam").read_bytes()
            == (work / "pairs.host.sam").read_bytes())
    pe = res["sampe"]
    assert pe["records"] == 2 * TINY_PAIRS and pe["contigs"] > 1
    assert all(b["host_walks"] == 0 and b["refused"] == 0
               for b in pe["batches"])
    assert set(res["rates"]) == {"device_only", "hybrid", "native"}
    assert all(r["readings"] == index_3gbp.ROUNDS
               for r in res["rates"].values())
    mem = res["memory"]
    assert mem["blocks_bytes"] > 0 and mem["sampled_bytes"] > 0
    assert mem["aln_max_allocated"] is None    # no card: not measured
    assert res["launches"] == {}


def test_mate1_sai_equals_jax_aln(tiny_run):
    work = tiny_run[0]
    out = io.BytesIO()
    with contextlib.redirect_stderr(io.StringIO()):
        j_pipeline.aln_to_stream(str(work / "huge.fa"), str(work / "end1.fq"),
                                 JGapOpt(), out)
    assert out.getvalue() == (work / "end1.device_only.sai").read_bytes()


# ---- (e) SA values at and above 2^31 through the walker --

@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    fa = tmp_path_factory.mktemp("ti3g_walk") / "g.fa"
    make_genome(fa, [("c1", "", 20000, 0.0), ("c2", "", 9000, 0.0)],
                seed=1203)
    builder.bwa_index(str(fa))
    return [builder.load_index(str(fa), s) for s in (0, 1)]


def test_walker_values_above_2_31(small_index):
    idx = small_index
    fms = [FmIndex(i) for i in idx]
    rng = np.random.default_rng(1203)
    n = fms[0].seq_len
    ks = rng.integers(1, n + 1, 300).astype(np.uint32)   # row 0: SA -1
    ls = np.minimum(ks + rng.integers(0, 4, 300), n).astype(np.uint32)
    strand = rng.integers(0, 2, 300).astype(np.uint32)
    # the true values by the native host walk, row by row
    rows = np.concatenate([np.arange(k, l + 1) for k, l in zip(ks, ls)])
    row_strand = np.repeat(strand, ls.astype(np.int64) - ks + 1)
    true = np.empty(len(rows), dtype=np.uint32)
    for s in (0, 1):       # device strand s walks idx[s]
        sel = row_strand == s
        true[sel] = native.sa_lookup(
            idx[s].interleaved, idx[s].primary, idx[s].L2, idx[s].seq_len,
            idx[s].sa_intv, idx[s].sa, rows[sel].astype(np.uint32))
    assert int(true.max()) < HIGH
    want = (true.astype(np.uint64) + HIGH).astype(np.uint32)

    flat = walk.DeviceWalker(fms[0], fms[1], "cpu")
    shifted = walk.DeviceWalker.from_table(
        flat.fm, [(np.asarray(f.sa, np.uint64) + HIGH).astype(np.uint32)
                  for f in fms], fms[0].sa_intv)
    off, vals = shifted.resolve_intervals(strand, ks, ls)
    assert vals.dtype == np.uint32
    np.testing.assert_array_equal(vals, want)
    assert int(vals.min()) >= HIGH

    # the plain version: u32 bit patterns in int32, the true values + 2^31
    iv = torch.from_numpy(np.stack([strand, ks]).view(np.int32))
    bits, stats = walk.resolve_intervals_plain(
        flat.fm, shifted.sampled, iv, torch.from_numpy(off), 0, len(rows),
        fms[0].sa_intv - 1)
    assert bits.dtype == torch.int32 and int(stats[0]) == len(rows)
    got = from_bits(bits)
    assert int(got.min()) >= HIGH and int(got.max()) <= MASK
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---- (f) an index kept between runs (--reuse), and the two index paths --

def _stamps(work):
    return {ext: os.stat(work / f"huge.fa.{ext}").st_mtime_ns
            for ext in ARTIFACTS}


def test_reuse_keeps_only_a_matching_index(tmp_path):
    work, quiet = tmp_path / "w", (lambda msg: None)
    first = index_3gbp.run(0.001, work=work, say=quiet, reuse=True)
    assert not first["reused"] and (work / index_3gbp.RECORD).is_file()
    stamps = _stamps(work)
    (work / "end1.native.sai").write_bytes(b"an earlier run's")
    again = index_3gbp.run(0.001, work=work, say=quiet, reuse=True)
    assert again["reused"] and _stamps(work) == stamps
    assert again["fasta_sha256"] == first["fasta_sha256"]
    assert not (work / "end1.native.sai").exists()
    # the same size, other bytes: the FASTA's hash differs, so it is made
    # and indexed anew
    fa = work / "huge.fa"
    raw = bytearray(fa.read_bytes())
    at = raw.index(b"\n") + 1
    raw[at] = ord("C") if raw[at] != ord("C") else ord("G")
    fa.write_bytes(bytes(raw))
    third = index_3gbp.run(0.001, work=work, say=quiet, reuse=True)
    assert not third["reused"] and _stamps(work) != stamps
    assert third["fasta_sha256"] == first["fasta_sha256"]
    # another size: made and indexed anew
    stamps = _stamps(work)
    fourth = index_3gbp.run(0.0012, work=work, say=quiet, reuse=True)
    assert not fourth["reused"] and fourth["bases"] == 1_200_000
    assert _stamps(work) != stamps
    # without --reuse the index is always made anew
    assert not index_3gbp.run(0.0012, work=work, say=quiet)["reused"]


def test_compare_paths_byte_equal(tmp_path):
    res = index_3gbp.compare_paths(0.0005, tmp_path, say=lambda msg: None)
    assert res["equal"] and res["sais"]["bases"] == 500_000
    for path in ("sais", "frugal"):
        assert res[path]["index_wall_s"] >= 0 and res[path]["max_rss_gb"] > 0
