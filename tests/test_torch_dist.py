"""`ibwa_tpu_torch/dist_aln.py`, the counterpart of `scripts/dist_aln.py`,
on the CPU.

Its inputs are `scripts/parity_scale.py`'s recipe byte for byte (the
script's functions loaded by path, its `main` not run); `split_fastq`
makes equal contiguous shards and refuses a count that does not divide;
two workers on the CPU over a small genome give a merged `.sai` byte-equal
to one worker over the whole FASTQ, to `--engine native` and to
`ibwa_tpu`'s `aln_to_stream` with the JAX engine (exact bytes), with the
parent run where neither jax, the JAX package nor `bench` can be imported,
and one worker run alone under the same block; a worker that fails makes
the parent exit 1 with no record; a card asked for where there is none
raises before anything is made.
"""

import contextlib
import importlib.util
import io
import json
import random
import subprocess
import sys

import pytest
import torch

from ibwa_tpu.align import engine_jax
from ibwa_tpu.align import pipeline as j_pipeline
from ibwa_tpu.align.opts import GapOpt as JGapOpt

from ibwa_tpu_torch import dist_aln

from conftest import REPO

torch.set_num_threads(1)

N_READS = 200          # 100 a worker
GENOME_LEN = 50_000
BLOCKED = "('jax', 'ibwa_tpu', 'bench')"
BLOCK = ("import sys\n"
         f"for m in {BLOCKED}:\n"
         "    sys.modules[m] = None\n")
CHECK_BLOCKED = ("bad = [m for m in sys.modules if sys.modules[m] is not None"
                 f" and m.split('.')[0] in {BLOCKED}]\n"
                 "assert not bad, bad\n")


def _script():
    spec = importlib.util.spec_from_file_location(
        "parity_scale_script", REPO / "scripts" / "parity_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fastq(path, n):
    path.write_bytes(b"".join(b"@r%d\nACGT\n+\nIIII\n" % i
                              for i in range(n)))


def test_inputs_equal_parity_scale_script(tmp_path):
    """Genome, both pair files and the single-end reads byte-equal to the
    script's functions called in its main's order on one Random(20260817),
    at the script's genome length."""
    n = 12
    s = _script()
    theirs = tmp_path / "script"
    theirs.mkdir()
    rng = random.Random(20260817)
    s.write_fa(theirs / "ecoli.fa", [("U00096", s.make_ecoli(rng))])
    seq = "".join(ln.strip() for ln in
                  (theirs / "ecoli.fa").read_text().splitlines()[1:])
    s.sim_reads(str(theirs / f"ecoli_pe{n}"), seq, n, rng)
    s.sim_reads(str(theirs / f"ecoli_se{n}"), seq, n, rng, paired=False)
    fa, fq = dist_aln.write_inputs(tmp_path / "port", n)
    assert fq.name == f"ecoli_se{n}.fq"
    for name in ("ecoli.fa", f"ecoli_pe{n}_1.fq", f"ecoli_pe{n}_2.fq",
                 f"ecoli_se{n}.fq"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (theirs / name).read_bytes()), name
    assert len(seq) == dist_aln.GENOME_LEN


def test_split_fastq(tmp_path):
    """Contiguous shards of equal read counts whose concatenation is the
    input; a count that the shards do not divide, and a file that is not
    whole records, are refused."""
    src = tmp_path / "r.fq"
    _fastq(src, 12)
    shards = dist_aln.split_fastq(src, 3, tmp_path / "s")
    assert [p.name for p in shards] == ["shard0.fq", "shard1.fq",
                                        "shard2.fq"]
    assert [p.read_bytes().count(b"\n") for p in shards] == [16] * 3
    assert b"".join(p.read_bytes() for p in shards) == src.read_bytes()
    assert shards[1].read_bytes().startswith(b"@r4\n")
    with pytest.raises(ValueError, match="equal"):
        dist_aln.split_fastq(src, 5, tmp_path / "t")
    src.write_bytes(src.read_bytes() + b"@r12\nACGT\n")
    with pytest.raises(ValueError, match="whole records"):
        dist_aln.split_fastq(src, 2, tmp_path / "u")


def test_merge_sai_cuts_headers_and_refuses_a_different_one(tmp_path):
    parts = [tmp_path / f"{i}.sai" for i in range(3)]
    for i, p in enumerate(parts):
        p.write_bytes(b"H" * 64 + bytes([i]) * 4)
    assert dist_aln.merge_sai(parts) == b"H" * 64 + b"\0" * 4 + b"\1" * 4 \
        + b"\2" * 4
    parts[2].write_bytes(b"h" * 64)
    assert dist_aln.merge_sai(parts) is None


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """The parent with two workers on the CPU over a small genome, jax,
    ibwa_tpu and bench blocked in the parent: (work dir, inputs, record)."""
    work = tmp_path_factory.mktemp("dist")
    with contextlib.redirect_stderr(io.StringIO()):
        inp = dist_aln.ensure_inputs(work, N_READS, genome_len=GENOME_LEN)
    code = (BLOCK + "from ibwa_tpu_torch import dist_aln\n"
            f"rc = dist_aln.main(['--reads', '{N_READS}', '--procs', '2', "
            f"'--device', 'cpu', '--work', {str(work)!r}, '--json'])\n"
            + CHECK_BLOCKED + "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return work, inp, json.loads(r.stdout.strip().splitlines()[-1])


def test_two_workers_equal_one_process_native_and_jax(cpu_run, monkeypatch):
    work, inp, rec = cpu_run
    assert rec["ok"] and rec["merged_sai_identical"]
    assert rec["native_sai_identical"]
    assert rec["n_processes"] == 2 and rec["devices"] == ["cpu", "cpu"]
    assert rec["reads"] == N_READS and rec["device"] == "cpu"
    assert rec["genome_len"] == GENOME_LEN
    assert [p["reads"] for p in rec["per_process"]] == [N_READS // 2] * 2
    assert rec["single_process"]["reads"] == N_READS
    for p in rec["per_process"] + [rec["single_process"]]:
        assert p["launches"] == {} and p["host_reads"] == 0
        assert p["device_reads"] + p["fallback_reads"] == p["reads"]
        assert sum(p["fallback_by_cause"].values()) == p["fallback_reads"]
        assert p["chunks"] == 1 and p["peak_mem_bytes"] is None
    assert rec["aggregate_reads_per_s"] == N_READS / rec["wall_s_2proc"]
    d = work / str(N_READS)
    merged = (d / "p2" / "merged.sai").read_bytes()
    assert merged == (d / "p1" / "shard0.sai").read_bytes()
    assert merged == (d / "native.sai").read_bytes()
    # ibwa_tpu's aln, the JAX engine on the CPU as its own tests run it
    monkeypatch.setattr(engine_jax, "PALLAS_STACK", False)
    monkeypatch.setattr(engine_jax, "DEV_BATCH", 64)
    monkeypatch.setattr(engine_jax, "PERSIST_N", 640)
    want = io.BytesIO()
    with contextlib.redirect_stderr(io.StringIO()):
        j_pipeline.aln_to_stream(str(inp["fa"]), str(inp["fq"]), JGapOpt(),
                                 want, engine="jax")
    assert merged == want.getvalue()


def test_worker_without_jax(cpu_run, tmp_path):
    """One worker as the parent starts it, in an interpreter where jax,
    ibwa_tpu and bench are blocked: `ready`, then after `go` its record as
    the last line and a .sai equal to shard 1 of the parent's run."""
    work, inp, _ = cpu_run
    shard = work / str(N_READS) / "p2" / "shard1.fq"
    out = tmp_path / "w.sai"
    code = (BLOCK + "import runpy\n"
            "sys.argv = ['dist_aln', '--worker', '1', '--prefix', "
            f"{str(inp['fa'])!r}, '--fq', {str(shard)!r}, '--out', "
            f"{str(out)!r}, '--device', 'cpu']\n"
            "try:\n"
            "    runpy.run_module('ibwa_tpu_torch.dist_aln', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            + CHECK_BLOCKED + "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], input="go\n",
                       capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "ready"
    rec = json.loads(lines[-1])
    assert rec["pid"] == 1 and rec["reads"] == N_READS // 2
    assert {"seconds", "reads_per_s", "search_s", "fallback_by_cause",
            "launches"} <= set(rec)
    assert out.read_bytes() == shard.with_suffix(".sai").read_bytes()


def test_failing_worker_exits_1(tmp_path, monkeypatch, capsys):
    """A shard that is not there: its worker exits 1, and the parent exits
    1 and prints no record."""
    dist_aln.ensure_inputs(tmp_path, N_READS, genome_len=GENOME_LEN)
    split = dist_aln.split_fastq

    def missing_second(src, n, out):
        shards = split(src, n, out)
        if n > 1:
            shards[1].unlink()
        return shards

    monkeypatch.setattr(dist_aln, "split_fastq", missing_second)
    rc = dist_aln.main(["--reads", str(N_READS), "--device", "cpu",
                        "--work", str(tmp_path), "--json"])
    assert rc == 1
    out = capsys.readouterr()
    assert '"ok": true' not in out.out and not out.out.strip()
    assert "worker 1 exited 1" in out.err


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu,cuda:0"])
def test_cuda_without_a_card_raises(tmp_path, device):
    """A card asked for on a machine without one raises before any input
    is made or any worker started: nothing carries on on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_aln.main(["--device", device, "--work", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
