"""The harness's parts on the CPU: inputs from the seed, the rate, the
trace's reduction, K6's byte count, the result line, the refusal without a
card, the import check, and the reference against the program at a tiny
size."""

import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import (devtrace, harness, refaln, refcheck, refindex, sim,
                       spec, yardstick)
from benchmark.recipes.make_genome import make_genome

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _reads(seed: int, genome: np.ndarray) -> np.ndarray:
    return sim.sim_single(np.random.default_rng([seed, 0]), genome, 200,
                          100, 0.02, 0.001, 0.15, 0.3, 0.5)


def test_sim_bytes_repeat_per_seed_and_differ_across_seeds(tmp_path):
    genome = make_genome(np.random.default_rng(3), 50_000, 10, 1)
    again = make_genome(np.random.default_rng(3), 50_000, 10, 1)
    assert genome.tobytes() == again.tobytes()
    files = []
    for i, seed in enumerate((2**31 + 77, 2**31 + 77, 5)):
        fq = tmp_path / f"{i}.fq"
        sim.write_fastq(fq, b"r", _reads(seed, genome))
        files.append(fq.read_bytes())
    assert files[0] == files[1]
    assert files[0] != files[2]
    reads = _reads(9, genome)
    assert reads.shape == (200, 100) and set(np.unique(reads)) <= set(b"ACGT")


def _view(shards, seconds=10.0, trace=None, traced_s=0.0):
    done = [s for s in shards if s["end"] <= seconds]
    return harness.View(None, shards, done,
                        max((s["end"] for s in done), default=0.0), {},
                        trace, traced_s)


@pytest.mark.parametrize("metric", ["aln_reads_per_s", "pairs_per_s"])
def test_shard_rate_on_a_synthetic_timeline(metric):
    shards = [{"index": i, "units": 100, "start": 3.0 * i,
               "end": 3.0 * (i + 1)} for i in range(4)]   # the 4th ends at 12
    rate = spec.reader(metric).read(_view(shards))
    assert rate == pytest.approx(300 / 9.0)
    assert spec.reader(metric).read(_view(shards[3:])) is None


def test_idle_share_from_a_trace_with_overlapping_ops():
    ops = [devtrace.Op("a", 1.0, 3.0), devtrace.Op("b", 2.0, 4.0),
           devtrace.Op("c", 6.0, 7.0), devtrace.Op("d", 6.5, 6.8)]
    assert devtrace.busy_seconds(ops) == pytest.approx(4.0)
    assert devtrace.gaps(ops, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                             (7.0, 10.0)]
    host = [devtrace.Op("aten::copy_", 4.5, 5.5)]
    one = devtrace.Trace(ops, host, [])
    assert one.named_gaps(0.8, 8.0) == [
        (0.8, 1.0, "host code outside torch"), (4.0, 6.0, "aten::copy_"),
        (7.0, 8.0, "host code outside torch")]
    named = [devtrace.Op(f"shard 0 aln0: {n}", a, b)
             for a, b, n in one.named_gaps(0.8, 8.0)]
    spans = [devtrace.Op("shard 0 aln0: process start and imports",
                         0.0, 0.8),
             devtrace.Op("shard 0 aln0: main", 0.8, 8.0)]
    tr = devtrace.Window(0.0, 10.0, ops, named, spans)
    idle = spec.reader("device_idle_share.aln").read(
        _view([], trace=tr, traced_s=10.0))
    assert idle == pytest.approx(60.0)
    assert tr.idle_gaps() == [["harness", 3.0],
                              ["shard 0 aln0: aten::copy_", 2.0],
                              ["shard 0 aln0: process start and imports",
                               1.0]]
    assert tr.device_ops()[0] == ["a", 2.0]
    tr.excluded = [devtrace.Op("profiler start", 7.0, 9.0)]
    assert tr.seconds() == pytest.approx(8.0)
    assert tr.idle_gaps()[0] == ["shard 0 aln0: aten::copy_", 2.0]


def test_kernel_ms_scales_seen_launches_to_counted():
    ops = [devtrace.Op("void width_pass_kernel<1>", 0.0, 0.002),
           devtrace.Op("void width_pass_kernel<1>", 1.0, 1.004)]
    tr = devtrace.Window(0.0, 2.0, ops, [], [])
    ms = tr.kernel_ms({"width_pass": "width_pass_kernel",
                       "search_chunk": "search_chunk_kernel"},
                      {"width_pass": 3, "search_chunk": 5})
    assert ms == {"width_pass": pytest.approx(9.0)}


def _hand_rows(fm, seq: np.ndarray) -> set:
    """bwt_cal_width's occ queries, one at a time: the rows of bwa's .bwt
    each reads."""
    rows, k, l = set(), 0, fm.seq_len
    for c in (int(x) for x in seq):
        for q in ((k - 1 if k > 0 else -1), l):
            if c < 4 and 0 <= q < fm.seq_len:
                rows.add((q - (q >= fm.primary)) // 128)
        if c < 4:
            nk = fm.L2[c] + fm.occ(k - 1 if k > 0 else refindex.NEG1, c) + 1
            nl = fm.L2[c] + fm.occ(l, c)
        if c > 3 or nk > nl:
            k, l = 0, fm.seq_len
        else:
            k, l = nk, nl
    return rows


def test_width_pass_bytes_against_a_hand_count(tmp_path):
    import torch
    genome = make_genome(np.random.default_rng(4), 40_000, 10, 1)
    refindex.build(sim.CODE[genome], tmp_path, "cpu")
    fms = refindex.load(tmp_path)
    reads = _reads(6, genome)[:5]
    reads[0, 50] = ord("N")
    seqs, rseqs = zip(*(refaln.read_codes(r) for r in reads))
    want = 0
    for fm, strand in zip(fms, (seqs, rseqs)):
        rows = set()
        for s in strand:
            rows |= _hand_rows(fm, s) | _hand_rows(fm, s[100 - 32:])
        want += len(rows) * 48
    want += 5 * 2 * (100 + 32) + 5 * 2 * (101 + 33) * 8
    tens = tuple(yardstick.strand_tensors(fm, "cpu") for fm in fms)
    got = yardstick.width_pass_bytes(
        tens, torch.from_numpy(np.stack(seqs)),
        torch.from_numpy(np.stack(rseqs)), 32, fms[0].seq_len)
    assert got == want


def test_foreign_modules_by_whole_top_level_name():
    names = ["ibwa_tpu_torch", "ibwa_tpu_torch.cli", "ibwa_tpu.fm",
             "jaxlib.xla", "jax", "jax_helpers", "flax", "flaxen", "numpy"]
    assert harness.foreign_modules(names) == ["flax", "ibwa_tpu.fm", "jax",
                                              "jaxlib.xla"]


def test_result_line_keys(monkeypatch, capsys):
    import torch
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "power_limit", lambda: "card, 700.00 W")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {
        "correct": True, "attempted": 10, "failed": 0,
        "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
        "device": {"platform": "gpu", "kind": "card", "count": 1,
                   "memory_peak_bytes": 1},
        "checks": [("sampled_reads_wrong", 0, 0)]})
    assert run.main(["--workload", "chr1_aln_err2", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"] == {"sampled_reads_wrong": {"value": 0,
                                                      "limit": 0}}
    assert err.strip().splitlines()[-2:] == [
        "[benchmark] check sampled_reads_wrong 0 limit 0",
        "[benchmark] correct True"]


def test_a_jax_module_fails_the_run(monkeypatch, capsys):
    import torch
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": []})
    monkeypatch.setitem(sys.modules, "ibwa_tpu.cli",
                        types.ModuleType("ibwa_tpu.cli"))
    assert run.main(["--workload", "chr1_aln_err2", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "ibwa_tpu.cli" in err


def test_a_cpu_run_fails_for_want_of_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "chr1_aln_err2",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_reference_index_equals_the_programs(tiny):
    from ibwa_tpu_torch.fm.fmindex import FmIndex
    from ibwa_tpu_torch.index.builder import load_index
    cfg, _ = tiny
    cache = spec.CACHE / cfg["name"]
    ref = refindex.load(cache / "ref_chr1")
    rng = np.random.default_rng(1)
    for strand in (0, 1):
        prog = FmIndex(load_index(str(cache / "chr1.fa"), strand))
        assert (ref[strand].primary, ref[strand].L2) == \
            (prog.primary, [int(v) for v in prog.L2])
        for k in rng.integers(0, prog.seq_len + 1, 400):
            assert list(ref[strand].occ4(int(k))) == \
                [prog.occ(int(k), c) for c in range(4)]


def test_reference_records_equal_the_programs_aln(tiny, tmp_path):
    from ibwa_tpu_torch import cli
    cfg, t = tiny
    cache = spec.CACHE / cfg["name"]
    genome = np.load(cache / "chr1.bases.npy")
    reads = _reads(2**33 + 1, genome)[:60]
    sim.write_fastq(tmp_path / "r.fq", b"r", reads)
    want = refcheck.reference_records(cache / "ref_chr1", list(reads),
                                      cfg["aln_args"], 100, workers=1)
    for engine in ("native", "torch"):
        sai = tmp_path / f"{engine}.sai"
        assert cli.main(["aln", *cfg["aln_args"], "--engine", engine,
                         "--device", "cpu", "-f", str(sai),
                         str(cache / "chr1.fa"), str(tmp_path / "r.fq")]) == 0
        head, got, left = refaln.split_records(sai.read_bytes())
        assert head == refaln.opt_from_args(cfg["aln_args"]).pack()
        assert left == 0 and got == want


@pytest.mark.parametrize("err", [0.0, 0.02, 0.06])
def test_reference_equals_its_frozen_witness(tiny, err):
    """refaln (bwa's C structures) against the frozen copy of the port's
    emulator, read by read, one stack kept across the reads."""
    from benchmark.tests import frozen_engine_ref as fz
    cfg, _ = tiny
    cache = spec.CACHE / cfg["name"]
    fms = refindex.load(cache / "ref_chr1")
    genome = np.load(cache / "chr1.bases.npy")
    reads = sim.sim_single(np.random.default_rng([2**32 + 7, int(err * 100)]),
                           genome, 120, 100, err, 0.01, 0.3, 0.3, 0.5)
    reads[::17, 40] = ord("N")
    opt = refaln.opt_from_args(cfg["aln_args"])
    aligner = refaln.Aligner(fms, opt, refaln.batch_opt(opt, 100))
    fopt = fz.opt_from_args(cfg["aln_args"])
    fbopt = fz.batch_opt(fopt, 100)
    hit = 0
    for r in reads:
        seq, rseq = refaln.read_codes(r)
        got = refaln.record(aligner.align(seq, rseq))
        assert got == fz.record(fz.align_read(fms, seq, rseq, fopt, fbopt))
        hit += got[:4] != b"\0\0\0\0"
    assert hit > 20


@pytest.mark.card
def test_a_tiny_cell_on_the_card(tiny):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg, t = tiny
    # a process a tiny shard: torch's import and the CUDA context take
    # ~10 s there, the profiler's start ~15 s more
    t = dict(t, shards=12)
    b = spec.Bench()
    for trace in (False, True):
        r = harness.run_cell(cfg, t,
                             b.metrics("chr1_aln_err2", trace), 2**31 + 9,
                             60.0 if trace else 30.0, trace, 0.0)
        assert r["correct"], r
        assert r["device"]["platform"] == "gpu"
