"""`ibwa_tpu_torch/bench.py`, the port's counterpart of `bench.py`, on the
CPU.

Its inputs are byte-equal to `bench.py`'s at a reduced size (the JAX
package's harness run with its counts lowered by monkeypatch, not edited);
the module runs at `--scale tiny` in a process where neither jax, the JAX
package nor `bench` can be imported and prints `bench.py`'s record with
`baseline`, `device` and `rounds`; `--rounds` below 1 is refused; with no
card and no `--device cpu` it exits 2 and writes no record; and a device
route whose hits differ from the host search's raises before any record.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ibwa_tpu_torch import bench
from ibwa_tpu_torch.align import engine

from conftest import REPO

torch.set_num_threads(1)

TINY = bench.SCALES["tiny"]
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "host_frac",
               "device_only_vs_ref", "baseline", "device", "rounds",
               "host_threads"}


def test_inputs_equal_bench_py(tmp_path, monkeypatch):
    """FASTA, reads, both pair files and the long reads byte-equal to
    bench.py::ensure_inputs' at the same counts, and the port's index of
    the FASTA equal to the JAX package's."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    import bench as j_bench
    for name, v in (("WORK", tmp_path / "jax"),
                    ("GENOME_LEN", TINY.genome_len),
                    ("N_READS", TINY.reads), ("N_PAIRS", TINY.pairs),
                    ("N_LONG", TINY.long_reads)):
        monkeypatch.setattr(j_bench, name, v)
    with contextlib.redirect_stderr(io.StringIO()):
        fa, fq = j_bench.ensure_inputs()
        inp = bench.ensure_inputs(tmp_path / "port", TINY)
    want = {"genome": fa, "reads": fq, "pairs": j_bench._pair_paths(),
            "long": j_bench.WORK / f"long_{j_bench.GENOME_TAG}.fq"}
    got = {"genome": inp.fa, "reads": inp.reads, "pairs": inp.pairs,
           "long": inp.long_reads}
    for what in ("genome", "reads", "long"):
        assert got[what].read_bytes() == want[what].read_bytes(), what
    for g, w in zip(got["pairs"], want["pairs"]):
        assert g.read_bytes() == w.read_bytes(), g.name
    assert got["genome"].read_bytes().startswith(b">bench_chr\n")
    for ext in ("bwt", "sa", "pac", "rbwt", "rsa"):
        assert (pathlib.Path(f"{inp.fa}.{ext}").read_bytes()
                == pathlib.Path(f"{fa}.{ext}").read_bytes()), ext


def test_tiny_run_without_jax(tmp_path):
    """`--device cpu --scale tiny --rounds 1` with jax, ibwa_tpu and bench
    blocked: the record is the last line, with every key; the extra file
    holds the three aln routes, sampe, samse and bwasw.  The native search
    set to 3 host threads before the run runs on 1 in it (`host_threads`
    in the record and the extra file) and on 3 again after it."""
    work = tmp_path / "w"
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'ibwa_tpu', 'bench')\n"
        "for m in BLOCKED:\n"
        "    sys.modules[m] = None\n"
        "from ibwa_tpu_torch import bench, native\n"
        "native.set_threads(3)\n"
        f"rc = bench.main(['--device', 'cpu', '--scale', 'tiny', "
        f"'--rounds', '1', '--work', {str(work)!r}])\n"
        "assert native.get_threads() == 3, native.get_threads()\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None "
        "and m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("IBWA_HOST_FRAC", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(rec) == RECORD_KEYS
    assert rec["metric"] == "aln_reads_per_s_per_chip"
    assert rec["unit"] == "reads/s" and rec["baseline"] == "native"
    assert rec["device"] == "cpu" and rec["rounds"] == 1
    assert rec["host_threads"] == 1
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    extra = json.loads((work / "bench_extra.json").read_text())
    assert extra["host_threads"] == 1
    rates = extra["aln"]["rates"]
    assert set(rates) == {"hybrid", "device_only", "native"}
    assert rec["value"] == rates["hybrid"]["median"]
    assert rec["vs_baseline"] == (rates["hybrid"]["median"]
                                  / rates["native"]["median"])
    d = extra["aln"]["device_round"]
    assert d["device_reads"] + d["fallback_reads"] == TINY.reads
    assert d["host_reads"] == 0 and d["device_ms"] is None
    assert extra["launches"] == {} and extra["aln"]["launches"] == {}
    assert extra["sampe"]["k5"]["readings"] == 1
    assert extra["sampe"]["records"] == 2 * TINY.pairs
    assert all(b["host_walks"] == 0 and b["refused"] == 0
               for b in extra["sampe"]["prefill"])
    assert extra["samse"]["rate"]["median"] > 0
    assert set(extra["bwasw"]["jobs"]) == {"torch", "native"}
    jobs = extra["bwasw"]["jobs"]
    assert jobs["torch"]["total"] == jobs["native"]["total"] > 0
    assert ((work / "long.torch.sam").read_bytes()
            == (work / "long.native.sam").read_bytes())
    assert "[bench] cpu: " in r.stderr


@pytest.mark.parametrize("rounds", ["0", "-2"])
def test_rounds_below_one_refused(tmp_path, rounds, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--scale", "tiny", "--rounds", rounds,
                    "--work", str(tmp_path)])
    assert e.value.code == 2
    assert capsys.readouterr().out == "" and not any(tmp_path.iterdir())
    with pytest.raises(ValueError):
        bench.run("cpu", "tiny", int(rounds), tmp_path)


def test_no_card_exits_2(tmp_path, monkeypatch, capsys):
    """Without a card and without --device cpu: exit 2, the reason on
    stderr, no record and nothing written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("IBWA_HOST_FRAC", raising=False)
    assert bench.main(["--scale", "tiny", "--work", str(tmp_path)]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not any(tmp_path.iterdir())


def test_a_device_difference_raises(tmp_path, monkeypatch, capsys):
    """A device route whose hits differ from native's fails the run before
    any record: the first read's hits of every device batch dropped."""
    monkeypatch.delenv("IBWA_HOST_FRAC", raising=False)
    align = engine.TorchAlnEngine.align_batch

    def dropped(self, *a, **k):
        out = align(self, *a, **k)
        return [[]] + out[1:]

    monkeypatch.setattr(engine.TorchAlnEngine, "align_batch", dropped)
    with pytest.raises(AssertionError, match=r"\.sai differs"):
        bench.main(["--device", "cpu", "--scale", "tiny", "--rounds", "1",
                    "--work", str(tmp_path)])
    assert capsys.readouterr().out == ""
    assert not (tmp_path / "bench_extra.json").exists()
