"""The spans of the port's `aln` (`ibwa_tpu_torch/spans.py`) on the CPU:
`aln_to_stream` with the torch engine on `test_torch_aln.py`'s genome,
the hybrid's host share and the overflow fallback forced on (their floor
and the step budget lowered), reports every span of its path in the
`[aln] stats` line, each inside its parent and inside the call, its
`search_s` the `aln.search` spans' total, only its own spans, the .sai of
the native engine, and a line bounded by names x batches."""

import contextlib
import io
import json
import random
import threading
import time

import pytest
import torch

from ibwa_tpu_torch import cli, spans
from ibwa_tpu_torch.align import engine, pipeline
from ibwa_tpu_torch.align.opts import GapOpt
from ibwa_tpu_torch.index.builder import bwa_index

from conftest import make_genome

torch.set_num_threads(1)

COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
# every span of a torch-engine `aln` on the CPU; `kernels.load` opens
# only where an entry is a card
SPANS = {"aln": None, "aln.import": "aln", "aln.index_load": "aln",
         "aln.reads_parse": "aln", "aln.engine_init": "aln",
         "aln.table_build": "aln.engine_init",
         "aln.table_upload": "aln.engine_init", "aln.search": "aln",
         "aln.pack": "aln.search", "aln.launch": "aln.search",
         "aln.collect": "aln.search", "aln.decode": "aln.search",
         "aln.host_wait": "aln.search", "aln.host_search": None,
         "aln.fallback_search": None, "aln.sai_write": "aln",
         "aln.close": "aln"}
NAME, PARENT, BATCH, START, END, TOTAL, SELF, COUNT = range(8)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """test_torch_aln.py's genome, indexed by the port, and 160 reads of
    40-100 bp with substitutions and N bases."""
    tmp = tmp_path_factory.mktemp("spans")
    fa = tmp / "g.fa"
    genome = make_genome(fa, [("chrA", "test", 30000, 0.0005),
                              ("chrB", "", 12000, 0.0)], seed=20261016)
    bwa_index(str(fa))
    rng = random.Random(79)
    fq = tmp / "r.fq"
    with open(fq, "w") as f:
        for i in range(160):
            seq = genome[rng.choice(sorted(genome))]
            n = 100 if i % 4 == 0 else rng.randrange(40, 101)
            pos = rng.randrange(0, len(seq) - n)
            s = [rng.choice("ACGT") if rng.random() < 0.015 else c
                 for c in seq[pos:pos + n]]
            if rng.random() < 0.2:
                s[rng.randrange(n)] = "N"
            if rng.random() < 0.5:
                s = [COMP[c] for c in reversed(s)]
            f.write(f"@q{i}\n{''.join(s)}\n+\n{'I' * n}\n")
    return fa, fq


@pytest.fixture
def forced(monkeypatch):
    """CPU-sized lanes; a host share in every batch (its floor and job
    size lowered) and overflow reads (the step budget lowered)."""
    monkeypatch.setattr(engine, "DEV_BATCH", 64)
    monkeypatch.setattr(engine, "HYBRID_MIN", 8)
    monkeypatch.setattr(engine, "HOST_CHUNK", 16)
    monkeypatch.setattr(engine, "ITER_CAP", 24)
    monkeypatch.delenv("IBWA_HOST_FRAC", raising=False)


def _stats(err: str) -> dict:
    lines = [ln for ln in err.splitlines() if ln.startswith("[aln] stats ")]
    assert len(lines) == 1, err
    return json.loads(lines[0][len("[aln] stats "):])


def _aln(fa, fq, out, engine_name="torch"):
    """aln_to_stream in-process: (its stats line, the raw line, the
    perf_counter before and after the call)."""
    err = io.StringIO()
    with open(out, "wb") as f, contextlib.redirect_stderr(err):
        t0 = time.perf_counter()
        pipeline.aln_to_stream(str(fa), str(fq), GapOpt(), f,
                               engine=engine_name, device="cpu")
        t1 = time.perf_counter()
    return _stats(err.getvalue()), err.getvalue(), t0, t1


def test_every_span_of_aln_is_present(inputs, tmp_path, forced):
    fa, fq = inputs
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["aln", "--device", "cpu", "-t", "2", "-f",
                         str(tmp_path / "o.sai"), str(fa), str(fq)]) == 0
    st = _stats(err.getvalue())
    got = {r[NAME]: r[PARENT] for r in st["spans"]}
    assert got == SPANS
    assert {r[BATCH] for r in st["spans"] if r[PARENT] == "aln.search"
            or r[NAME] in ("aln.search", "aln.sai_write", "aln.host_search",
                           "aln.fallback_search")} == {0}
    by = {r[NAME]: r for r in st["spans"]}
    assert by["aln.host_search"][COUNT] == -(-st["host_reads"] // 16)
    assert st["fallback_reads"] > 0 and st["host_reads"] > 0
    # a chunk a launch, collected and decoded once; no copy to or from a
    # card on the CPU
    assert st["chunks"] == by["aln.collect"][COUNT] == \
        by["aln.decode"][COUNT] == -(-(160 - st["host_reads"]) //
                                     engine.PERSIST_N)
    assert st["h2d_bytes"] == st["d2h_bytes"] == 0


def test_spans_nest_in_their_parents_and_in_the_call(inputs, tmp_path,
                                                     forced):
    fa, fq = inputs
    st, _, t0, t1 = _aln(fa, fq, tmp_path / "o.sai")
    recs = st["spans"]
    root = [r for r in recs if r[NAME] == "aln"]
    assert len(root) == 1 and root[0][COUNT] == 1
    for r in recs:
        assert t0 <= r[START] <= r[END] <= t1, r
        assert r[TOTAL] >= 0 and 0 <= r[SELF] <= r[TOTAL] + 1e-12, r
        if r[COUNT] == 1:
            assert r[TOTAL] == pytest.approx(r[END] - r[START], abs=1e-9)
        else:
            assert r[TOTAL] <= r[END] - r[START] + 1e-9, r
        # a pool thread's span lies inside its batch's search
        parent = r[PARENT] or ("aln.search" if r[NAME] != "aln" else None)
        if parent is None:
            continue
        outer = [p for p in recs if p[NAME] == parent
                 and (p[BATCH] is None or p[BATCH] == r[BATCH])]
        assert len(outer) == 1, r
        assert outer[0][START] <= r[START] and r[END] <= outer[0][END], r
    # a parent's self time is its duration less its children's
    for p in recs:
        kids = sum(r[TOTAL] for r in recs if r[PARENT] == p[NAME]
                   and (p[BATCH] is None or r[BATCH] == p[BATCH]))
        assert p[SELF] == pytest.approx(p[TOTAL] - kids, abs=1e-9), p


def test_search_s_is_the_search_spans_total(inputs, tmp_path, forced,
                                            monkeypatch):
    fa, fq = inputs
    monkeypatch.setattr(pipeline, "BATCH_SIZE", 48)     # four batches
    st, _, _, _ = _aln(fa, fq, tmp_path / "o.sai")
    search = [r for r in st["spans"] if r[NAME] == "aln.search"]
    assert [r[BATCH] for r in search] == [0, 1, 2, 3]
    assert st["search_s"] == sum(r[TOTAL] for r in search)
    assert len(st["batches"]) == 4


def test_two_calls_report_only_their_own_spans(inputs, tmp_path, forced):
    fa, fq = inputs
    first, _, _, t_mid = _aln(fa, fq, tmp_path / "a.sai")
    second, _, t_start, _ = _aln(fa, fq, tmp_path / "b.sai")
    assert t_mid <= t_start
    assert all(r[START] >= t_start for r in second["spans"])
    assert [(r[NAME], r[COUNT]) for r in first["spans"]
            if r[NAME] in ("aln", "aln.search", "aln.engine_init")] == \
        [(r[NAME], r[COUNT]) for r in second["spans"]
         if r[NAME] in ("aln", "aln.search", "aln.engine_init")] == \
        [("aln", 1), ("aln.engine_init", 1), ("aln.search", 1)]


def test_sai_equals_the_native_engines(inputs, tmp_path, forced):
    fa, fq = inputs
    st, _, _, _ = _aln(fa, fq, tmp_path / "torch.sai")
    nat, _, _, _ = _aln(fa, fq, tmp_path / "native.sai", "native")
    assert st["fallback_reads"] > 0
    assert (tmp_path / "torch.sai").read_bytes() == \
        (tmp_path / "native.sai").read_bytes()
    assert {r[NAME] for r in nat["spans"]} == {
        "aln", "aln.index_load", "aln.reads_parse", "aln.search",
        "aln.sai_write", "aln.close"}


def test_stats_line_is_bounded_by_names_and_batches(inputs, tmp_path,
                                                    forced, monkeypatch):
    """One batch with as many chunks as a 0x40000-read batch has on the
    card at most (128: PERSIST_N lowered to one read, each chunk's search
    replaced by one that sends every read to the host search, so 128
    fallback jobs) and 32 host-share jobs (39 there): the line stays
    under 16 KB, as long as with 2 chunks within a few digits, and the
    .sai is the native engine's."""
    fa, fq = inputs
    _, small, _, _ = _aln(fa, fq, tmp_path / "a.sai")

    def all_to_host(cfg, fm, seqs, *args, n_lanes):
        n = seqs.shape[0]
        return (torch.zeros(n, 1, 3, dtype=torch.int64),
                torch.zeros(n, dtype=torch.int64),
                torch.ones(n, dtype=torch.bool), 0,
                torch.full((n,), engine.FB_ITER_CAP), n_lanes)

    monkeypatch.setattr(engine, "launch_search", all_to_host)
    monkeypatch.setattr(engine, "PERSIST_N", 1)
    monkeypatch.setattr(engine, "HOST_CHUNK", 1)
    monkeypatch.setattr(engine, "HOST_FRAC_INIT", 0.2)
    st, big, _, _ = _aln(fa, fq, tmp_path / "b.sai")
    assert st["chunks"] == 128 and st["host_reads"] == 32
    by = {r[NAME]: r[COUNT] for r in st["spans"]}
    assert by["aln.collect"] == by["aln.fallback_search"] == 128
    assert by["aln.host_search"] == 32
    line = [ln for ln in big.splitlines() if ln.startswith("[aln] stats ")]
    assert len(line[0]) < 16 * 1024
    assert {r[NAME] for r in st["spans"]} == set(SPANS) - {"aln.import"}
    small_line = [ln for ln in small.splitlines()
                  if ln.startswith("[aln] stats ")][0]
    assert abs(len(line[0]) - len(small_line)) < 200
    _aln(fa, fq, tmp_path / "native.sai", "native")
    assert (tmp_path / "b.sai").read_bytes() == \
        (tmp_path / "native.sai").read_bytes()


def test_recorder_sums_spans_by_name_parent_and_batch():
    rec = spans.Recorder()
    with rec.span("a") as a:
        for b in (0, 1):
            with rec.span("b", b):
                for _ in range(3):
                    with rec.span("c"):
                        time.sleep(0.001)
        worker = threading.Thread(target=lambda: rec.span("w", 1).__enter__()
                                  .__exit__(None, None, None))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    got = {(r[0], r[2]): r for r in rec.records()}
    assert set(got) == {("a", None), ("b", 0), ("b", 1), ("c", 0), ("c", 1),
                        ("w", 1)}
    assert got[("c", 1)][1] == "b" and got[("c", 1)][7] == 3
    assert got[("w", 1)][1] is None
    assert got[("a", None)][5] == a.seconds
    assert rec.total("c", 0) == got[("c", 0)][5] >= 0.003
    assert got[("b", 0)][6] == pytest.approx(
        got[("b", 0)][5] - got[("c", 0)][5], abs=1e-12)
    assert rec.total("c") == 0.0
