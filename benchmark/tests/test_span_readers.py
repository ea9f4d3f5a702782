"""The readers of the `aln` spans (`start_share.aln`, `load_share.aln`,
`table_share.aln`, `write_share.aln`, `host_wait_share.aln`,
`idle_unnamed_share.aln`) on a synthetic window of two traced shards:
hand-made spans in each `[aln] stats` line, and device operations with
overlapping and idle stretches; each value against a hand count."""

import pytest

from benchmark import devtrace, harness, spec

READERS = ("start_share.aln", "load_share.aln", "table_share.aln",
           "write_share.aln", "host_wait_share.aln",
           "idle_unnamed_share.aln")


def _shard(index: int, t: float) -> dict:
    """A traced shard whose process launches at t: the profiler starts
    over [t + 1, t + 2], `main` runs [t + 2, t + 9.5], the profiler's
    export [t + 9.5, t + 9.6], the exit at t + 10."""
    def rec(name, parent, batch, a, b, total=None, count=1):
        total = b - a if total is None else total
        return [name, parent, batch, t + a, t + b, total, total, count]
    spans = [rec("aln", None, None, 2.1, 8.9),
             rec("aln.import", "aln", None, 2.1, 2.5),
             rec("aln.index_load", "aln", None, 2.5, 3.0),
             rec("aln.reads_parse", "aln", None, 3.0, 3.5),
             rec("aln.engine_init", "aln", None, 3.5, 4.5),
             rec("aln.table_build", "aln.engine_init", None, 3.5, 4.0),
             rec("aln.table_upload", "aln.engine_init", None, 4.0, 4.5),
             rec("aln.search", "aln", 0, 4.5, 8.0),
             rec("aln.launch", "aln.search", 0, 4.6, 4.8),
             rec("aln.collect", "aln.search", 0, 4.8, 6.0, 0.8, 2),
             rec("aln.host_wait", "aln.search", 0, 6.0, 7.5),
             rec("aln.host_search", None, 0, 4.6, 7.4),
             rec("aln.sai_write", "aln", 0, 8.0, 8.5),
             rec("aln.close", "aln", None, 8.5, 8.8)]
    report = {"t_start": t + 0.1, "t_profiler": t + 1.0, "t_main": t + 2.0,
              "t_main_end": t + 9.5, "t_traced": t + 9.6}
    return {"index": index, "units": 100, "start": t, "end": t + 10.0,
            "rc": 0, "stats": {"search_s": 3.5, "spans": spans},
            "runs": [{"name": f"aln{index}", "rc": 0, "err": "",
                      "report": report, "launch": t, "exit": t + 10.0}]}


def _ops(t: float) -> list:
    """A shard's device operations: the table's upload, two kernels that
    overlap, a lone kernel, and a copy after the root span has closed."""
    return [devtrace.Op("Memcpy HtoD", t + 4.0, t + 4.4),
            devtrace.Op("width_pass_kernel", t + 4.9, t + 5.0),
            devtrace.Op("search_chunk_kernel", t + 5.5, t + 5.7),
            devtrace.Op("Memcpy DtoH", t + 5.6, t + 5.8),
            devtrace.Op("Memcpy DtoH", t + 9.0, t + 9.2)]


def _view(shards, trace=True) -> harness.View:
    """The View `harness.run_cell` makes of `shards`: the window opens at 0
    and closes at the last exit, both shards done."""
    t_end = max(s["end"] for s in shards)
    tr = None
    if trace:
        tr = harness.window_trace(shards, 0.0, t_end)
        tr.device = [op for s in shards for op in _ops(s["start"])]
    last_end = t_end - sum(o.end - o.start for s in shards
                           for r in s["runs"]
                           for o in harness.profiler_stretches(r["report"]))
    return harness.View(None, shards, shards, last_end, {}, tr,
                        tr.seconds() if tr else last_end)


def _read(name, view):
    return spec.reader(name).read(view)


def test_span_shares_against_a_hand_count():
    # the second process starts 0.5 s after the first has exited (the
    # harness's own time between two shards)
    view = _view([_shard(0, 0.0), _shard(1, 10.5)])
    base = 20.5 - 2 * (1.0 + 0.1)          # less the profiler's stretches
    assert view.last_end == pytest.approx(base)
    # process start (launch to the profiler's start) + aln.import
    assert _read("start_share.aln", view) == pytest.approx(
        100 * 2 * (1.0 + 0.4) / base)
    assert _read("load_share.aln", view) == pytest.approx(
        100 * 2 * (0.5 + 0.5) / base)
    assert _read("table_share.aln", view) == pytest.approx(
        100 * 2 * 1.0 / base)
    # sai_write + close + exit after the profiler's export
    assert _read("write_share.aln", view) == pytest.approx(
        100 * 2 * (0.5 + 0.3 + 0.4) / base)
    assert _read("host_wait_share.aln", view) == pytest.approx(
        100 * 1.5 / 3.5)
    # with the search they part the window; what is left is the root's
    # own time (2.0-2.1, 8.8-9.5 a shard) and the harness's 0.5 s
    outside = spec.reader("outside_search_share.aln").read(view)
    parts = sum(_read(n, view) for n in READERS[:4]) + 100 - outside
    assert parts == pytest.approx(100 - 100 * (2 * 0.8 + 0.5) / base)


def test_idle_unnamed_share_against_a_hand_count():
    view = _view([_shard(0, 0.0), _shard(1, 10.5)])
    # a shard's 10 s: device busy 0.4 + 0.1 + 0.3 (two overlapping) + 0.2,
    # the profiler's 1.0 + 0.1 left out: 7.9 s idle; unnamed: the root's
    # own 2.0-2.1 and 8.8-9.5 less the copy at 9.0-9.2; the harness's
    # 0.5 s between the shards idle and unnamed
    idle = 2 * 7.9 + 0.5
    unnamed = 2 * (0.1 + 0.7 - 0.2) + 0.5
    assert _read("idle_unnamed_share.aln", view) == pytest.approx(
        100 * unnamed / idle)
    assert _read("device_idle_share.aln", view) == pytest.approx(
        100 * idle / view.traced_s)


def test_a_shard_without_spans_reads_none():
    """The parent of this change prints no `spans`: every reader returns
    None, and raises nothing."""
    plain = _shard(1, 10.5)
    del plain["stats"]["spans"]
    for shards in ([_shard(0, 0.0), plain], [plain]):
        view = _view(shards)
        for name in READERS:
            assert _read(name, view) is None, name
    untraced = _view([_shard(0, 0.0)], trace=False)
    assert _read("idle_unnamed_share.aln", untraced) is None
    assert _read("table_share.aln", untraced) == pytest.approx(
        100 * 1.0 / untraced.last_end)
