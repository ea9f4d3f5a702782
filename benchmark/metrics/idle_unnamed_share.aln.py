"""The share of the device's idle time that no span names: the seconds of
the traced window in which no device operation ran (the profiler's own
stretches left out, as `device_idle_share.aln` leaves them) and which no
span of the `[aln] stats` lines but the root `aln` covers, nor a
process's start (launch to `t_main`) or exit (`t_main_end` to the exit),
over every shard the trace holds, over all the device's idle seconds of
the window, in %.  The spans are on the clock the device trace is
shifted onto (`time.perf_counter`), so they compare as they are."""

from benchmark import devtrace


def read(view):
    tr = view.trace
    if tr is None or not view.shards:
        return None
    named = []
    for s in view.shards:
        spans = s.get("stats", {}).get("spans")
        if spans is None:
            return None
        named += [devtrace.Op(r[0], r[3], r[4]) for r in spans
                  if r[0] != "aln"]
        for run in s["runs"]:
            rep = run["report"]
            if "t_main" in rep:
                named += [devtrace.Op("start", run["launch"], rep["t_main"]),
                          devtrace.Op("exit", rep["t_main_end"],
                                      run["exit"])]
    busy = tr.device + tr.excluded
    idle = sum(e - s for s, e in devtrace.gaps(busy, tr.start, tr.end))
    if idle <= 0:
        return None
    unnamed = sum(e - s for s, e in devtrace.gaps(busy + named, tr.start,
                                                  tr.end))
    return 100.0 * unnamed / idle
