"""The share of the window's wall that the `aln` processes spent writing
and ending: the `aln.sai_write` (the .sai records of a batch) and
`aln.close` (the host pool's shutdown) spans of the `[aln] stats` lines,
and the harness's process exit (`t_main_end` to the exit, less the
profiler's export in a traced process), summed over the shards that
ended inside the window, over the time from the window's start to the
last of those ends less the profiler's own stretches
(`outside_search_share.aln`'s base), in %."""

NAMES = ("aln.sai_write", "aln.close")


def read(view):
    if not view.done or view.last_end <= 0:
        return None
    seconds = 0.0
    for s in view.done:
        spans = s.get("stats", {}).get("spans")
        if spans is None:
            return None
        seconds += sum(r[5] for r in spans if r[0] in NAMES)
        for run in s["runs"]:
            rep = run["report"]
            if "t_main_end" not in rep:
                return None
            seconds += run["exit"] - rep.get("t_traced", rep["t_main_end"])
    return 100.0 * seconds / view.last_end
