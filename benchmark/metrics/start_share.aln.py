"""The share of the window's wall that the `aln` processes spent
starting: the harness's process start (a process's launch to `t_main`,
less the profiler's start in a traced process) and the command's
`aln.import` span (its modules, with torch and its CUDA libraries where
the process has not loaded them), summed over the shards that ended
inside the window, over the time from the window's start to the last of
those ends less the profiler's own stretches (`outside_search_share.
aln`'s base), in %."""


def read(view):
    if not view.done or view.last_end <= 0:
        return None
    seconds = 0.0
    for s in view.done:
        spans = s.get("stats", {}).get("spans")
        if spans is None:
            return None
        seconds += sum(r[5] for r in spans if r[0] == "aln.import")
        for run in s["runs"]:
            rep = run["report"]
            if "t_main" not in rep:
                return None
            seconds += rep.get("t_profiler", rep["t_main"]) - run["launch"]
    return 100.0 * seconds / view.last_end
