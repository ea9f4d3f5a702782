"""The share of the window's wall that `aln` spent outside its search:
1 - the summed `search_s` of the `[aln] stats` lines of the shards that
ended inside the window, over the time from the window's start to the
last of those ends, less the profiler's own start and export in each
traced process (process start and imports, index load, FASTQ parsing,
engine set-up and table upload, the .sai writer, process exit), in %."""


def read(view):
    if not view.done or any("search_s" not in s.get("stats", {})
                            for s in view.done):
        return None
    search = sum(s["stats"]["search_s"] for s in view.done)
    return 100.0 * (1.0 - search / view.last_end)
