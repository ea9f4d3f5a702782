"""The share of the window's wall that `aln` spent setting up its
engine: the `aln.engine_init` span (the block table's build on the host,
its upload to the card with the CUDA context's creation) of the `[aln]
stats` lines of the shards that ended inside the window, over the time
from the window's start to the last of those ends less the profiler's
own stretches (`outside_search_share.aln`'s base), in %."""


def read(view):
    if not view.done or view.last_end <= 0:
        return None
    seconds = 0.0
    for s in view.done:
        spans = s.get("stats", {}).get("spans")
        if spans is None:
            return None
        seconds += sum(r[5] for r in spans if r[0] == "aln.engine_init")
    return 100.0 * seconds / view.last_end
