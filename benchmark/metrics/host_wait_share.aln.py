"""The share of `aln`'s search that its main thread spent blocked on the
host pool (the overflow jobs, then the host-share jobs): the summed
`aln.host_wait` spans over the summed `aln.search` spans (whose total is
`search_s`) of the `[aln] stats` lines of the shards that ended inside
the window, in %."""


def read(view):
    wait = search = 0.0
    for s in view.done:
        spans = s.get("stats", {}).get("spans")
        if spans is None:
            return None
        wait += sum(r[5] for r in spans if r[0] == "aln.host_wait")
        search += sum(r[5] for r in spans if r[0] == "aln.search")
    if search <= 0:
        return None
    return 100.0 * wait / search
