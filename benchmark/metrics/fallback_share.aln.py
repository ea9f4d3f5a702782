"""The share of the reads the card searched that overflowed to the host
search: `fallback_reads` over `reads` - `host_reads` of the `[aln] stats`
lines of the shards that ended inside the window, in %."""


def read(view):
    stats = [s.get("stats", {}) for s in view.done]
    if not stats or any("fallback_reads" not in st for st in stats):
        return None
    card = sum(st["reads"] - st["host_reads"] for st in stats)
    if card <= 0:
        return None
    return 100.0 * sum(st["fallback_reads"] for st in stats) / card
