"""Device ms of the width pass (K6) and the chunk search (K8) per 1,000
reads the card searched (`reads` - `host_reads` of the `[aln] stats`
lines), over every shard of the traced window: each kernel's mean time a
launch in the trace times its launches counted by the program."""

KERNELS = {"width_pass": "width_pass_kernel",
           "search_chunk": "search_chunk_kernel"}


def read(view):
    ms = view.kernel_ms(KERNELS)
    if set(ms) != set(KERNELS):
        return None
    card = sum(s["stats"]["reads"] - s["stats"]["host_reads"]
               for s in view.shards if "reads" in s.get("stats", {}))
    if card <= 0:
        return None
    return sum(ms.values()) / (card / 1e3)
