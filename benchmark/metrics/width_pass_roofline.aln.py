"""K6's share of its bandwidth bound: the bytes `yardstick.
width_pass_bytes` counts for the reads each shard of the traced window
gave the card (the first `reads` - `host_reads` of the shard, the order
`aln` hands the card its share), at the card's published HBM bandwidth,
over K6's device time (mean a launch seen x launches counted), in %."""

import numpy as np

from benchmark import refaln, refindex, sim, yardstick

KERNEL = {"width_pass": "width_pass_kernel"}


def read(view):
    import torch
    ms = view.kernel_ms(KERNEL).get("width_pass")
    if not ms:
        return None
    ctx = view.ctx
    db = ctx.cfg["dbs"][0]["name"]
    ref = refindex.load(ctx.cache / f"ref_{db}")
    dev = ctx.ref_device
    fms = tuple(yardstick.strand_tensors(fm, dev) for fm in ref)
    opt = refaln.opt_from_args(ctx.cfg["aln_args"])
    total = 0
    for s in view.shards:
        st = s.get("stats", {})
        if "reads" not in st:
            return None
        n = st["reads"] - st["host_reads"]
        codes = sim.CODE[ctx.inputs["shards"][s["index"]]["reads"][:n]]
        comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
        seqs = torch.from_numpy(codes[:, ::-1].copy()).to(dev)
        rseqs = torch.from_numpy(comp[:, ::-1].copy()).to(dev)
        total += yardstick.width_pass_bytes(fms, seqs, rseqs, opt.seed_len,
                                            ref[0].seq_len)
    del fms
    if dev == "cuda":
        torch.cuda.empty_cache()
    return 100.0 * (total / yardstick.HBM_BYTES_PER_S) / (ms / 1e3)
