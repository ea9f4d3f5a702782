"""Several devices for the `aln` search (port of ibwa_tpu/parallel/mesh.py).

Reads are the data axis (`dp`): the reference's pthread work-claiming
(bwtaln.c:100-113) becomes contiguous slices of a chunk, one per device,
each searched by its own resident chunk kernel with no sync between the
devices.  The FM block table is replicated per device, or, for a genome
whose table exceeds one card, split by rows over a second `idx` axis
(`make_mesh_2d` + `run_sharded_index_search`): each device of an idx group
holds a contiguous row range, and the group's search runs on its first
device, whose kernels read every row where it lies (fm/device.py::
shard_pair, csrc/fm_row.cuh ShardRows; peer pointers across cards).  The
JAX package's lockstep of an idx group and its psum per fetch have no
counterpart: a resident kernel has no barrier across devices, and a one-hot
sum is the owner's row.

A mesh is a list of torch devices (1-D) or a list of n_dp lists of n_idx
devices (2-D).  The same card may be named several times: that is how one
card drives these paths, as the JAX tests use virtual CPU devices.

Not ported: `to_local_np` and `mesh_is_multiprocess`, the `jax.distributed`
multi-host feed.  This engine is one process; a multi-host run of the port
is one process a host over its own FASTQ shard.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..align import engine
from ..align.opts import GapOpt, cal_maxdiff
from ..fm.device import DeviceFmPair, pair_to, shard_pair


def make_mesh(n_devices: int | None = None, devices=None
              ) -> list[torch.device]:
    """A 1-D `dp` mesh over the requested devices (default: every visible
    card; `engine.devices_of` reads the names)."""
    devs = engine.devices_of("cuda" if devices is None else devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"{n_devices} devices asked, {len(devs)} named")
        devs = devs[:n_devices]
    return devs


def make_mesh_2d(n_dp: int, n_idx: int, devices=None
                 ) -> list[list[torch.device]]:
    """A (dp, idx) mesh: n_dp groups of n_idx devices, reads split over
    the groups, the block table split by rows over a group's devices."""
    devs = make_mesh(n_dp * n_idx, devices)
    return [devs[i * n_idx:(i + 1) * n_idx] for i in range(n_dp)]


def _search_dp(cfg, dfms: list[DeviceFmPair], batch, n_lanes: int):
    """One search of a read batch over several entries: entry d takes the
    d-th contiguous slice of ceil(N / entries) reads, on its own stream;
    every slice is launched before any is collected.  Returns (hits
    int64[N, HCAP, 3], n_hits int64[N], fb bool[N], it int64[entries]) on
    the CPU, the hits beyond n_hits not part of the result."""
    seqs, lens, md, hs, ssq, bad = (torch.as_tensor(np.asarray(a)) for a in
                                    batch)
    lens, md = lens.to(torch.int64), md.to(torch.int64)
    N = seqs.shape[0]
    per = -(-N // len(dfms))
    streams = engine.entry_streams(dfms)
    launched = []
    for d, (dfm, st) in enumerate(zip(dfms, streams)):
        a, b = d * per, min((d + 1) * per, N)
        if a >= b:
            break
        args = [t[a:b].contiguous().to(dfm.device)
                for t in (seqs, lens, md, hs, ssq, bad)]
        if st is not None:
            st.wait_stream(torch.cuda.current_stream(dfm.device))
        with engine.on_stream(st):
            launched.append((st, args, engine.launch_search(
                cfg, dfm, *args, n_lanes=n_lanes)))
    out = []
    for st, _, part in launched:
        with engine.on_stream(st):
            hits, n_hits, fb, steps, _ = engine.collect_search(part)
            out.append((hits.cpu(), n_hits.cpu(), fb.cpu(), steps))
    return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]),
            torch.cat([o[2] for o in out]),
            torch.tensor([o[3] for o in out], dtype=torch.int64))


def run_sharded_search_persistent(cfg, mesh: list, dfm: DeviceFmPair, seqs,
                                  lens, max_diff, has_seed, seed_seqs, bad,
                                  n_lanes: int):
    """The production path over a `dp` mesh: the table copied to every
    device of `mesh`, the reads split in contiguous slices, each device
    its own persistent-lane search (`engine.launch_search`) with no sync
    between them.  Reads as `engine.run_search_persistent` takes them
    (numpy arrays or tensors); returns `_search_dp`'s."""
    return _search_dp(cfg, [pair_to(dfm, d) for d in mesh],
                      (seqs, lens, max_diff, has_seed, seed_seqs, bad),
                      n_lanes)


def run_sharded_index_search(cfg, mesh: list, dfm: DeviceFmPair, seqs,
                             lens, max_diff, has_seed, seed_seqs, bad,
                             n_lanes: int):
    """Search with the FM block table SPLIT over each group's idx
    devices (a 2-D mesh, `make_mesh_2d`): group g holds the table's row
    ranges on mesh[g] (`shard_pair`) and searches its slice of the reads
    on mesh[g][0]: on cards the sharded instantiations of the width pass
    and the chunk search (B8), on the CPU their plain versions over
    `gather_rows_sharded`.  Bitwise the replicated path's result."""
    n_idx = len(mesh[0])
    rows = dfm.blocks.shape[0]
    if rows % n_idx:
        raise ValueError(
            f"block rows {rows} not divisible by idx={n_idx}; pad the "
            "table (padding rows are never addressed)")
    return _search_dp(cfg, [shard_pair(dfm, group) for group in mesh],
                      (seqs, lens, max_diff, has_seed, seed_seqs, bad),
                      n_lanes)


def tiny_problem(n_reads: int = 64, read_len: int = 36, glen: int = 4096):
    """A synthetic genome's two FM-indexes and reads on it (port of
    __graft_entry__.py::_tiny_problem): (fms, opt, seqs, rseqs), the reads
    in the .sai convention (reversed; rseq the reversed complement)."""
    from ..fm.fmindex import FmIndex
    from ..index.builder import build_bwt_index
    rng = random.Random(7)
    seq = np.array([rng.randrange(4) for _ in range(glen)], dtype=np.uint8)
    fms = (FmIndex(build_bwt_index(seq)),
           FmIndex(build_bwt_index(seq[::-1].copy())))
    seqs, rseqs = [], []
    for _ in range(n_reads):
        pos = rng.randrange(glen - read_len)
        r = seq[pos:pos + read_len].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        r[rng.randrange(read_len)] = rng.randrange(4)
        seqs.append(r[::-1].copy())
        rseqs.append((3 - r)[::-1].copy())
    return fms, GapOpt(), seqs, rseqs


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the PRODUCTION aln path over n_devices entries (port of
    __graft_entry__.py::dryrun_multichip): `TorchAlnEngine.align_batch`,
    the code the `aln` CLI runs, at a small dispatch geometry (8 lanes, 8
    reads a chunk per entry), 8 reads per entry.  `device` "cuda": the
    visible cards, or card 0 named n_devices times where there are fewer;
    "cpu": the CPU named n_devices times."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device is visible")
        devs = ([torch.device("cuda", i) for i in range(n_devices)]
                if count >= n_devices else [torch.device("cuda", 0)]
                * n_devices)
    else:
        devs = [dev] * n_devices
    n_reads = 8 * n_devices
    fms, opt, seqs, rseqs = tiny_problem(n_reads=n_reads, read_len=36,
                                         glen=2048)
    old = engine.DEV_BATCH, engine.PERSIST_N
    engine.DEV_BATCH, engine.PERSIST_N = 8, 8
    eng = engine.TorchAlnEngine(fms, devs)
    try:
        assert len(eng.dfms) == n_devices, "every entry must take a slice"
        res = eng.align_batch(seqs, rseqs, opt)
    finally:
        engine.DEV_BATCH, engine.PERSIST_N = old
        eng.close()
    n_hits = sum(len(h) for h in res)
    assert len(res) == n_reads
    assert n_hits > 0, "sharded production search found no hits"
    assert eng.stats["fallback_reads"] == 0, "tiny dryrun must not overflow"
    want = engine.native_align_batch(fms, seqs, rseqs, opt)
    assert res == want, "the entries' hits differ from the host search's"
    print(f"[dryrun] {n_devices} entries on {', '.join(map(str, devs))} "
          f"(production align_batch, dp split), {n_reads} reads, {n_hits} "
          f"hits: OK")


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
