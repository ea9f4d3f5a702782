"""The reference's records for a sample of reads, on the host's cores.

Each worker process loads the reference's index of the configuration
(`refindex.load`, memory-mapped) once and aligns the reads it is given
with one `refaln.Aligner`, as one of bwa's threads does; the records come
back in the order of the reads.
"""

from __future__ import annotations

import multiprocessing
import pathlib

import numpy as np

from benchmark import refaln, refindex

_STATE: dict = {}


def _init(ref_dir: str, aln_args: list[str], read_len: int,
          max_pops: int | None) -> None:
    opt = refaln.opt_from_args(aln_args)
    _STATE.update(aligner=refaln.Aligner(
        refindex.load(pathlib.Path(ref_dir)), opt,
        refaln.batch_opt(opt, read_len)), max_pops=max_pops)


def _one(read: np.ndarray) -> bytes:
    return refaln.record(_STATE["aligner"].align(
        *refaln.read_codes(read), _STATE["max_pops"]))


def reference_records(ref_dir: pathlib.Path, reads: list[np.ndarray],
                      aln_args: list[str], read_len: int, workers: int = 8,
                      max_pops: int | None = None) -> list[bytes]:
    """Each read's .sai record as the reference gives it (`max_pops`:
    the search cut short).  `read_len` is the batch's longest read (bwa's
    batch options)."""
    init = (str(ref_dir), list(aln_args), read_len, max_pops)
    if workers <= 1:
        _init(*init)
        return [_one(r) for r in reads]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=_init, initargs=init) as pool:
        out = pool.map(_one, reads, chunksize=1)
    return out
