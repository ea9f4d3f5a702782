"""Ways to break the `aln` cell's timed path, planted by `child.py
--plant NAME[:ARG]` into the program's engine before its CLI runs.  The
benchmark's own runs plant nothing; the control (`control.py`) and the
tests do, and the check must then read `correct` false.

- `no_fallback`, the control: the card's search with its host fallback
  left out; a read that overflows the card's step budget, arena or hit
  room keeps the hits the card found (the search cut short).
- `ref_max_pops:N`: the plain reference in the program's place, each
  read's search stopped after N pops, its hits so far kept (on the CPU at
  a tiny size: the reference is plain Python).
- `unchanged`: each read's hits left at the search's start state (none).
- `half_batch`: half of the batch left out.
- `altered`: a read's first hit altered where it is produced.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import pathlib

import numpy as np


def _engine():
    from ibwa_tpu_torch.align import engine
    return engine


def _wrap(make):
    engine = _engine()
    engine.TorchAlnEngine.align_batch = make(
        engine.TorchAlnEngine.align_batch)


def unchanged(arg, cli_args) -> None:
    def make(orig):
        def align_batch(self, seqs, rseqs, opt):
            return [[] for _ in orig(self, seqs, rseqs, opt)]
        return align_batch
    _wrap(make)


def half_batch(arg, cli_args) -> None:
    def make(orig):
        def align_batch(self, seqs, rseqs, opt):
            half = len(seqs) // 2
            return orig(self, seqs[:half], rseqs[:half], opt)
        return align_batch
    _wrap(make)


def altered(arg, cli_args) -> None:
    def make(orig):
        def align_batch(self, seqs, rseqs, opt):
            out = orig(self, seqs, rseqs, opt)
            for hits in out:
                if hits:
                    hits[0].k += 1
            return out
        return align_batch
    _wrap(make)


class _NoFallbackPool:
    """The engine's host pool with the overflow fallback's jobs answered
    at once with nothing; the host share's jobs run as before."""

    def __init__(self, pool, fallback_fn):
        self.pool, self.fallback_fn = pool, fallback_fn

    def submit(self, fn, *args):
        if fn is self.fallback_fn:
            fut = concurrent.futures.Future()
            fut.set_result([None] * len(args[1]))
            return fut
        return self.pool.submit(fn, *args)


def no_fallback(arg, cli_args) -> None:
    engine = _engine()
    decode, orig = engine._decode, engine.TorchAlnEngine.align_batch
    found: dict[int, list] = {}

    def keep_partial(harr, nh, fb, opt, out, lo):
        nh = np.minimum(nh, harr.shape[1])
        decode(harr, nh, np.zeros_like(fb), opt, out, lo)
        for b in np.nonzero(fb)[0].tolist():
            found[lo + b] = out[lo + b]

    def align_batch(self, seqs, rseqs, opt):
        found.clear()
        pool = self._pool
        self._pool = _NoFallbackPool(pool, engine.native_align_batch)
        try:
            out = orig(self, seqs, rseqs, opt)
        finally:
            self._pool = pool
        return [found.get(i, []) if h is None else h
                for i, h in enumerate(out)]

    engine._decode = keep_partial
    engine.TorchAlnEngine.align_batch = align_batch


def ref_max_pops(arg, cli_args) -> None:
    """The reference cut at `arg` pops in align_batch's place, over the
    index the benchmark made beside the command's FASTA (`<dir>/ref_<db>`
    for `<dir>/<db>.fa`, the command's next to last argument); the
    engine still runs, for the stats the CLI prints, and its answers are
    dropped."""
    from benchmark import refaln, refindex
    engine = _engine()
    fa = pathlib.Path(cli_args[-2])
    fms = refindex.load(fa.parent / f"ref_{fa.stem}")
    orig = engine.TorchAlnEngine.align_batch

    def align_batch(self, seqs, rseqs, opt):
        orig(self, seqs, rseqs, opt)       # the engine's stats, as it keeps them
        ropt = refaln.GapOpt(**{f.name: getattr(opt, f.name)
                                for f in dataclasses.fields(refaln.GapOpt)})
        al = refaln.Aligner(fms, ropt, refaln.batch_opt(
            ropt, max(len(s) for s in seqs)))
        return [[engine.Hit(*h) for h in al.align(s, r, int(arg))]
                for s, r in zip(seqs, rseqs)]

    engine.TorchAlnEngine.align_batch = align_batch


PLANTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered, "no_fallback": no_fallback,
          "ref_max_pops": ref_max_pops}


def plant(spec: str, cli_args: list[str]) -> None:
    name, _, arg = spec.partition(":")
    PLANTS[name](arg or None, cli_args)
