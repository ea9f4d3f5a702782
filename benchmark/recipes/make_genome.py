"""The `make_genome` recipe: one contig of `length` bases from the db's
own seed, made of a 300 bp dispersed element, a 250 bp unit in tandem
(`tandem_copies`), `segdups` 50 kbp segmental duplications and unique
blocks.  A copy of the port's `ibwa_tpu_torch/parity_scale.py` genome
simulator, kept here so that later changes to the program cannot move
the benchmark's genomes.

db keys: `contig`, `length`, `tandem_copies`, `segdups`, `seed`.
"""

from __future__ import annotations

import numpy as np

from benchmark.sim import random_seq


def diverge(rng, seq: np.ndarray, n_sub: int) -> np.ndarray:
    """A copy of seq with n_sub positions set to a random base (which may
    be the base already there)."""
    out = seq.copy()
    out[rng.integers(0, len(out), n_sub)] = random_seq(rng, n_sub)
    return out


def fill_blocks(rng, target: int, element: np.ndarray, share: float,
                lo: int, hi: int) -> list[np.ndarray]:
    """Blocks until `target` bases: `element` with probability `share`,
    else a unique random block of lo to hi - 1 bases."""
    blocks, made = [], 0
    while made < target:
        if rng.random() < share:
            blocks.append(element)
        else:
            blocks.append(random_seq(rng, int(rng.integers(lo, hi))))
        made += len(blocks[-1])
    return blocks


def shuffled(rng, parts: list[np.ndarray], length: int) -> np.ndarray:
    return np.concatenate([parts[i] for i in
                           rng.permutation(len(parts))])[:length]


def make_genome(rng, length: int, tandem_copies: int, segdups: int
                ) -> np.ndarray:
    """A 300 bp dispersed element in 10% of the blocks, a 250 bp unit in
    tandem, 50 kbp segmental duplications at ~0.1% divergence (50
    substitutions each), unique blocks of 1.5-9 kbp, shuffled."""
    alu = random_seq(rng, 300)
    unit = random_seq(rng, 250)
    parts = [np.tile(unit, tandem_copies)]
    seg = random_seq(rng, 50_000)
    parts += [diverge(rng, seg, 50) for _ in range(segdups)]
    parts += fill_blocks(rng, length - sum(len(p) for p in parts), alu,
                         0.10, 1_500, 9_000)
    return shuffled(rng, parts, length)


def make(db: dict, rng, made: dict) -> tuple[list, dict]:
    """([(contig name, uint8 ASCII bases)], {}): the db's one contig."""
    return [(db["contig"], make_genome(rng, db["length"],
                                       db["tandem_copies"],
                                       db["segdups"]))], {}
