"""Seeded synthetic genomes for the port's smoke run and probes.

`make_genome` is the recipe of the JAX package's benchmark harness
(`bench.py::make_genome`), copied so that the same `random.Random` seed
gives the same sequence in both: numbers taken on the port's genome
stand beside earlier ones taken on the harness's.
"""

from __future__ import annotations

import random

GENOME_LEN = 32_000_000   # chr20-scale


def make_genome(rng: random.Random, genome_len: int = GENOME_LEN) -> str:
    """~15% repeat content: dispersed ~300bp elements (10%), one tandem
    array (3%), diverged 50kb segmental duplications (2%)."""
    parts = []
    alu = "".join(rng.choice("ACGT") for _ in range(300))
    unit = "".join(rng.choice("ACGT") for _ in range(250))
    parts.append(unit * 3840)  # ~0.96 Mbp tandem array
    seg = "".join(rng.choice("ACGT") for _ in range(50_000))
    for _ in range(13):        # ~0.65 Mbp segdups at ~0.1% divergence
        s = list(seg)
        for _ in range(50):
            p = rng.randrange(len(s))
            s[p] = rng.choice("ACGT")
        parts.append("".join(s))
    made = sum(len(p) for p in parts)
    blocks = []
    while made < genome_len:
        if rng.random() < 0.10:
            blocks.append(alu)
            made += len(alu)
        else:
            n = rng.randrange(1500, 9000)
            blocks.append("".join(rng.choice("ACGT") for _ in range(n)))
            made += n
    parts.extend(blocks)
    rng.shuffle(parts)
    return "".join(parts)[:genome_len]
