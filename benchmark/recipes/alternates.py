"""The `alternates` recipe: iBWA's alternate-reference db, derived from an
earlier db of the configuration (`source`, one contig), with the
`<fa>.remap` file that maps each alternate contig back onto the source.

- Haplotypes (`haplotypes`: [start, length] pairs, 0-based on the
  source): the source's bases from `start` with, at each base, a SNP at
  `snp_rate` or an insertion or deletion of `indel_len` [lo, hi] bases at
  `indel_rate` (half of them each), until the haplotype has `length`
  bases; it starts and ends on matched bases.  Contig `hap<i>`, remap
  record `>h<i>-<source contig>|<start + 1>|<source position past its
  end>` and its CIGAR (alt = query, source = reference: M for matched and
  substituted bases, I for inserted, D for deleted), 60 letters a line.
- Exact contigs (`exact`: [start, length] pairs): the source's bases as
  they are.  Contig `exact<i>`, remap record `>x<i>-<source contig>|exact|0`.

The format is the one iBWA's `bwaremap.cpp` (load_remappings) reads.
"""

from __future__ import annotations

import numpy as np

from benchmark.sim import BASES, CODE, random_seq


def haplotype(rng, src: np.ndarray, start: int, length: int,
              snp_rate: float, indel_rate: float, indel_len
              ) -> tuple[np.ndarray, list, int]:
    """(bases, CIGAR runs [[op, n]], source position past its end)."""
    lo, hi = indel_len
    rate = snp_rate + indel_rate
    parts, cig = [], []
    pos, made = start, 0

    def push(op, n):
        if cig and cig[-1][0] == op:
            cig[-1][1] += n
        else:
            cig.append([op, n])

    while True:
        m = int(rng.geometric(rate)) if rate > 0 else length
        last = made + m + hi >= length
        if last:
            m = length - made
        if pos + m > len(src):
            raise ValueError(f"a haplotype from {start} runs past the "
                             f"source's {len(src)} bases")
        parts.append(src[pos:pos + m])
        push("M", m)
        pos, made = pos + m, made + m
        if last:
            return np.concatenate(parts), cig, pos
        if rng.random() < indel_rate / rate:
            n = int(rng.integers(lo, hi + 1))
            if rng.random() < 0.5:
                push("D", n)
                pos += n
            else:
                parts.append(random_seq(rng, n))
                push("I", n)
                made += n
        else:
            shift = int(rng.integers(1, 4))
            parts.append(BASES[[(int(CODE[src[pos]]) + shift) % 4]])
            push("M", 1)
            pos, made = pos + 1, made + 1


def make(db: dict, rng, made: dict) -> tuple[list, dict]:
    """([(contig name, uint8 ASCII bases)], {".remap": bytes})."""
    source = made[db["source"]]
    if len(source) != 1:
        raise ValueError(f"the source db {db['source']!r} has "
                         f"{len(source)} contigs; alternates takes one")
    name, src = source[0]
    contigs, remap = [], []
    for i, (start, length) in enumerate(db["haplotypes"]):
        seq, cig, stop = haplotype(rng, src, start, length, db["snp_rate"],
                                   db["indel_rate"], db["indel_len"])
        text = "".join(f"{n}{op}" for op, n in cig)
        contigs.append((f"hap{i}", seq))
        remap.append(f">h{i}-{name}|{start + 1}|{stop}\n" + "".join(
            text[j:j + 60] + "\n" for j in range(0, len(text), 60)))
    for i, (start, length) in enumerate(db["exact"]):
        if start + length > len(src):
            raise ValueError(f"an exact contig from {start} runs past the "
                             f"source's {len(src)} bases")
        contigs.append((f"exact{i}", src[start:start + length].copy()))
        remap.append(f">x{i}-{name}|exact|0\n")
    return contigs, {".remap": "".join(remap).encode()}
