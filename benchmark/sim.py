"""Reads simulated with numpy from a seed, and the FASTA and FASTQ
writers (the genomes are the recipes' under `recipes/`).

The writers (`write_fasta`, `write_fastq`) are copies of the port's
`ibwa_tpu_torch/parity_scale.py` simulators, kept here so that later changes
to the program cannot move the benchmark's inputs.  `sim_single` draws
single-end reads by the wgsim model of Li & Durbin 2009: a uniform base
error rate, mutations (a share of them indels, each extended with a fixed
probability) drawn for each read, half of the reads reverse-complemented,
positions uniform over the genome.
"""

from __future__ import annotations

import pathlib

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b
CODE = np.full(256, 4, dtype=np.uint8)      # ASCII -> 0..3, else 4
for _i, _b in enumerate(b"ACGT"):
    CODE[_b] = _i
    CODE[_b + 32] = _i
DEL_ROOM = 64        # reference bases past a read's end, room for deletions


def random_seq(rng, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def write_fasta(path: pathlib.Path, contigs) -> None:
    """contigs: (name, uint8 ASCII bases); 70 bases a line."""
    with open(path, "wb") as f:
        for name, seq in contigs:
            f.write(b">%s\n" % name.encode())
            full = len(seq) // 70 * 70
            if full:
                body = np.empty((full // 70, 71), dtype=np.uint8)
                body[:, :70] = seq[:full].reshape(-1, 70)
                body[:, 70] = ord("\n")
                f.write(body.tobytes())
            if len(seq) > full:
                f.write(seq[full:].tobytes() + b"\n")


def write_fastq(path: pathlib.Path, prefix: bytes, reads) -> None:
    """reads: uint8 rows, named prefix + index, each base quality 'I'."""
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s%d\n%s\n+\n%s\n" % (prefix, i, r.tobytes(),
                                                  b"I" * len(r))
                         for i, r in enumerate(reads)))


def fasta_bases(fa: pathlib.Path) -> np.ndarray:
    """Every contig's bases of a FASTA file, one uint8 ASCII array."""
    with open(fa, "rb") as f:
        return np.frombuffer(b"".join(ln.rstrip(b"\n") for ln in f
                                      if ln[:1] != b">"), dtype=np.uint8)


def _mutate(rng, window: np.ndarray, n: int, events: np.ndarray,
            indel_frac: float, indel_ext: float) -> np.ndarray:
    """The first n bases of `window` after the mutations at `events`
    (window positions, ascending): a substitution to another base, or
    with probability `indel_frac` an insertion or a deletion whose length
    grows by one with probability `indel_ext` at a time."""
    out, src = [], 0
    for p in events:
        p = int(p)
        if p < src:
            continue
        out.append(window[src:p])
        if rng.random() < indel_frac:
            size = 1
            while rng.random() < indel_ext:
                size += 1
            if rng.random() < 0.5:
                out.append(window[p:p + 1])
                out.append(random_seq(rng, size))
                src = p + 1
            else:
                src = p + size
        else:
            was = int(CODE[window[p]])
            out.append(BASES[[(was + int(rng.integers(1, 4))) % 4]])
            src = p + 1
    out.append(window[src:])
    return np.concatenate(out)[:n]


def sim_single(rng, genome: np.ndarray, n: int, read_len: int,
               base_error: float, mutation_rate: float, indel_frac: float,
               indel_ext: float, revcomp: float) -> np.ndarray:
    """n reads of read_len bases (uint8 ASCII rows) by the wgsim model:
    positions uniform, mutations at `mutation_rate` a base (`indel_frac`
    of them indels), then `base_error` of the bases set to another base,
    then `revcomp` of the reads reverse-complemented."""
    span = read_len + DEL_ROOM
    pos = rng.integers(0, len(genome) - span, n)
    reads = genome[pos[:, None] + np.arange(read_len)]
    n_mut = rng.binomial(read_len, mutation_rate, n)
    for i in np.nonzero(n_mut)[0]:
        window = genome[pos[i]:pos[i] + span]
        at = np.sort(rng.choice(read_len, n_mut[i], replace=False))
        reads[i] = _mutate(rng, window, read_len, at, indel_frac, indel_ext)
    err = rng.random((n, read_len), dtype=np.float32) < base_error
    shift = rng.integers(1, 4, int(err.sum()))
    reads[err] = BASES[(CODE[reads[err]] + shift) % 4]
    rc = rng.random(n) < revcomp
    reads[rc] = COMP[reads[rc, ::-1]]
    return reads


def write_shard(job: tuple) -> np.ndarray:
    """One FASTQ shard: (genome .npy path, rng seed list, read count, the
    traffic's model parameters, FASTQ path, read name prefix) -> its
    reads, drawn by `sim_single` and written by `write_fastq`."""
    genome_npy, seed, n, t, fq, prefix = job
    genome = np.load(genome_npy, mmap_mode="r")
    reads = sim_single(np.random.default_rng(seed), genome, n,
                       t["read_len"], t["base_error"], t["mutation_rate"],
                       t["indel_fraction"], t["indel_extend"], t["revcomp"])
    write_fastq(pathlib.Path(fq), prefix, reads)
    return reads
