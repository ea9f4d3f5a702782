"""Make a configuration's genome, its FASTA, the program's index of it and
the reference's own index, once per checkout, under `.cache/<config>/`.

    python3 -m benchmark.prepare CONFIG_FILE

`ready.json`, written last, holds a hash of the configuration's genome
recipes and of the sources that carry them out: a cache whose hash
differs is made again.  The genome comes from the configuration's own
seed, never from a run's `--seed`.  The program's index is made by its
own `index` command; the reference's (`refindex.build`) from the same
FASTA, on the card where there is one.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import sys
import time

import numpy as np

from benchmark import refindex, sim, spec


def cache_dir(cfg: dict) -> pathlib.Path:
    return spec.CACHE / cfg["name"]


def fingerprint(cfg: dict) -> str:
    """A hash of what the cache is made from: the dbs' recipes and the
    sources that carry them out."""
    h = hashlib.sha256(json.dumps(cfg["dbs"], sort_keys=True).encode())
    for name in ("sim.py", "refindex.py", "prepare.py"):
        h.update((spec.HERE / name).read_bytes())
    return h.hexdigest()


def is_ready(cfg: dict) -> bool:
    ready = cache_dir(cfg) / "ready.json"
    return ready.is_file() and \
        json.loads(ready.read_text()).get("fingerprint") == fingerprint(cfg)


def db_contigs(db: dict) -> list:
    """The FASTA contigs of one db by its recipe."""
    rng = np.random.default_rng(db["seed"])
    if db["recipe"] == "make_genome":
        seq = sim.make_genome(rng, db["length"], db["tandem_copies"],
                              db["segdups"])
        return [(db["contig"], seq)]
    raise ValueError(f"unknown genome recipe {db['recipe']!r}")


def say(msg: str) -> None:
    print(f"[benchmark.prepare] {msg}", file=sys.stderr, flush=True)


def prepare(cfg: dict, device: str) -> None:
    out = cache_dir(cfg)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    from ibwa_tpu_torch import cli
    times = {}
    for db in cfg["dbs"]:
        t0 = time.perf_counter()
        contigs = db_contigs(db)
        fa = out / f"{db['name']}.fa"
        sim.write_fasta(fa, contigs)
        np.save(out / f"{db['name']}.bases.npy",
                np.concatenate([c for _, c in contigs]))
        t1 = time.perf_counter()
        if cli.main(["index", str(fa)]) != 0:
            raise RuntimeError(f"the program's index of {fa} failed")
        t2 = time.perf_counter()
        refindex.build(sim.CODE[sim.fasta_bases(fa)],
                       out / f"ref_{db['name']}", device)
        t3 = time.perf_counter()
        times[db["name"]] = {"genome_s": t1 - t0, "program_index_s": t2 - t1,
                             "reference_index_s": t3 - t2}
        say(f"{db['name']}: genome {t1 - t0:.1f} s, program's index "
            f"{t2 - t1:.1f} s, reference's index {t3 - t2:.1f} s")
    (out / "ready.json").write_text(json.dumps(
        {"fingerprint": fingerprint(cfg), "seconds": times}))


def main(argv: list[str]) -> int:
    import torch
    cfg = spec.load_json(pathlib.Path(argv[0]))
    prepare(cfg, "cuda" if torch.cuda.is_available() else "cpu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
