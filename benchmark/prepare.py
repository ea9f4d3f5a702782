"""Make a configuration's dbs, each its FASTA, the files its recipe
writes beside it, the program's index of it and the reference's own
index, once per checkout, under `.cache/<config>/`.

    python3 -m benchmark.prepare CONFIG_FILE

A db's recipe is `recipes/<recipe>.py`: its `make(db, rng, made)` returns
the db's contigs and the files to write beside its FASTA ({suffix:
bytes}), from the db's own seed (never a run's `--seed`) and the dbs made
before it (`made`: name -> contigs), so a db can name an earlier one as
its `source`.  The dbs are made in the configuration's order.
`ready.json`, written last, holds a hash of the dbs' entries, of their
recipes' files and of the sources that carry them out: a cache whose
hash differs is made again.  The program's index is made by its own
`index` command; the reference's (`refindex.build`) from the same FASTA,
on the card where there is one.
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
    """A hash of what the cache is made from: the dbs' entries, their
    recipes' files and the sources that carry them out."""
    h = hashlib.sha256(json.dumps(cfg["dbs"], sort_keys=True).encode())
    for name in ("sim.py", "refindex.py", "prepare.py"):
        h.update((spec.HERE / name).read_bytes())
    for recipe in sorted({db["recipe"] for db in cfg["dbs"]}):
        h.update(spec.recipe_file(recipe).read_bytes())
    return h.hexdigest()


def is_ready(cfg: dict) -> bool:
    ready = cache_dir(cfg) / "ready.json"
    return ready.is_file() and \
        json.loads(ready.read_text()).get("fingerprint") == fingerprint(cfg)


def db_contigs(db: dict, made: dict) -> tuple[list, dict]:
    """One db by its recipe: its FASTA contigs [(name, uint8 ASCII
    bases)] and the files to write beside the FASTA ({suffix: bytes});
    `made`: the contigs of the dbs made before it, by name."""
    return spec.recipe(db["recipe"]).make(
        db, np.random.default_rng(db["seed"]), made)


def say(msg: str) -> None:
    print(f"[benchmark.prepare] {msg}", file=sys.stderr, flush=True)


def prepare(cfg: dict, device: str) -> None:
    out = cache_dir(cfg)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    from ibwa_tpu_torch import cli
    times, made = {}, {}
    for db in cfg["dbs"]:
        t0 = time.perf_counter()
        contigs, extra = db_contigs(db, made)
        made[db["name"]] = contigs
        fa = out / f"{db['name']}.fa"
        sim.write_fasta(fa, contigs)
        for suffix, data in extra.items():
            fa.with_name(fa.name + suffix).write_bytes(data)
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
