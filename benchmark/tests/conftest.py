"""A tiny configuration of the benchmark's own shape, made once per test
run on the CPU: a 300 kbp genome by the chr1 recipe, the program's index
of it and the reference's."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import prepare, spec  # noqa: E402


def tiny_cfg() -> dict:
    cfg = spec.load_json(spec.HERE / "configs" / "grch37_chr1.json")
    cfg["name"] = "tiny_chr1"
    cfg["dbs"][0].update(length=300_000, tandem_copies=30, segdups=1)
    cfg["aln_args"] = ["-t", "2"]
    return cfg


def tiny_traffic() -> dict:
    t = spec.traffic("se100_err2")
    t.update(shard_reads=32, shards=16, warmup_reads=32, check_reads=48,
             base_error=0.002)
    return t


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(cfg, traffic) of the tiny configuration, its cache made."""
    was = spec.CACHE
    spec.CACHE = tmp_path_factory.mktemp("cache")
    cfg = tiny_cfg()
    prepare.prepare(cfg, "cpu")
    yield cfg, tiny_traffic()
    spec.CACHE = was
