"""What a later cell finds by name, and the loop that outlives its inputs,
on the CPU: the genome recipes (bytes, the cache's hash, the alternate db
and its .remap file through the program's index, `aln` and `sampe -R`),
the control's runs, and window shards that cycle over the written
inputs with outputs of their own."""

import hashlib
import shutil

import numpy as np
import pytest

from benchmark import control, harness, prepare, refaln, sim, spec
from benchmark.recipes.alternates import haplotype
from benchmark.recipes.make_genome import make_genome
from benchmark.tests.conftest import tiny_cfg
from benchmark.tests.test_harness_cells import _reads

# sha256 of the tiny configuration's chr1.fa as `sim.make_genome` wrote it
# before the recipe moved to recipes/make_genome.py
TINY_CHR1_FA = \
    "b504d259cc13f88b4da7853f94c207c5c0284fadde14362d2579784d2f8d97ce"


def test_make_genome_bytes_through_the_recipe_route(tmp_path):
    db = tiny_cfg()["dbs"][0]
    contigs, extra = prepare.db_contigs(db, {})
    assert extra == {} and [n for n, _ in contigs] == ["chr1"]
    sim.write_fasta(tmp_path / "chr1.fa", contigs)
    assert hashlib.sha256((tmp_path / "chr1.fa").read_bytes()).hexdigest() \
        == TINY_CHR1_FA


def test_fingerprint_follows_the_recipe_file(tmp_path, monkeypatch):
    cfg = tiny_cfg()
    before = prepare.fingerprint(cfg)
    copy = tmp_path / "make_genome.py"
    shutil.copy(spec.recipe_file("make_genome"), copy)
    monkeypatch.setattr(spec, "recipe_file", lambda name: copy)
    assert prepare.fingerprint(cfg) == before
    copy.write_text(copy.read_text() + "\n# changed\n")
    assert prepare.fingerprint(cfg) != before


@pytest.mark.parametrize("snp_rate", [0.0, 1 / 300])
def test_alternates_cigar_walked_over_the_source_gives_the_haplotype(
        snp_rate):
    src = make_genome(np.random.default_rng(5), 120_000, 20, 1)
    rng = np.random.default_rng([9, int(snp_rate * 1e6)])
    for start, length in ((1_000, 20_000), (60_000, 30_000)):
        hap, cig, stop = haplotype(rng, src, start, length, snp_rate,
                                   1 / 400, [1, 20])
        assert len(hap) == length and cig[0][0] == "M" and cig[-1][0] == "M"
        walked, a, r, subs = [], 0, start, 0
        for op, n in cig:
            if op == "M":
                walked.append(src[r:r + n])
                subs += int((src[r:r + n] != hap[a:a + n]).sum())
                a, r = a + n, r + n
            elif op == "I":
                walked.append(hap[a:a + n])
                a += n
            else:
                assert op == "D" and 1 <= n <= 20
                r += n
        assert (a, r) == (length, stop)
        assert sum(n for op, n in cig if op in "ID") > 0
        back = np.concatenate(walked)
        if snp_rate == 0:
            assert back.tobytes() == hap.tobytes()
        else:
            assert int((back != hap).sum()) == subs
            assert 0.5 * length * snp_rate < subs < 1.5 * length * snp_rate


def _two_db_cfg() -> dict:
    return {
        "name": "tiny_remap",
        "dbs": [
            {"name": "chr20", "recipe": "make_genome", "contig": "chr20",
             "length": 200_000, "tandem_copies": 20, "segdups": 1,
             "seed": 20261020},
            {"name": "alt", "recipe": "alternates", "source": "chr20",
             "haplotypes": [[20_000, 15_000], [120_000, 15_000]],
             "snp_rate": 1 / 300, "indel_rate": 1 / 2000,
             "indel_len": [1, 20], "exact": [[80_000, 8_000]],
             "seed": 20261021}]}


def _pairs(rng, contigs, n, read_len=70):
    """n pairs from the contigs in turn, fragments of 180-320 bp, the
    second end reverse-complemented, ends swapped for half of them."""
    ends = ([], [])
    for i in range(n):
        seq = contigs[i % len(contigs)]
        size = int(rng.integers(180, 320))
        pos = int(rng.integers(0, len(seq) - size))
        frag = seq[pos:pos + size]
        a, b = frag[:read_len], sim.COMP[frag[-read_len:][::-1]]
        if rng.random() < 0.5:
            a, b = b, a
        ends[0].append(a)
        ends[1].append(b)
    return ends


def test_two_db_remap_pipeline_writes_zr_tags(tmp_path, monkeypatch):
    """The alternates db through the program: its index of both dbs, `aln`
    of both ends against both, then `sampe -R` over a few hundred pairs."""
    from ibwa_tpu_torch import cli
    from ibwa_tpu_torch.sam.remap import load_remap
    monkeypatch.setattr(spec, "CACHE", tmp_path / "cache")
    cfg = _two_db_cfg()
    prepare.prepare(cfg, "cpu")
    assert prepare.is_ready(cfg)
    cache = prepare.cache_dir(cfg)
    made = {}
    for db in cfg["dbs"]:
        made[db["name"]] = prepare.db_contigs(db, made)[0]
    alt = dict(made["alt"])
    recs = load_remap(str(cache / "alt.fa"))
    assert [(r.target, r.exact) for r in recs.values()] == \
        [("chr20", False), ("chr20", False), ("chr20", True)]
    assert recs[0].start == 20_000 and \
        sum(n for n, op in recs[0].cigar if op in "MI") == len(alt["hap0"])
    assert alt["exact0"].tobytes() == \
        made["chr20"][0][1][80_000:88_000].tobytes()
    sources = [made["chr20"][0][1], alt["hap0"], alt["hap1"], alt["exact0"]]
    fqs = [tmp_path / f"p_{e}.fq" for e in (1, 2)]
    for fq, reads in zip(fqs, _pairs(np.random.default_rng(11), sources,
                                     300)):
        sim.write_fastq(fq, b"p", reads)
    sai_args = []
    for db in ("chr20", "alt"):
        fa = str(cache / f"{db}.fa")
        sai_args.append(fa)
        for e, fq in enumerate(fqs):
            sai = tmp_path / f"{db}_{e}.sai"
            assert cli.main(["aln", "-t", "2", "--device", "cpu", "-f",
                             str(sai), fa, str(fq)]) == 0
            assert len(refaln.split_records(sai.read_bytes())[1]) == 300
            sai_args.append(str(sai))
    sam = tmp_path / "out.sam"
    args = [sai_args[0], sai_args[1], sai_args[2], *map(str, fqs),
            *sai_args[3:]]
    assert cli.main(["sampe", "-R", "--device", "cpu", "-f", str(sam),
                     *args]) == 0
    body = [ln for ln in sam.read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) == 600
    remapped = [ln for ln in body if "\tZR:Z:" in ln]
    assert len(remapped) > 20
    assert all(ln.split("\t")[2] == "chr20" and
               ln.split("\tZR:Z:")[1].startswith(("hap", "exact"))
               for ln in remapped)


def _ctx(cfg, traffic, seed, tmp):
    return harness.Ctx(cfg, traffic, seed, tmp, prepare.cache_dir(cfg),
                       ("--device", "cpu"), 1, "cpu")


def test_loop_outlives_its_written_shards(tiny, tmp_path):
    """Two written shards, more window shards: window shard i runs input
    i mod 2 into a .sai of its own, and the check reads each against its
    own input's reads (two swapped .sai files read wrong)."""
    cfg, t = tiny
    t = dict(t, shards=2)
    ctx = _ctx(cfg, t, 2**31 + 21, tmp_path)
    mode = spec.mode("aln")
    mode.make_inputs(ctx)
    _, shards = harness.closed_loop(mode, ctx, 40.0, False, False)
    done = [s for s in shards if not s.get("cut")]
    assert len(done) >= 3, [(s["index"], s["start"], s["end"])
                            for s in shards]
    assert [s["input"] for s in shards] == \
        [i % 2 for i in range(len(shards))]
    assert all(s["rc"] == 0 for s in done)
    sai = [tmp_path / f"window{s['index']}.sai" for s in done]
    assert len(set(sai)) == len(done) and all(p.is_file() for p in sai)
    assert sai[0].read_bytes() == sai[2].read_bytes() != sai[1].read_bytes()
    view = harness.View(ctx, shards, done, done[-1]["end"], {}, None, 0.0)
    assert mode.check(ctx, view) == [("sai_header_wrong", 0, 0),
                                     ("sai_reads_missing", 0, 0),
                                     ("sampled_reads_wrong", 0, 0)]
    a, b = sai[0].read_bytes(), sai[1].read_bytes()
    sai[0].write_bytes(b)
    sai[1].write_bytes(a)
    wrong = dict((n, v) for n, v, _ in mode.check(ctx, view))
    assert wrong["sampled_reads_wrong"] > 0


def test_control_plants_no_fallback_in_a_run_of_the_cell(monkeypatch):
    """The control is one run of the cell a seed with `no_fallback` in
    every command, its window the cell's `run_seconds` unless given."""
    got = []

    def run_cell(cfg, traffic, metrics, seed, seconds, trace, t0, **kw):
        got.append((seed, seconds, trace, kw["plant"]))
        return {"correct": False, "attempted": 8, "failed": 0,
                "checks": [("sampled_reads_wrong", 3, 0)]}
    monkeypatch.setattr(harness, "run_cell", run_cell)
    assert control.main(["--workload", "chr1_aln_err2",
                         "--seeds", "5,6"]) == 0
    window = spec.Bench().doc["run_seconds"]
    assert got == [(5, window, False, "no_fallback"),
                   (6, window, False, "no_fallback")]


def test_no_fallback_leaves_the_overflow_to_the_card(tiny, tmp_path,
                                                    monkeypatch):
    """`no_fallback` (the `aln` cells' control) in this process, on the
    engine's own call into its host pool: with a step budget of 16 reads
    overflow, the planted pool runs no overflow job, and the .sai keeps
    the search's cut-short hits, which the reference does not give."""
    from ibwa_tpu_torch import cli
    from ibwa_tpu_torch.align import engine
    from benchmark import plants, refcheck
    cfg, _ = tiny
    cache = spec.CACHE / cfg["name"]
    for name in ("ITER_CAP", "_decode"):
        monkeypatch.setattr(engine, name, getattr(engine, name))
    monkeypatch.setattr(engine.TorchAlnEngine, "align_batch",
                        engine.TorchAlnEngine.align_batch)
    monkeypatch.setenv("IBWA_HOST_FRAC", "0")
    engine.ITER_CAP = 16
    genome = np.load(cache / "chr1.bases.npy")
    reads = _reads(2**33 + 5, genome)[:60]
    sim.write_fastq(tmp_path / "r.fq", b"r", reads)
    want = refcheck.reference_records(cache / "ref_chr1", list(reads),
                                      cfg["aln_args"], 100, workers=1)
    jobs = []
    orig = engine.native_align_batch
    monkeypatch.setattr(engine, "native_align_batch",
                        lambda *a: jobs.append(len(a[1])) or orig(*a))

    def aln(name):
        sai = tmp_path / f"{name}.sai"
        assert cli.main(["aln", *cfg["aln_args"], "--engine", "torch",
                         "--device", "cpu", "-f", str(sai),
                         str(cache / "chr1.fa"), str(tmp_path / "r.fq")]) == 0
        return refaln.split_records(sai.read_bytes())[1]
    assert aln("sound") == want and sum(jobs) > 0
    jobs.clear()
    plants.plant("no_fallback", [])
    got = aln("planted")
    assert jobs == [] and len(got) == len(want)
    assert sum(g != w for g, w in zip(got, want)) > 0
