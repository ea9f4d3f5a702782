"""The port's SAM stages (`ibwa_tpu_torch/sam/`) against ibwa_tpu's.

`samse` (`sai2sam_se`) and `sampe` (`sai2sam_pe`) of both packages read
the same index, the same .sai and the same FASTQ; their SAM text must be
equal byte for byte, the @PG line included.  The cases are those of
`tests/test_samse.py`, `test_sampe.py`, `test_remap.py` and
`test_colorspace.py`, whose oracle is the reference binary; here
`ibwa_tpu` takes its place.  `sampe` also runs with its SA walks on a
torch device: on CPU tensors the walker runs K5's plain version
(`lf_walk_plain`), and its SAM must equal the host walks'.
"""

import contextlib
import io
import random
import re

import pytest
import torch

from ibwa_tpu import cli as jcli
from ibwa_tpu.sam.bwase import sai2sam_se as j_sai2sam_se
from ibwa_tpu.sam.sampe import PeOpt as JPeOpt
from ibwa_tpu.sam.sampe import sai2sam_pe as j_sai2sam_pe

from ibwa_tpu_torch import cli as tcli
from ibwa_tpu_torch.align.opts import BWA_MODE_COMPREAD, GapOpt
from ibwa_tpu_torch.align.pipeline import aln_to_stream
from ibwa_tpu_torch.index import builder
from ibwa_tpu_torch.index.builder import NST_COLOR_SPACE_TABLE
from ibwa_tpu_torch.sam.bwase import parse_rg
from ibwa_tpu_torch.sam.bwase import sai2sam_se as t_sai2sam_se
from ibwa_tpu_torch.sam.sampe import PeOpt as TPeOpt
from ibwa_tpu_torch.sam.sampe import sai2sam_pe as t_sai2sam_pe

from conftest import make_genome, simulate_reads

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _sai(prefix, fq, opt, path):
    """The .sai both packages' SAM stages read (the port's native search,
    which the aln tests hold byte-equal to ibwa_tpu's)."""
    if not path.exists():
        with open(path, "wb") as f:
            with contextlib.redirect_stderr(io.StringIO()):
                aln_to_stream(str(prefix), str(fq), opt, f, engine="native")
    return str(path)


def _run(fn, *args, **kw):
    """(SAM text, stderr) of one SAM stage."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        fn(*args, out=out, **kw)
    return out.getvalue(), err.getvalue()


def _mapped(sam: str) -> int:
    return sum(1 for ln in sam.splitlines()
               if ln and ln[0] != "@" and not int(ln.split("\t")[1]) & 4)


def _prefill_rows(err: str) -> int:
    rows = [int(m) for m in re.findall(r"\[sai2sam_pe\] prefill (\d+) rows",
                                       err)]
    assert rows, err[-2000:]
    return sum(rows)


# ---- samse ---------------------------------------------------------------

@pytest.fixture(scope="module")
def se_case(tmp_path_factory):
    """tests/test_samse.py's fixture: 70 kbp, an N-bearing contig, 120
    reads of 80 bp with low-quality halves on every other read."""
    tmp = tmp_path_factory.mktemp("tsamse")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("ctg1", "test", 50000, 0.001),
                                   ("ctg2", "", 20000, 0.0)], seed=2024)
    builder.bwa_index(str(fa))
    fq = tmp / "r.fq"
    simulate_reads(str(fq), genome, 120, read_len=80, err=0.02, seed=55)
    lines = fq.read_text().split("\n")
    for i in range(3, len(lines), 8):
        q = lines[i]
        if q:
            lines[i] = q[: len(q) // 2] + "#" * (len(q) - len(q) // 2)
    fq.write_text("\n".join(lines))
    return tmp, fa, fq


SE_CASES = {
    # (aln GapOpt, samse keywords)
    "default": (GapOpt(), {}),
    "gappy": (GapOpt(max_gapo=2, max_gape=4, mode=GapOpt().mode & ~0x01), {}),
    "trimmed": (GapOpt(trim_qual=20), {}),
    "multi": (GapOpt(), {"n_occ": 10}),
    "rg": (GapOpt(), dict(zip(("rg_line", "rg_id"),
                              parse_rg("@RG\\tID:lane1\\tSM:s1")))),
}


@pytest.mark.parametrize("case", list(SE_CASES))
def test_samse_sam_byte_equal(se_case, case):
    tmp, fa, fq = se_case
    opt, kw = SE_CASES[case]
    sai = _sai(fa, fq, opt, tmp / f"{case}.sai")
    got, _ = _run(t_sai2sam_se, str(fa), sai, str(fq), **kw)
    want, _ = _run(j_sai2sam_se, str(fa), sai, str(fq), **kw)
    assert got == want
    assert got.count("\n") > 120 and _mapped(got) > 60


def test_samse_pure_python_route(se_case, monkeypatch):
    """IBWA_PURE_PY=1 (the Python route, the semantic reference of the
    native stage) in both packages, and equal to the native route."""
    tmp, fa, fq = se_case
    sai = _sai(fa, fq, GapOpt(), tmp / "default.sai")
    native, _ = _run(t_sai2sam_se, str(fa), sai, str(fq))
    monkeypatch.setenv("IBWA_PURE_PY", "1")
    got, _ = _run(t_sai2sam_se, str(fa), sai, str(fq))
    want, _ = _run(j_sai2sam_se, str(fa), sai, str(fq))
    assert got == want == native


# ---- sampe ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pe_case(tmp_path_factory):
    """tests/test_sampe.py's fixture: 85 kbp, 250 pairs of 90 bp."""
    tmp = tmp_path_factory.mktemp("tsampe")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("chr1", "c", 60000, 0.001),
                                   ("chr2", "", 25000, 0.0)], seed=909)
    builder.bwa_index(str(fa))
    fqs = simulate_reads(str(tmp / "pe"), genome, 250, read_len=90,
                         err=0.015, seed=77, paired=True, isize_mean=280,
                         isize_sd=35)
    return tmp, fa, fqs


GAPPY = GapOpt(max_gapo=2, max_gape=4, mode=GapOpt().mode & ~0x01)
PE_CASES = {
    # (aln GapOpt, PeOpt fields), as tests/test_sampe.py
    "default": (GapOpt(), dict(remapping=1)),
    "no_remap_quirk": (GapOpt(), {}),
    "no_sw": (GapOpt(), dict(remapping=1, is_sw=0)),
    "gappy": (GAPPY, dict(remapping=1)),
    "multi": (GapOpt(), dict(remapping=1, n_multi=8, N_multi=20)),
    "isize": (GapOpt(), dict(remapping=1, max_isize=350)),
}


def _pe_sais(tmp, fa, fqs, opt, tag):
    return [_sai(fa, fq, opt, tmp / f"{tag}.{e}.sai")
            for e, fq in enumerate(fqs)]


@pytest.mark.parametrize("case", list(PE_CASES))
def test_sampe_sam_byte_equal(pe_case, case):
    """The port's native route (SA walks on the host) against ibwa_tpu's
    default route."""
    tmp, fa, fqs = pe_case
    opt, fields = PE_CASES[case]
    sais = _pe_sais(tmp, fa, fqs, opt, "gappy" if opt is GAPPY else "plain")
    got, _ = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                  TPeOpt(**fields))
    want, _ = _run(j_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                   JPeOpt(**fields))
    assert got == want
    if fields.get("remapping"):
        assert _mapped(got) > 400
    else:
        assert _mapped(got) == 0     # the reference's quirk without -R


@pytest.mark.parametrize("case", ["default", "multi"])
def test_sampe_device_walks_match_host_walks(pe_case, case):
    """-R with the SA walks prefilled by the walker on CPU tensors (K5's
    plain version): the same SAM as the host walks and as ibwa_tpu, with
    mapped records, and the prefill walked rows."""
    tmp, fa, fqs = pe_case
    opt, fields = PE_CASES[case]
    sais = _pe_sais(tmp, fa, fqs, opt, "plain")
    dev, err = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                    TPeOpt(**fields), device=CPU)
    host, _ = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                   TPeOpt(**fields))
    want, _ = _run(j_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                   JPeOpt(**fields))
    assert dev == host == want
    assert _mapped(dev) > 400
    assert _prefill_rows(err) > 0


PREFILL_LINE = re.compile(
    r"\[sai2sam_pe\] prefill (\d+) rows in (\d+) waves, (\d+) launches; "
    r"(\d+) values refused by the cache, (\d+) host walks since the last "
    r"batch")
LAST_LINE = re.compile(r"\[sai2sam_pe\] (\d+) host walks after the last "
                       r"prefill")


def _prefill_lines(err: str) -> list[tuple[int, ...]]:
    """Per batch: (rows, waves, launches, values refused, host walks since
    the batch before); and the host walks after the last prefill."""
    found = [tuple(int(x) for x in m) for m in PREFILL_LINE.findall(err)]
    last = [int(x) for x in LAST_LINE.findall(err)]
    assert found and len(last) == 1, err[-2000:]
    return found, last[0]


def test_sampe_prefill_cap_reports_rows_left_to_host(pe_case, monkeypatch):
    """PeNative.PREFILL_MAX_ROWS is the size of a wave: at a third of the
    batch's rows every row is still resolved by the walker, in three or
    more waves, none is left to the host walks (the prefill line reports
    0, and so does the line after the last batch), the cache refuses
    nothing, and the SAM is still the host walks'."""
    from ibwa_tpu_torch.sam.pe_native import PeNative
    tmp, fa, fqs = pe_case
    sais = _pe_sais(tmp, fa, fqs, GapOpt(), "plain")
    run = lambda: _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                       TPeOpt(remapping=1), device=CPU)
    full, err = run()
    ((rows, waves, launches, refused, host),), last = _prefill_lines(err)
    assert rows > 0 and waves == 1 and launches == 0     # CPU: no kernel
    assert refused == host == last == 0
    monkeypatch.setattr(PeNative, "PREFILL_MAX_ROWS", rows // 3)
    capped, err = run()
    ((c_rows, c_waves, _, refused, host),), last = _prefill_lines(err)
    assert c_rows == rows and c_waves >= 3
    assert refused == host == last == 0
    native, _ = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                     TPeOpt(remapping=1))
    assert capped == full == native


def test_sampe_batches_prefill_their_own_walks(pe_case, monkeypatch):
    """sampe.BATCH lowered so that the 250 pairs make 3 batches: every
    batch's prefill reports 0 host walks and 0 refused values, the cache
    after each prefill holds that batch's intervals and nothing else, and
    the SAM is byte-equal to --engine native at the same BATCH."""
    import numpy as np
    from ibwa_tpu_torch.sam import sampe as tsampe
    from ibwa_tpu_torch.sam.pe_native import PeNative
    tmp, fa, fqs = pe_case
    sais = _pe_sais(tmp, fa, fqs, GapOpt(), "plain")
    monkeypatch.setattr(tsampe, "BATCH", 100)
    held, prefill = [], PeNative.device_prefill_walks

    def recorded(self, walkers, recs_by_db):
        out = prefill(self, walkers, recs_by_db)
        recs = np.concatenate(recs_by_db[0])
        recs = recs[recs[:, 2] >= recs[:, 1]]
        ivs = np.unique(recs[:, :3] & [1 << 24, 0xFFFFFFFF, 0xFFFFFFFF],
                        axis=0)
        held.append((self.walk_cache_size(),
                     (len(ivs), int((ivs[:, 2] - ivs[:, 1] + 1).sum()))))
        return out

    monkeypatch.setattr(PeNative, "device_prefill_walks", recorded)
    dev, err = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                    TPeOpt(remapping=1), device=CPU)
    lines, last = _prefill_lines(err)
    assert len(lines) == len(held) == 3 and last == 0
    assert all(ln[0] > 0 and ln[3] == ln[4] == 0 for ln in lines)
    for got, want in held:
        assert got == want and want[0] > 0
    native, _ = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                     TPeOpt(remapping=1))
    assert dev == native and _mapped(dev) > 400


def test_sampe_pure_python_route(pe_case, monkeypatch):
    """IBWA_PURE_PY=1 in both packages, -R, equal to the native route; a
    device given to the Python route is named, not used."""
    tmp, fa, fqs = pe_case
    sais = _pe_sais(tmp, fa, fqs, GapOpt(), "plain")
    native, _ = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                     TPeOpt(remapping=1))
    monkeypatch.setenv("IBWA_PURE_PY", "1")
    got, err = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                    TPeOpt(remapping=1), device=CPU)
    want, _ = _run(j_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                   JPeOpt(remapping=1))
    assert got == want == native
    assert "walks SA rows on the host" in err


def test_sampe_walker_failure_raises(pe_case):
    """A walker that cannot launch (its table on a device with no kernel
    and no plain version) raises; sampe does not carry on with the host
    walks."""
    tmp, fa, fqs = pe_case
    sais = _pe_sais(tmp, fa, fqs, GapOpt(), "plain")
    with pytest.raises(ValueError, match="unsupported device meta"):
        _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
             TPeOpt(remapping=1), device="meta")


# ---- multi-db remap (tests/test_remap.py's fixture) ----------------------

def _write_fa(path, contigs):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")


def _make_alt(primary, start, edits, rng):
    alt, cig, pos = [], [], start

    def push(op, ln):
        if cig and cig[-1][0] == op:
            cig[-1][1] += ln
        else:
            cig.append([op, ln])

    for kind, m_len, e_len in edits:
        alt.append(primary[pos:pos + m_len])
        push("M", m_len)
        pos += m_len
        if kind == "del":
            push("D", e_len)
            pos += e_len
        elif kind == "ins":
            alt.append("".join(rng.choice("ACGT") for _ in range(e_len)))
            push("I", e_len)
        elif kind == "snp":
            base = primary[pos]
            alt.append(rng.choice([c for c in "ACGT" if c != base]))
            push("M", 1)
            pos += 1
    return "".join(alt), "".join(f"{l}{o}" for o, l in cig), pos


@pytest.fixture(scope="module")
def remap_case(tmp_path_factory):
    """A primary reference and an alternate one whose contigs carry .remap
    CIGARs back onto it; pairs from both haplotypes."""
    tmp = tmp_path_factory.mktemp("tremap")
    rng = random.Random(31337)
    pfa = tmp / "p.fa"
    genome = make_genome(str(pfa), [("chr1", "primary", 50000, 0.0),
                                    ("chr2", "", 20000, 0.0)], seed=4321)
    chr1, chr2 = genome["chr1"], genome["chr2"]
    alt1, cig1, stop1 = _make_alt(chr1, 10000, [
        ("snp", 400, 0), ("del", 350, 3), ("ins", 500, 4),
        ("snp", 300, 0), ("del", 450, 2), ("ins", 600, 1),
        ("snp", 200, 0)], rng)
    alt2 = chr2[5000:6800]
    afa = tmp / "alt.fa"
    _write_fa(str(afa), [("alt1", alt1), ("alt2", alt2)])
    with open(str(afa) + ".remap", "w") as f:
        f.write(f">r1-chr1|{10000 + 1}|{stop1}\n")
        for i in range(0, len(cig1), 60):
            f.write(cig1[i:i + 60] + "\n")
        f.write(">r2-chr2|exact|0\n")
    builder.bwa_index(str(pfa))
    builder.bwa_index(str(afa))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = lambda s: "".join(comp[c] for c in reversed(s))
    f1, f2 = tmp / "r_1.fq", tmp / "r_2.fq"
    sources = [chr1, chr2, alt1, alt1, alt2]
    with open(f1, "w") as o1, open(f2, "w") as o2:
        for i in range(240):
            src = sources[i % len(sources)]
            isize = max(160, int(rng.gauss(260, 25)))
            pos = rng.randrange(0, len(src) - isize)
            frag = src[pos:pos + isize]
            r1, r2 = frag[:75], rc(frag[-75:])
            r1 = "".join(c if rng.random() > 0.01 else rng.choice("ACGT")
                         for c in r1)
            r2 = "".join(c if rng.random() > 0.01 else rng.choice("ACGT")
                         for c in r2)
            if rng.random() < 0.5:
                r1, r2 = r2, r1
            o1.write(f"@pr{i}/1\n{r1}\n+\n{'I' * 75}\n")
            o2.write(f"@pr{i}/2\n{r2}\n+\n{'I' * 75}\n")
    fqs = (str(f1), str(f2))
    sais = [tuple(_sai(fa, fq, GapOpt(), tmp / f"{tag}{e}.sai")
                  for e, fq in enumerate(fqs))
            for fa, tag in ((pfa, "p"), (afa, "a"))]
    return [str(pfa), str(afa)], sais, fqs


@pytest.mark.parametrize("route", ["native", "device_cpu", "pure_py"])
def test_sampe_multi_db_remap(remap_case, route, monkeypatch):
    """Two dbs: one walker per db, in DbSet's order, on the device route;
    ZR tags from the alternate reference's remap CIGARs."""
    prefixes, sais, fqs = remap_case
    if route == "pure_py":
        monkeypatch.setenv("IBWA_PURE_PY", "1")
    got, err = _run(t_sai2sam_pe, prefixes, sais, *fqs, TPeOpt(remapping=1),
                    device=CPU if route == "device_cpu" else None)
    want, _ = _run(j_sai2sam_pe, prefixes, sais, *fqs, JPeOpt(remapping=1))
    assert got == want
    assert _mapped(got) > 300 and "\tZR:Z:" in got
    if route == "device_cpu":
        assert _prefill_rows(err) > 0


# ---- colour space (tests/test_colorspace.py's fixture) -------------------

@pytest.fixture(scope="module")
def cs_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tcspace")
    fa = tmp / "g.fa"
    genome = make_genome(str(fa), [("csA", "x", 40000, 0.001),
                                   ("csB", "", 15000, 0.0)], seed=777)
    builder.bwa_index(str(fa), color=True)
    nt = {"A": 0, "C": 1, "G": 2, "T": 3}
    colors = lambda seq: [NST_COLOR_SPACE_TABLE[(1 << nt[a]) | (1 << nt[b])]
                          for a, b in zip(seq, seq[1:])]
    rng = random.Random(5)
    f1, f2 = tmp / "cs_1.fq", tmp / "cs_2.fq"
    with open(f1, "w") as o1, open(f2, "w") as o2:
        for i in range(160):
            src = genome["csA" if rng.random() < 0.7 else "csB"]
            isize = max(140, int(rng.gauss(220, 20)))
            pos = rng.randrange(1, len(src) - isize - 2)
            while "N" in src[pos - 1:pos + isize + 1]:
                pos = rng.randrange(1, len(src) - isize - 2)
            cols = colors(src[pos:pos + isize])
            c1, c2 = cols[:50], cols[-50:][::-1]
            mk = lambda cs: "".join(
                "ACGT"[c] if rng.random() > 0.015
                else rng.choice("ACGT") for c in cs)
            if rng.random() < 0.5:
                c1, c2 = c2, c1
            o1.write(f"@c{i}/1\n{mk(c1)}\n+\n{'I' * 50}\n")
            o2.write(f"@c{i}/2\n{mk(c2)}\n+\n{'I' * 50}\n")
    opt = GapOpt(mode=GapOpt().mode & ~BWA_MODE_COMPREAD)
    fqs = (str(f1), str(f2))
    sais = [_sai(fa, fq, opt, tmp / f"cs{e}.sai") for e, fq in enumerate(fqs)]
    return fa, sais, fqs


def test_colour_space_samse(cs_case):
    fa, sais, fqs = cs_case
    got, _ = _run(t_sai2sam_se, str(fa), sais[0], fqs[0])
    want, _ = _run(j_sai2sam_se, str(fa), sais[0], fqs[0])
    assert got == want and _mapped(got) > 80


def test_colour_space_sampe(cs_case):
    """Colour space keeps the Python route in both packages, whatever the
    device."""
    fa, sais, fqs = cs_case
    got, err = _run(t_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                    TPeOpt(remapping=1), device=CPU)
    want, _ = _run(j_sai2sam_pe, [str(fa)], [tuple(sais)], *fqs,
                   JPeOpt(remapping=1))
    assert got == want and _mapped(got) > 160
    assert "colour-space input" in err


# ---- the CLI -------------------------------------------------------------

def _cli(main, argv, out):
    with contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv + ["-f", str(out)])
    assert rc == 0
    return out.read_text()


def test_cli_samse_flags(se_case):
    tmp, fa, fq = se_case
    sai = _sai(fa, fq, GapOpt(), tmp / "default.sai")
    flags = ["-n", "10", "-r", "@RG\\tID:lane1\\tSM:s1"]
    args = flags + [str(fa), sai, str(fq)]
    got = _cli(tcli.main, ["samse", *args], tmp / "cli_t.sam")
    assert got == _cli(jcli.main, ["samse", *args], tmp / "cli_j.sam")
    assert got.startswith("@SQ") and "@RG\tID:lane1" in got


@pytest.mark.parametrize("engine", [["--engine", "native"],
                                    ["--engine", "torch", "--device", "cpu"]])
def test_cli_sampe_flags(pe_case, engine):
    """Every flag of the reference's sampe, through the port's CLI on both
    of its routes, against ibwa_tpu's CLI."""
    tmp, fa, fqs = pe_case
    sais = _pe_sais(tmp, fa, fqs, GapOpt(), "plain")
    flags = ["-a", "350", "-o", "90000", "-n", "8", "-N", "20", "-c", "2e-5",
             "-r", "@RG\\tID:lane2", "-A", "-R", "-P", "-t", "1"]
    args = [str(fa), *sais, *fqs]
    got = _cli(tcli.main, ["sampe", *flags, *engine, *args],
               tmp / "cli_t.sam")
    want = _cli(jcli.main, ["sampe", *flags, *args], tmp / "cli_j.sam")
    assert got == want and _mapped(got) > 400
    got_s = _cli(tcli.main, ["sampe", "-R", "-s", *engine, *args],
                 tmp / "cli_ts.sam")
    assert got_s == _cli(jcli.main, ["sampe", "-R", "-s", *args],
                         tmp / "cli_js.sam")


def test_cli_sampe_rejects_bad_arguments(capsys):
    assert tcli.main(["sampe", "a", "b", "c", "d"]) == 1
    with pytest.raises(SystemExit):
        tcli.main(["sampe", "--engine", "jax", "a", "b", "c", "d", "e"])
