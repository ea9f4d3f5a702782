"""The port's tools and index sub-commands against ibwa_tpu's, on the CPU.

Every command that the port's CLI took over from `ibwa_tpu`'s (the seven
index sub-commands over `index/builder.py`, `stdsw`, `qualfa2fq`,
`solid2fastq`, `prepare-remap`) is run by both packages on copies of the
same inputs: what each writes, to stdout and to files, must be byte-equal
(a gzip file's bytes after decompression: its header holds the time).
`check_command` runs both CLIs in subprocesses, the port's with `jax` and
`ibwa_tpu` blocked; the other tests call the two packages in this process,
over the tools' variants: stdsw local, global, -f, -r; solid2fastq paired
and single-end; prepare-remap on the six cases of test_prepare_remap.py.
There are no comparisons with the reference's perl scripts or binary:
neither is in the tree, and the port's target is ibwa_tpu's output.
"""

import gzip
import io
import os
import pathlib
import random
import shutil
import subprocess
import sys

import pytest

from ibwa_tpu import cli as jcli
from ibwa_tpu.index import builder as jbuilder
from ibwa_tpu.tools import convert as jconvert
from ibwa_tpu.tools import prepare_remap as jpr
from ibwa_tpu.tools import stdsw as jstdsw

from ibwa_tpu_torch import cli as tcli
from ibwa_tpu_torch.tools import convert as tconvert
from ibwa_tpu_torch.tools import prepare_remap as tpr
from ibwa_tpu_torch.tools import stdsw as tstdsw

import test_prepare_remap as remap_cases
from conftest import REPO, make_genome
from test_tools import _write_solid

TOOL_COMMANDS = ("fa2pac", "pac2bwt", "pac2bwtgen", "bwtupdate", "pac_rev",
                 "bwt2sa", "pac2cspac", "stdsw", "qualfa2fq", "solid2fastq",
                 "prepare-remap")
INDEX_COMMANDS = TOOL_COMMANDS[:7]

# each command: the input files it reads (copied from `tool_src`), its
# arguments
COMMAND_CASES = {
    "fa2pac": (["g.fa"], ["g.fa", "out"]),
    "pac2bwt": (["g.pac"], ["g.pac", "g.bwt"]),
    "pac2bwtgen": (["g.pac"], ["g.pac", "g.bwt"]),
    "bwtupdate": (["raw.bwt"], ["raw.bwt"]),
    "pac_rev": (["g.pac"], ["g.pac", "g.rpac"]),
    "bwt2sa": (["g.bwt"], ["bwt2sa_args"]),
    "pac2cspac": (["g.pac", "g.ann", "g.amb"], ["g", "cs"]),
    "stdsw": (["target.fa", "query.fa"], ["target.fa", "query.fa"]),
    "qualfa2fq": (["reads.fa", "reads.qual"], ["reads.fa", "reads.qual"]),
    "solid2fastq": (["inF3.csfasta", "inF3_QV.qual", "inR3.csfasta",
                     "inR3_QV.qual"], ["in", "out"]),
    "prepare-remap": (["tree"], ["tree", "out", "150", "--yes"]),
}


def _seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def write_stdsw_inputs(d: pathlib.Path, rng) -> None:
    """A 600-base target with a long header and six 150-base queries with
    substitutions, deletions and insertions (test_tools.py's recipe)."""
    base = _seq(rng, 600)
    with open(d / "target.fa", "w") as f:
        f.write(">target_sequence_with_a_long_name descr\n")
        for i in range(0, len(base), 60):
            f.write(base[i:i + 60] + "\n")
    with open(d / "query.fa", "w") as f:
        for i in range(6):
            pos = rng.randrange(0, 400)
            q = list(base[pos:pos + 150])
            for _ in range(rng.randrange(6)):
                j = rng.randrange(len(q))
                r = rng.random()
                if r < 0.6:
                    q[j] = rng.choice("ACGT")
                elif r < 0.8:
                    del q[j]
                else:
                    q.insert(j, rng.choice("ACGT"))
            if i == 5:   # one query of the other strand
                q = list(jstdsw.revseq("".join(q)))
            f.write(f">q{i}\n{''.join(q)}\n")


def write_qualfa_inputs(d: pathlib.Path, rng) -> None:
    with open(d / "reads.fa", "w") as ffa, open(d / "reads.qual", "w") as fq:
        for i in range(8):
            n = rng.randrange(30, 80)
            s = _seq(rng, n)
            qs = " ".join(str(rng.randrange(0, 45)) for _ in range(n))
            ffa.write(f">read{i} comment here\n")
            for j in range(0, n, 60):
                ffa.write(s[j:j + 60] + "\n")
            fq.write(f">read{i} comment here\n{qs}\n")


F3_IDS = [(1, 2, y) for y in (3, 5, 8, 11, 20)] + [(1, 3, 1)]
R3_IDS = [(1, 2, y) for y in (3, 8, 12, 20)] + [(1, 4, 7)]


@pytest.fixture(scope="module")
def tool_src(tmp_path_factory):
    """Every command's inputs in one directory: a 20 kbp genome with its
    .pac / .ann / .amb and its raw and updated .bwt (made by ibwa_tpu),
    stdsw's and qualfa2fq's FASTA files, a paired SOLiD run and a GRC
    release tree (test_prepare_remap.py's positive case)."""
    d = tmp_path_factory.mktemp("tools")
    make_genome(d / "g.fa", [("chrT", "tools", 14000, 0.001),
                             ("chrU", "", 6000, 0.0)], seed=20261020)
    jbuilder.fa2pac(str(d / "g.fa"), str(d / "g"))
    jbuilder.pac2bwt(str(d / "g.pac"), str(d / "raw.bwt"))
    shutil.copy(d / "raw.bwt", d / "g.bwt")
    jbuilder.bwtupdate(str(d / "g.bwt"))
    rng = random.Random(99)
    write_stdsw_inputs(d, rng)
    write_qualfa_inputs(d, rng)
    _write_solid(d, "in", "F3", F3_IDS, random.Random(5))
    _write_solid(d, "in", "R3", R3_IDS, random.Random(6))
    tree = d / "treecase"
    tree.mkdir()
    par = remap_cases._rand_seq(8000, 1)
    alt = par[5000:5500] + remap_cases._rand_seq(30, 2) + par[5500:5900]
    asn = remap_cases._ASN_TMPL.format(
        numseg=3, starts="0, 5000, 500, -1, 530, 5500",
        lens="500, 30, 400", strands="plus, plus, plus, plus, plus, plus")
    shutil.move(remap_cases._make_tree(tree, alt, par, asn,
                                       remap_cases._placement("+")),
                d / "tree")
    return d


def read_outputs(d: pathlib.Path) -> dict:
    """Every file under `d` by relative path, a .gz file decompressed."""
    out = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            out[str(p.relative_to(d))] = (gzip.decompress(data)
                                          if p.suffix == ".gz" else data)
    return out


_PORT_MAIN = (
    "import sys\n"
    "for m in ('jax', 'ibwa_tpu', 'bench'):\n"
    "    sys.modules[m] = None\n"
    "from ibwa_tpu_torch import cli\n"
    "rc = cli.main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules if sys.modules[m] is not None and "
    "m.split('.')[0] in ('jax', 'ibwa_tpu', 'bench')]\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n")


def run_cli(package: str, argv: list[str], cwd: pathlib.Path) -> bytes:
    """`python -m ibwa_tpu <argv>`, or the port's CLI with the JAX
    package blocked, in `cwd`; returns its stdout (it must exit 0)."""
    cmd = ([sys.executable, "-m", "ibwa_tpu"] if package == "ibwa_tpu"
           else [sys.executable, "-c", _PORT_MAIN])
    r = subprocess.run(cmd + argv, cwd=cwd, capture_output=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, (package, argv, r.stderr[-2000:])
    return r.stdout


def check_command(cmd: str, src: pathlib.Path, tmp: pathlib.Path) -> None:
    """`cmd` through both packages' CLIs on copies of the same inputs:
    stdout and every file in the directory afterwards byte-equal."""
    inputs, argv = COMMAND_CASES[cmd]
    if argv == ["bwt2sa_args"]:
        argv = ["g.bwt", "g.sa", "-i", "16"]
    results = []
    for package in ("ibwa_tpu", "ibwa_tpu_torch"):
        d = tmp / package
        d.mkdir()
        for name in inputs:
            if (src / name).is_dir():
                shutil.copytree(src / name, d / name)
            else:
                shutil.copy(src / name, d / name)
        stdout = run_cli(package, [cmd] + argv, d)
        results.append((stdout, read_outputs(d)))
    (jout, jfiles), (tout, tfiles) = results
    assert tout == jout
    assert list(tfiles) == list(jfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    # the command did something: stdout, a new file or a changed one
    assert jout or any(name not in inputs
                       or jfiles[name] != (src / name).read_bytes()
                       for name in jfiles)


@pytest.mark.parametrize("cmd", INDEX_COMMANDS)
def test_index_command_matches_ibwa_tpu(cmd, tool_src, tmp_path,
                                        monkeypatch):
    """The seven index sub-commands in this process, `cli.main` of each
    package in a directory of its own: the files byte-equal."""
    inputs, argv = COMMAND_CASES[cmd]
    if argv == ["bwt2sa_args"]:
        argv = ["g.bwt", "g.sa"]     # the default interval, 32
    files = []
    for cli in (jcli, tcli):
        d = tmp_path / cli.__name__
        d.mkdir()
        for name in inputs:
            shutil.copy(tool_src / name, d / name)
        monkeypatch.chdir(d)
        assert cli.main([cmd] + argv) == 0
        files.append(read_outputs(d))
    assert files[1] == files[0]
    assert len(files[0]) > len(inputs) or cmd == "bwtupdate"
    if cmd == "bwtupdate":
        assert files[0]["raw.bwt"] != (tool_src / "raw.bwt").read_bytes()


@pytest.mark.parametrize("variant", ["local", "global", "fwd", "rev"])
def test_stdsw_matches_ibwa_tpu(variant, tool_src):
    """stdsw's alignment text: local (default), global (-g), forward
    strand only (-f), reverse only (-r), with a score threshold."""
    kw = {"local": {}, "global": {"is_global": True},
          "fwd": {"strand": 1, "thres": 20},
          "rev": {"strand": 2, "thres": 20}}[variant]
    outs = []
    for mod in (jstdsw, tstdsw):
        buf = io.StringIO()
        mod.stdsw(str(tool_src / "target.fa"), str(tool_src / "query.fa"),
                  out=buf, **kw)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    # alignments were printed: the reverse query's on -r, the others' on -f
    assert outs[0].count(">target") >= {"local": 6, "global": 6, "fwd": 5,
                                        "rev": 1}[variant]


def test_qualfa2fq_matches_ibwa_tpu(tool_src):
    outs = []
    for mod in (jconvert, tconvert):
        buf = io.StringIO()
        mod.qualfa2fq(str(tool_src / "reads.fa"), str(tool_src / "reads.qual"),
                      out=buf)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert outs[0].count("\n+") == 8


@pytest.mark.parametrize("paired", [True, False])
def test_solid2fastq_matches_ibwa_tpu(paired, tmp_path, monkeypatch):
    """Paired (sorted merge, the read1 / read2 swap, singles) and
    single-end SOLiD input: the gzipped FASTQ byte-equal decompressed."""
    files = []
    for mod in (jconvert, tconvert):
        d = tmp_path / mod.__name__
        d.mkdir()
        _write_solid(d, "in", "F3", F3_IDS, random.Random(5))
        if paired:
            _write_solid(d, "in", "R3", R3_IDS, random.Random(6))
        monkeypatch.chdir(d)
        mod.solid2fastq("in", "out")
        files.append(read_outputs(d))
    assert files[1] == files[0]
    made = {n for n in files[0] if n.startswith("out.")}
    assert made == ({"out.single.fastq.gz", "out.read1.fastq.gz",
                     "out.read2.fastq.gz"} if paired
                    else {"out.single.fastq.gz"})


def _tree(case: str, tmp: pathlib.Path) -> tuple[str, int]:
    """The GRC release tree of one of test_prepare_remap.py's cases and
    its flank."""
    rc = remap_cases
    if case == "positive":
        par = rc._rand_seq(8000, 1)
        alt = par[5000:5500] + rc._rand_seq(30, 2) + par[5500:5900]
        asn = rc._ASN_TMPL.format(
            numseg=3, starts="0, 5000, 500, -1, 530, 5500",
            lens="500, 30, 400",
            strands="plus, plus, plus, plus, plus, plus")
        return rc._make_tree(tmp, alt, par, asn, rc._placement("+")), 150
    if case == "negative":
        par = rc._rand_seq(8000, 3)
        forward = par[5000:5500] + rc._rand_seq(30, 4) + par[5500:5900]
        asn = rc._ASN_TMPL.format(
            numseg=3, starts="430, 5000, 400, -1, 0, 5500",
            lens="500, 30, 400",
            strands="minus, plus, minus, plus, minus, plus")
        return rc._make_tree(tmp, jpr.rev_complement(forward), par, asn,
                             rc._placement("-")), 150
    if case == "all_n":
        par = rc._rand_seq(9000, 5)
        alt = par[5000:5500] + "N" * 100 + par[5700:6100]
        asn = rc._ASN_TMPL.format(
            numseg=4, starts="0, 5000, 500, -1, -1, 5500, 600, 5700",
            lens="500, 100, 200, 400",
            strands="plus, plus, plus, plus, plus, plus, plus, plus")
        return rc._make_tree(tmp, alt, par, asn, rc._placement("+")), 50
    par = rc._rand_seq(1200, 6)
    asn = rc._ASN_TMPL.format(numseg=1, starts="0, 40", lens="900",
                              strands="plus, plus")
    return rc._make_tree(tmp, par[40:940], par, asn, "\t".join([
        "ALT_REF_LOCI_1", "GRCh37", "HSCHR1_1", "GL000001.1", "CHR", "1",
        "CM000663.1", "REGION1", "+", "1", "900", "41", "940", "0",
        "0"])), 150


ASN_DISC = """Seq-align ::= {
  type disc,
  segs disc {
    { type partial, dim 2,
      segs denseg { dim 2, numseg 1, ids { gi 1, gi 2 },
                    starts { 0, 100 }, lens { 50 },
                    strands { plus, plus } } },
    { type partial, dim 2,
      segs denseg { dim 2, numseg 1, ids { gi 1, gi 2 },
                    starts { 60, 160 }, lens { 40 },
                    strands { plus, plus } } }
  }
}"""


@pytest.mark.parametrize("case", ["positive", "negative", "all_n", "flank",
                                  "asn_disc", "bad_tree"])
def test_prepare_remap_matches_ibwa_tpu(case, tmp_path):
    """The six cases of test_prepare_remap.py through both packages: the
    .remap and flanked .fa files byte-equal; the ASN.1 parser's segments
    equal; a bad tree refused with the same message."""
    if case == "asn_disc":
        segs = [mod.get_seg_list(mod.parse_asn(ASN_DISC))
                for mod in (jpr, tpr)]
        assert segs[1] == segs[0] and len(segs[0]) == 2
        return
    if case == "bad_tree":
        os.makedirs(tmp_path / "src" / "GRCh37")
        msgs = []
        for mod in (jpr, tpr):
            with pytest.raises(ValueError, match="9 ALT_REF_LOCI") as e:
                mod.prepare(str(tmp_path / "src"),
                            str(tmp_path / f"out_{mod.__name__}"),
                            lite=os.devnull)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
        return
    src, flank = _tree(case, tmp_path)
    files = []
    for mod in (jpr, tpr):
        dest = tmp_path / f"out_{mod.__name__}"
        mod.prepare(src, str(dest), flank=flank)
        files.append(read_outputs(dest))
    assert files[1] == files[0]
    assert "GRCh37_ALT_REF_LOCI_1.remap" in files[0]
