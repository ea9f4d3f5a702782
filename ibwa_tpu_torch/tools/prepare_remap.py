"""Generate iBWA ``.remap`` + flanked FASTA inputs from GRC assembly releases.

Equivalent of the reference's ``parse/prepare-grch37.pl`` (1284-line Perl,
Bio::DB::Fasta + Parse::RecDescent): walk a GRCh37 release tree
(``GRCh37/``, ``GRCh37.p1/`` ... with ``ALT_REF_LOCI_N`` / ``PATCHES`` /
``Primary_Assembly`` subtrees), parse each alt-scaffold↔chromosome NCBI
text-ASN.1 Seq-align, and emit per-assembly ``<name>.fa`` (alt sequence
with primary-reference flanks spliced on) plus ``<name>.remap`` (two-line
records: ``>seqid_count-chrom|parent_start|parent_stop`` then a CIGAR with
the flanks folded into the first/last M op) — the exact format consumed by
``sam/remap.py`` and the reference's bwaremap.cpp.

Behavioral contract points (reference ``prepare-grch37.pl``):
 - release walk / dir-shape checks: lines 158-225 (9 ALT_REF_LOCI dirs,
   Primary_Assembly symlink chasing, PATCHES only on .pN releases)
 - chr2acc / alt_scaffold_placement.txt parsing: lines 227-256, 469-508
 - FASTA seqid forms: ``gi|N|gb|ACC|`` for scaffolds (lines 393-414), bare
   ``\\S+`` for the lite reference (lines 120-140)
 - text-ASN.1 Seq-align grammar (denseg + disc): lines 1014-1153
 - seg → M/D/I op classification, all-N insertion split: lines 611-780
 - flank clamping, CIGAR folding, negative-orientation handling,
   remap/fasta emission: lines 875-995

Deviation (documented): the Perl consults a magic ``/tmp/GRCh37-lite.fa``
cache and prompts interactively; here the lite reference may be overridden
with ``--lite`` and the prompt suppressed with ``--yes``.

Copy of `ibwa_tpu/tools/prepare_remap.py`: the port keeps its own host
code and imports nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import gzip
import os
import re
import sys
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# random-access FASTA (stands in for Bio::DB::Fasta)

class FastaFile:
    """Random-access 1-based inclusive substring queries over a FASTA file."""

    def __init__(self, path: str):
        self.path = path
        self.seqs: dict[str, str] = {}
        self.order: list[str] = []
        opener = gzip.open if path.endswith(".gz") else open
        name = None
        parts: list[str] = []
        with opener(path, "rt") as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        self.seqs[name] = "".join(parts)
                    name = line[1:].split()[0] if line[1:].split() else ""
                    self.order.append(name)
                    parts = []
                else:
                    parts.append(line.strip())
        if name is not None:
            self.seqs[name] = "".join(parts)

    def ids(self) -> list[str]:
        return list(self.order)

    def length(self, seqid: str) -> int:
        return len(self.seqs[seqid])

    def seq(self, seqid: str, start: int, stop: int) -> str:
        """1-based inclusive slice (Bio::DB::Fasta convention)."""
        return self.seqs[seqid][start - 1:stop]


_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def rev_complement(seq: str) -> str:
    """prepare-grch37.pl:1000-1011 (non-ACGT bases pass through)."""
    return seq.translate(_COMP)[::-1]


# ---------------------------------------------------------------------------
# text-ASN.1 Seq-align parser (subset grammar, prepare-grch37.pl:1014-1153)

class AsnError(ValueError):
    pass


class _Tok:
    def __init__(self, text: str):
        self.toks = re.findall(r"::=|[{},]|\"[^\"]*\"|[A-Za-z0-9_.\-]+", text)
        self.pos = 0

    def peek(self) -> str | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        if self.pos >= len(self.toks):
            raise AsnError("unexpected end of ASN input")
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, want: str) -> str:
        t = self.next()
        if t != want:
            raise AsnError(f"expected {want!r}, got {t!r}")
        return t


def _parse_int_list(tk: _Tok) -> list[int]:
    tk.expect("{")
    out = [int(tk.next())]
    while tk.peek() == ",":
        tk.next()
        out.append(int(tk.next()))
    tk.expect("}")
    return out


def _parse_body(tk: _Tok) -> dict:
    """One ``{ type ..., dim ..., score {...}, segs ... }`` body."""
    body: dict = {}
    tk.expect("{")
    while True:
        key = tk.next()
        if key == "type":
            body["type"] = tk.next()
        elif key == "dim":
            body["dim"] = int(tk.next())
        elif key == "score":
            body["score"] = _parse_scores(tk)
        elif key == "segs":
            body["segs"] = _parse_segs(tk)
        else:
            raise AsnError(f"unrecognized Seq-align item {key!r}")
        nxt = tk.next()
        if nxt == "}":
            return body
        if nxt != ",":
            raise AsnError(f"expected ',' or '}}', got {nxt!r}")


def _parse_scores(tk: _Tok) -> dict:
    tk.expect("{")
    scores: dict = {}
    while True:
        tk.expect("{")
        tk.expect("id")
        tk.expect("str")
        name = tk.next().strip('"')
        tk.expect(",")
        tk.expect("value")
        kind = tk.next()
        if kind == "int":
            scores[name] = int(tk.next())
        elif kind == "real":
            tk.expect("{")
            m = int(tk.next()); tk.expect(","); b = int(tk.next())
            tk.expect(","); e = int(tk.next()); tk.expect("}")
            scores[name] = m * (b ** e)
        else:
            raise AsnError(f"unrecognized score value kind {kind!r}")
        tk.expect("}")
        nxt = tk.next()
        if nxt == "}":
            return scores
        if nxt != ",":
            raise AsnError(f"bad score separator {nxt!r}")


def _parse_segs(tk: _Tok):
    kind = tk.next()
    if kind == "disc":
        tk.expect("{")
        bodies = [_parse_body(tk)]
        while tk.peek() == ",":
            tk.next()
            bodies.append(_parse_body(tk))
        tk.expect("}")
        return bodies
    # denseg-style: { dim N, numseg N, ids {...}, starts {...}, lens {...}
    #                 [, strands {...}] }
    segs: dict = {"type": kind}
    tk.expect("{")
    while True:
        key = tk.next()
        if key == "dim":
            segs["dim"] = int(tk.next())
        elif key == "numseg":
            segs["numseg"] = int(tk.next())
        elif key == "ids":
            tk.expect("{")
            ids = []
            while True:
                tk.expect("gi")
                ids.append(int(tk.next()))
                if tk.next() == "}":
                    break
            segs["ids"] = ids
        elif key == "starts":
            segs["starts"] = _parse_int_list(tk)
        elif key == "lens":
            segs["lens"] = _parse_int_list(tk)
        elif key == "strands":
            tk.expect("{")
            strands = [tk.next()]
            while tk.peek() == ",":
                tk.next()
                strands.append(tk.next())
            tk.expect("}")
            segs["strands"] = strands
        else:
            raise AsnError(f"unrecognized seg item {key!r}")
        nxt = tk.next()
        if nxt == "}":
            return segs
        if nxt != ",":
            raise AsnError(f"bad seg separator {nxt!r}")


def parse_asn(text: str) -> dict:
    tk = _Tok(text)
    tk.expect("Seq-align")
    tk.expect("::=")
    body = _parse_body(tk)
    return verify_and_transform(body)


def verify_and_transform(seqalign: dict) -> dict:
    """Shape checks + starts/strands → per-seg pairs (pl:1156-1240)."""
    if seqalign.get("type") == "not-set":
        print("Warning, Seq-align type marked as not-set, assuming "
              "'partial'.", file=sys.stderr)
        seqalign["type"] = "partial"
    if seqalign["type"] not in ("partial", "disc"):
        raise AsnError(f"Unrecognized type '{seqalign['type']}'")

    if seqalign["type"] == "disc":
        if not isinstance(seqalign["segs"], list):
            raise AsnError("Expected multiple discontinuous segs")
        seqalign["segs"] = [verify_and_transform(s)
                            for s in seqalign["segs"]]
        return seqalign

    segs = seqalign["segs"]
    if not isinstance(segs, dict):
        raise AsnError("Expected partial segs to point to a denseg")
    if seqalign.get("dim") and seqalign["dim"] != segs["dim"]:
        raise AsnError("Mismatched dims found")

    dim, numseg = segs["dim"], segs["numseg"]
    if "strands" not in segs:
        print("Warning, no strands parsed. Assuming all strands are "
              "positive.", file=sys.stderr)
        segs["strands"] = ["plus"] * (dim * numseg)
    if segs["type"] != "denseg":
        raise AsnError(f"Unrecognized segtype '{segs['type']}'")
    if (len(segs["ids"]) != dim or len(segs["lens"]) != numseg
            or len(segs["starts"]) != dim * numseg
            or len(segs["strands"]) != dim * numseg):
        raise AsnError("Counts don't match")
    segs["starts"] = [segs["starts"][i * dim:(i + 1) * dim]
                      for i in range(numseg)]
    segs["strands"] = [segs["strands"][i * dim:(i + 1) * dim]
                       for i in range(numseg)]
    return seqalign


def get_seg_list(seqalign: dict) -> list[dict]:
    """Flatten partial/disc Seq-aligns to a list of densegs (pl:846-873)."""
    if seqalign["type"] == "disc":
        segs = [s["segs"] for s in seqalign["segs"]]
    else:
        segs = [seqalign["segs"]]
    ids = segs[0]["ids"]
    for s in segs:
        if len(s["ids"]) != len(ids):
            raise AsnError("Not all disc segs had the same ids")
        if s["dim"] != 2:
            raise AsnError("Only 2 seqs are currently supported")
    return segs


# ---------------------------------------------------------------------------
# orientation / chromosome resolution

def parse_orientation(strands: list[list[str]],
                      placement: dict | None) -> str:
    """pl:805-844 — strand-pair + placement ``ori`` → positive/negative."""
    one, two = strands[0]
    for s in strands:
        if s[0] != one and s[1] != two:
            raise AsnError("Strands changed direction among same sequence")
    if placement is not None:
        table = {
            ("plus", "plus"): {"+": "positive", "-": "invalid",
                               "b": "positive"},
            ("plus", "minus"): {"+": "invalid", "-": "unsupported",
                                "b": "unsupported"},
            ("minus", "plus"): {"+": "invalid", "-": "negative",
                                "b": "negative"},
            ("minus", "minus"): {"+": "unsupported", "-": "invalid",
                                 "b": "unsupported"},
        }
        ori = table.get((one, two), {}).get(placement["ori"])
        if ori is None:
            raise AsnError(
                f"Orientation {one} - {two}: {placement['ori']} is not "
                "recognized")
    else:
        table = {("plus", "plus"): "positive",
                 ("minus", "plus"): "negative"}
        ori = table.get((one, two), "unsupported")
    if ori not in ("positive", "negative"):
        raise AsnError(f"Orientation {one} - {two} is {ori}")
    return ori


# ---------------------------------------------------------------------------
# release-tree walking

@dataclass
class Store:
    flank: int
    destdir: str
    reference: dict = field(default_factory=dict)   # {fasta: [seq dicts]}
    primary: dict = field(default_factory=dict)     # rel -> {acc2chr}
    alt_loci: dict = field(default_factory=dict)    # rel -> loci -> scaffolds
    patches: dict = field(default_factory=dict)     # rel -> scaffolds


_LITE_ID = re.compile(r"^>(\S+)(\s.+)?$")
_GI_ID = re.compile(r"^>gi\|(\d+)\|gb\|([a-zA-Z0-9]+(?:\.\d+)?)\|(\s.+)?$")


def scan_fasta_ids(path: str, gi_form: bool) -> list[dict]:
    """Pull seqids from FASTA headers (pl:120-152 lite, 393-414 gi-form)."""
    seqs = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            if not line.startswith(">"):
                continue
            line = line.rstrip("\n")
            if gi_form:
                m = _GI_ID.match(line)
                if not m:
                    raise ValueError(f"Can't parse seqid '{line}' in fasta")
                seqs.append({"gi": m.group(1), "acc": m.group(2),
                             "seqid": f"gi|{m.group(1)}|gb|{m.group(2)}|",
                             "desc": m.group(3) or "", "fasta": path})
            else:
                m = _LITE_ID.match(line)
                if not m:
                    raise ValueError(f"Can't parse seqid '{line}' in fasta")
                seqs.append({"acc": m.group(1), "seqid": m.group(1),
                             "desc": m.group(2) or "", "fasta": path})
    return seqs


def parse_chr2acc(path: str) -> dict[str, str]:
    """Primary_Assembly/assembled_chromosomes/chr2acc (pl:227-256)."""
    acc2chr: dict[str, str] = {}
    pat = re.compile(r"^(\d{1,2}|X|Y)\t([a-zA-Z0-9]+(?:\.\d+))$")
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                continue
            m = pat.match(line)
            if not m:
                raise ValueError(f"Can't parse '{line}' from {path}")
            chrom, acc = m.group(1), m.group(2)
            if acc in acc2chr:
                raise ValueError(f"Duplicate acc '{acc}' found in {path}")
            acc2chr[acc] = chrom
    return acc2chr


_PLACEMENT_HEADER = ("#alt_asm_name\tprim_asm_name\talt_scaf_name\t"
                     "alt_scaf_acc\tparent_type\tparent_name\tparent_acc\t"
                     "region_name\tori\talt_scaf_start\talt_scaf_stop\t"
                     "parent_start\tparent_stop\talt_start_tail\t"
                     "alt_stop_tail")
_PLACEMENT_FIELDS = [f.lstrip("#") for f in _PLACEMENT_HEADER.split("\t")]


def parse_placements(path: str) -> dict[str, dict]:
    """alt_scaffold_placement.txt (pl:469-508)."""
    placements: dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                if line != _PLACEMENT_HEADER:
                    raise ValueError(
                        "Unrecognized header in alt_scaffold_placement.txt")
                continue
            fields = line.split("\t")
            rec = dict(zip(_PLACEMENT_FIELDS, fields))
            key = f"{rec['alt_scaf_acc']}-{rec['parent_acc']}"
            if key in placements:
                raise ValueError(f"Duplicate accession '{key}' in {path}")
            placements[key] = rec
    return placements


_ASN_NAME = re.compile(
    r"^([a-zA-Z0-9]+(?:\.\d+)?)_([a-zA-Z0-9]+(?:\.\d+)?)\.asn$")


def process_scaffolds(store: Store, root: str) -> dict:
    """One (alt|placed)_scaffolds dir: FASTA + alignments + placements
    (pl:291-337 + 419-466)."""
    fa_dir, aln_dir = f"{root}/FASTA", f"{root}/alignments"
    if not os.path.isdir(fa_dir):
        raise FileNotFoundError(f"Can't find FASTA directory in {root}")
    if not os.path.isdir(aln_dir):
        raise FileNotFoundError(f"Can't find alignments directory in {root}")

    gzfastas = sorted(f for f in os.listdir(fa_dir) if f.endswith(".fa.gz"))
    if len(gzfastas) != 1:
        raise ValueError(f"Expected exactly one FASTA file in {fa_dir}")
    fa_path = f"{fa_dir}/{gzfastas[0]}"
    fastas = {fa_path: scan_fasta_ids(fa_path, gi_form=True)}

    alignments: dict[str, dict] = {}
    for asn in sorted(f for f in os.listdir(aln_dir) if f.endswith(".asn")):
        m = _ASN_NAME.match(asn)
        if not m:
            raise ValueError(f"Can't parse asn file name '{asn}'")
        src_acc, dst_acc = m.group(1), m.group(2)
        gff = f"{aln_dir}/{src_acc}_{dst_acc}.gff"
        if not os.path.getsize(f"{aln_dir}/{asn}"):
            raise ValueError(f"ASN '{aln_dir}/{asn}' is empty")
        if not (os.path.exists(gff) and os.path.getsize(gff)):
            raise ValueError(f"GFF '{gff}' did not exist alongside asn")
        key = f"{src_acc}-{dst_acc}"
        if key in alignments:
            raise ValueError(f"Duplicate accession '{key}' in asn/gff dir")
        alignments[key] = {"src": src_acc, "dst": dst_acc,
                           "asn": f"{aln_dir}/{asn}", "gff": gff}

    placements = parse_placements(f"{root}/alt_scaffold_placement.txt")
    # join placements onto alignments, retrying with version-trimmed accs
    trimmed = {}
    for key in placements:
        m = re.match(r"(.+)\.\d+-(.+)\.\d+$", key)
        if m:
            short = f"{m.group(1)}-{m.group(2)}"
            if short in trimmed:
                raise ValueError(
                    f"There are multiple versions of acc '{short}'")
            trimmed[short] = key
    unclaimed = set(placements)
    for key, aln in alignments.items():
        full = key if key in placements else trimmed.get(key)
        if full is not None and full in unclaimed:
            aln["placement"] = placements[full]
            unclaimed.discard(full)
        else:
            print(f"Could not find placement for patch '{key}'",
                  file=sys.stderr)
    if unclaimed:
        raise ValueError("Did not find patch for all placements")
    return {"fastas": fastas, "alignments": alignments}


def _single_subdir(root: str, pattern: str) -> str:
    dirs = sorted(d for d in os.listdir(root)
                  if os.path.isdir(f"{root}/{d}") and re.search(pattern, d))
    if len(dirs) != 1:
        raise ValueError(f"Did not find expected directory in {root}")
    return f"{root}/{dirs[0]}"


def process_release(store: Store, root: str, major: str,
                    minor: str) -> None:
    """One GRCh37[.pN] release dir (pl:158-225)."""
    ispatch = bool(re.match(rf"^{re.escape(major)}\.p(\d+)$", minor))
    dirs = [d for d in os.listdir(root) if os.path.isdir(f"{root}/{d}")]
    locis = sorted(d for d in dirs if re.match(r"^ALT_REF_LOCI_\d+$", d))
    if len(locis) != 9:
        raise ValueError("Did not find 9 ALT_REF_LOCI dirs")
    if "Primary_Assembly" not in dirs:
        raise ValueError("Did not find Primary_Assembly dir")
    if ispatch and "PATCHES" not in dirs:
        raise ValueError("Did not find PATCHES dir")

    prim = f"{root}/Primary_Assembly"
    if os.path.islink(prim):
        link = os.readlink(prim)
        m = re.search(
            rf"\.\./({re.escape(major)}(?:\.p\d+)?)/Primary_Assembly", link)
        if not m or m.group(1) not in store.primary:
            raise ValueError(
                f"Can't understand link Primary_Assembly -> {link}")
        store.primary[minor] = store.primary[m.group(1)]
    else:
        store.primary[minor] = {"acc2chr": parse_chr2acc(
            f"{prim}/assembled_chromosomes/chr2acc")}

    for loci in locis:
        path = f"{root}/{loci}"
        if os.path.islink(path):
            link = os.readlink(path)
            m = re.search(
                rf"\.\./({re.escape(major)}(?:\.p\d+)?)/(ALT_REF_LOCI_\d+)",
                link)
            if not m or m.group(2) != loci:
                raise ValueError(f"Can't understand link {loci} -> {link}")
            store.alt_loci.setdefault(minor, {})[loci] = \
                store.alt_loci[m.group(1)][loci]
        else:
            store.alt_loci.setdefault(minor, {})[loci] = process_scaffolds(
                store, _single_subdir(path, r"(?:alt|placed)_scaffolds"))

    if "PATCHES" in dirs:
        store.patches[minor] = process_scaffolds(
            store,
            _single_subdir(f"{root}/PATCHES",
                           r"(?:alt|placed)_scaffolds"))


# ---------------------------------------------------------------------------
# remap emission

def parse_chromosome(store: Store, alignment: dict, major: str) -> str:
    """pl:783-802 — resolve the primary chromosome name."""
    acc2chr = store.primary[major]["acc2chr"]
    placement = alignment.get("placement")
    if placement is not None:
        chrom = placement["parent_name"]
        if acc2chr.get(placement["parent_acc"]) != chrom:
            raise ValueError(
                "Chromosome name specified by placements does not match "
                "acc2chr in primary assembly.")
        return chrom
    chrom = acc2chr.get(alignment["dst"])
    if chrom is None:
        raise ValueError(
            f"Couldn't find chromosome name {alignment['dst']}")
    return chrom


def find_fasta_from_acc(fastas: dict, acc: str) -> dict:
    """pl:585-609 — unique accession lookup across scanned FASTAs."""
    found = []
    for fa, seqs in fastas.items():
        matches = [s for s in seqs if s["acc"] == acc]
        if len(matches) == 1:
            found.append(matches[0])
        elif len(matches) > 1:
            raise ValueError(
                f"Found accession '{acc}' multiple times in '{fa}'")
    if len(found) != 1:
        raise ValueError(
            f"Did not find accession '{acc}' in exactly one fasta "
            f"(found {len(found)})")
    return found[0]


def process_remap_chunk(store: Store, ori: str, alt: list, par: list,
                        lens: list, ops: list, par_seq: dict, alt_seq: dict,
                        par_fa: FastaFile, alt_fa: FastaFile, count: int,
                        chromosome: str, remap_fh, fasta_fh) -> None:
    """Emit one remap record + flanked FASTA entry (pl:875-995)."""
    flank = store.flank
    if ops[0] != "M" and count == 0:
        raise ValueError("First cigar op of first chunk is not a match")
    if ops[0] == "D" and count != 0:
        raise ValueError("Chunk after a split did not skip the deletion")
    if ops[-1] != "M":
        raise ValueError("Last cigar op was not a match")

    parent_len = par_fa.length(par_seq["seqid"])
    parent_start = par[0]["start"] + 1 - flank
    preflank_len = flank
    if parent_start < 1:
        preflank_len -= 1 - parent_start
        parent_start = 1
    parent_stop = par[-1]["stop"] + flank
    postflank_len = flank
    if parent_stop > parent_len:
        postflank_len -= parent_stop - parent_len
        parent_stop = parent_len

    full_seqid = "_".join(p for p in alt_seq["seqid"].split("|") if p)
    seq_line = f">{full_seqid}_{count}"
    remap_fh.write(
        f"{seq_line}-{chromosome}|{parent_start}|{parent_stop}\n")

    cigar = ""
    for i, op in enumerate(ops):
        curlen = lens[i]
        if i == 0 and op == "M":
            curlen += preflank_len
        if i == len(ops) - 1 and op == "M":
            curlen += postflank_len
        cigar += f"{curlen}{op}"
    remap_fh.write(cigar + "\n")

    if ori == "positive":
        for i in range(len(alt) - 1):
            if alt[i]["stop"] != alt[i + 1]["start"]:
                raise ValueError(f"Noncontiguous sequence at alt index {i}")
        alt_start, alt_stop = alt[0]["start"] + 1, alt[-1]["stop"]
    else:
        for i in range(len(alt) - 2, -1, -1):
            if alt[i]["start"] != alt[i + 1]["stop"]:
                raise ValueError(f"Noncontiguous sequence at alt index {i}")
        alt_start, alt_stop = alt[-1]["start"] + 1, alt[0]["stop"]

    seq = alt_fa.seq(alt_seq["seqid"], alt_start, alt_stop)
    if len(seq) != alt_stop - alt_start + 1:
        raise ValueError("Alt slice length mismatch")
    if ori == "negative":
        seq = rev_complement(seq)

    pre = (par_fa.seq(par_seq["seqid"], parent_start,
                      parent_start - 1 + preflank_len)
           if preflank_len > 0 else "")
    post = (par_fa.seq(par_seq["seqid"], parent_stop - postflank_len + 1,
                       parent_stop)
            if postflank_len > 0 else "")
    flanked = pre + seq + post

    fasta_fh.write(seq_line + alt_seq["desc"] + "\n")
    for pos in range(0, len(flanked), 70):
        fasta_fh.write(flanked[pos:pos + 70] + "\n")


def process_segs(store: Store, alignment: dict, par_seq: dict,
                 alt_seq: dict, seqalign: dict, outputname: str,
                 major: str) -> None:
    """Seg classification + all-N-insertion splitting (pl:611-780)."""
    chromosome = parse_chromosome(store, alignment, major)
    par_fa = FastaFile(par_seq["fasta"])
    alt_fa = FastaFile(alt_seq["fasta"])
    if par_seq["seqid"] not in par_fa.seqs:
        raise ValueError(f"seqid '{par_seq['seqid']}' not in ref fasta")
    if alt_seq["seqid"] not in alt_fa.seqs:
        raise ValueError(f"seqid '{alt_seq['seqid']}' not in alt fasta")

    out_fa = f"{store.destdir}/{outputname}.fa"
    out_remap = f"{store.destdir}/{outputname}.remap"
    with open(out_fa, "a") as fasta_fh, open(out_remap, "a") as remap_fh:
        count = 0
        for subsegs in get_seg_list(seqalign):
            ori = parse_orientation(subsegs["strands"],
                                    alignment.get("placement"))
            alt: list = []
            par: list = []
            lens: list = []
            ops: list = []
            aa, pp = 0, 1   # alt first in each pair, parent second
            i = 0
            while i < subsegs["numseg"]:
                spos = subsegs["starts"][i]
                seglen = subsegs["lens"][i]
                if spos[aa] != -1 and spos[pp] != -1:
                    op = "M"
                    alt.append({"start": spos[aa],
                                "stop": spos[aa] + seglen})
                    par.append({"start": spos[pp],
                                "stop": spos[pp] + seglen})
                elif spos[aa] == -1:
                    op = "D"
                    par.append({"start": spos[pp],
                                "stop": spos[pp] + seglen})
                elif spos[pp] == -1:
                    op = "I"
                    alt.append({"start": spos[aa],
                                "stop": spos[aa] + seglen})
                else:
                    raise ValueError(
                        f"Nonsense starting positions at index {i}")
                lens.append(seglen)
                ops.append(op)

                if op != "D":
                    segseq = alt_fa.seq(alt_seq["seqid"],
                                        alt[-1]["start"] + 1,
                                        alt[-1]["stop"])
                    if segseq and set(segseq) == {"N"}:
                        if op != "I":
                            raise ValueError(
                                "Expected an insertion during a split")
                        if ops[-2] != "M":
                            raise ValueError(
                                "Previous cigar op was not a match during "
                                "a split")
                        alt.pop(); lens.pop(); ops.pop()
                        process_remap_chunk(
                            store, ori, alt, par, lens, ops, par_seq,
                            alt_seq, par_fa, alt_fa, count, chromosome,
                            remap_fh, fasta_fh)
                        alt, par, lens, ops = [], [], [], []
                        count += 1
                        i += 1      # next seg must be the paired deletion
                        spos = subsegs["starts"][i]
                        if spos[0] != -1:
                            raise ValueError(
                                "Excised an N insertion not followed by "
                                "a D")
                        i += 1
                        continue
                i += 1
            process_remap_chunk(
                store, ori, alt, par, lens, ops, par_seq, alt_seq,
                par_fa, alt_fa, count, chromosome, remap_fh, fasta_fh)
            count += 1


def create_remap(store: Store, scaffolds: dict, outputname: str,
                 major: str) -> None:
    """pl:527-583 — per-alignment remap creation with error isolation."""
    for key in sorted(scaffolds["alignments"]):
        alignment = scaffolds["alignments"][key]
        if "remap" in alignment:
            continue
        placement = alignment.get("placement")
        srcacc = placement["alt_scaf_acc"] if placement else alignment["src"]
        dstacc = placement["parent_acc"] if placement else alignment["dst"]
        try:
            par_seq = find_fasta_from_acc(store.reference, dstacc)
            alt_seq = find_fasta_from_acc(scaffolds["fastas"], srcacc)
            with open(alignment["asn"]) as f:
                seqalign = parse_asn(f.read())
            process_segs(store, alignment, par_seq, alt_seq, seqalign,
                         outputname, major)
            alignment["remap"] = {"status": "success", "name": outputname}
            print(f"Processed {alignment['asn']}", file=sys.stderr)
        except (ValueError, AsnError, KeyError, OSError) as e:
            print(f"Parse error: {e}\n        asn: {alignment['asn']}",
                  file=sys.stderr)
            alignment["remap"] = {"status": "failure", "error": str(e)}


def prepare(source: str, destination: str, flank: int = 150,
            major: str = "GRCh37", lite: str | None = None) -> Store:
    """Walk a GRC release tree and emit .fa/.remap pairs (pl:21-87)."""
    if os.path.exists(destination):
        raise FileExistsError("Destination directory exists")
    os.makedirs(destination)
    store = Store(flank=flank, destdir=destination)

    if lite is None:
        gz = f"{source}/{major}/special_requests/{major}-lite.fa.gz"
        if not os.path.exists(gz):
            raise FileNotFoundError(
                f"{major} lite not in expected place '{gz}'")
        lite = gz
    store.reference = {lite: scan_fasta_ids(lite, gi_form=False)}

    minors = sorted(
        d for d in os.listdir(source)
        if re.match(rf"^{re.escape(major)}(?:\.p\d+)?$", d)
        and os.path.isdir(f"{source}/{d}"))
    for minor in minors:
        process_release(store, f"{source}/{minor}", major, minor)

    for rel in sorted(store.alt_loci):
        for assembly in sorted(store.alt_loci[rel]):
            name = f"{rel}_{assembly}"
            print(f"Processing {name}", file=sys.stderr)
            create_remap(store, store.alt_loci[rel][assembly], name, major)
    for rel in sorted(store.patches):
        name = f"{rel}_PATCHES"
        print(f"Processing {name}", file=sys.stderr)
        create_remap(store, store.patches[rel], name, major)
    print("Done!", file=sys.stderr)
    return store


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="ibwa-tpu prepare-remap",
        description="Create .remap files from a GRC reference release tree")
    ap.add_argument("source")
    ap.add_argument("destination")
    ap.add_argument("flank", nargs="?", type=int, default=150)
    ap.add_argument("--major", default="GRCh37")
    ap.add_argument("--lite", default=None,
                    help="path to the <major>-lite reference FASTA")
    ap.add_argument("--yes", action="store_true",
                    help="skip the confirmation prompt")
    args = ap.parse_args(argv)
    if not args.yes:
        print(f"Destination {args.destination} must be empty; continue "
              "(yes/no): ", end="", flush=True)
        if input().strip() != "yes":
            return 0
    prepare(args.source, args.destination, args.flank, args.major,
            args.lite)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
