"""iBWA coordinate remapping layer (bwaremap.cpp + translate_cigar.cpp).

A `<prefix>.remap` file maps alternate-reference contigs back into
primary-reference coordinates via per-contig CIGARs (README.md:37-47).
Records are positional: the i-th record belongs to contig i of the alt
reference (load_remappings, bwaremap.cpp:42-89).

Header format (after '>'):  {label}-{target_name}|{start}|{stop}
                       or:  {label}-{target_name}|exact
followed by the remap CIGAR on subsequent lines (alt = query, primary =
reference: M/X/= advance both, D/N advance primary, I advances alt).

Copy of `ibwa_tpu/sam/remap.py`: the port keeps its own host code and imports
nothing of `ibwa_tpu`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys

FROM_M, FROM_I, FROM_D, FROM_S, FROM_N = 0, 1, 2, 3, 4
_OPS = "MIDSN"


@dataclasses.dataclass
class RemapRecord:
    """read_mapping_t (bwaremap.h:10-17)."""

    target: str                          # primary contig name
    start: int                           # 0-based start on the target
    stop: int                            # one past the last target base
    cigar: list[tuple[int, str]] | None  # (len, op) runs; None == exact
    n_gapo: int = 0
    exact: bool = False


def _parse_cigar_runs(s: str) -> list[tuple[int, str]]:
    return [(int(n), op) for n, op in re.findall(r"(\d+)([A-Za-z=])", s)]


def load_remap(prefix: str) -> dict[int, RemapRecord] | None:
    """load_remappings (bwaremap.cpp:42-89); None when no file exists."""
    path = prefix + ".remap"
    if not os.path.exists(path):
        print(f"No remapping file {path}", file=sys.stderr)
        return None
    mappings: dict[int, RemapRecord] = {}
    with open(path) as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    i = 0
    idx = 0
    while i < len(lines):
        line = lines[i]
        if not line.startswith(">"):
            raise ValueError(
                f"Unexpected character {line[:1]!r} at line {i + 1} of "
                f"{path}; expected '>'")
        body = line[1:]
        # can_remap: exactly one '-' and two '|' (bwaremap.cpp:16-25)
        if body.count("-") != 1 or body.count("|") != 2:
            raise ValueError(f"Failed to extract read mapping from {body!r}")
        after = body.split("-", 1)[1]
        name, rest = after.split("|", 1)
        if not name:
            raise ValueError(f"empty target name in {body!r}")
        i += 1
        cig_str = ""
        while i < len(lines) and not lines[i].startswith(">"):
            cig_str += lines[i]
            i += 1
        if rest.startswith("exact"):
            mappings[idx] = RemapRecord(target=name, start=0, stop=0,
                                        cigar=None, exact=True)
        else:
            start_s, stop_s = rest.split("|")
            runs = _parse_cigar_runs(cig_str)
            n_gapo = sum(1 for c in cig_str if c in "IDN")
            mappings[idx] = RemapRecord(
                target=name, start=int(start_s) - 1, stop=int(stop_s) + 1,
                cigar=runs, n_gapo=n_gapo)
        idx += 1
    return mappings


def remap_cigar_pos(runs: list[tuple[int, str]], pos: int,
                    seqlen: int) -> tuple[bool, int]:
    """remap_cigar (bwaremap.cpp:188-268): alt offset -> target offset."""
    if pos >= seqlen:
        print(f"[remap_coordinates] requested pos {pos} > sequence length "
              f"{seqlen}", file=sys.stderr)
        return False, 0
    altpos = refpos = 0
    last_op = ""
    it = iter(runs)
    while altpos <= pos:
        try:
            last_len, last_op = next(it)
        except StopIteration:
            break
        if last_op in "MX=":
            refpos += last_len
            altpos += last_len
        elif last_op in "ND":
            refpos += last_len
        elif last_op == "I":
            altpos += last_len
        else:
            print(f"invalid cigar character '{last_op}'", file=sys.stderr)
            return False, 0
    if altpos > seqlen:
        return False, 0
    if altpos == pos:
        return True, refpos
    if altpos > pos:
        if last_op in "MX=":
            return True, refpos - (altpos - pos)
        if last_op == "I":
            return True, refpos
        return False, 0
    return False, 0


def is_remapped_sequence_identical(m: RemapRecord, start: int,
                                   length: int) -> int:
    """is_remapped_sequence_identical (bwaremap.cpp:140-186)."""
    if m.exact:
        return 1
    pos = 0
    last_op = ""
    last_len = 0
    it = iter(m.cigar or [])
    while pos <= start:
        try:
            last_len, last_op = next(it)
        except StopIteration:
            break
        if last_op in "MX=ND":
            pos += last_len
        elif last_op == "I":
            pass
        else:
            return 0
    if pos > start:
        # uint32 arithmetic in the reference: last_len - start wraps when
        # negative, making the comparison true (bwaremap.cpp:179-180)
        return int(last_op in "M="
                   and ((last_len - start) & 0xFFFFFFFF) > length)
    return 0


class RemapRangeError(RuntimeError):
    pass


def remap_position_with_seqid(db, target_bns, pac_coor: int,
                              seqid: int) -> tuple[int, int]:
    """bwa_remap_position_with_seqid (bwaremap.cpp:277-311).

    pac_coor is LOCAL to the alt db.  Returns (status, global target pos)."""
    m = db.remap.get(seqid) if db.remap else None
    if m is None:
        raise RemapRangeError(f"No read mapping for sequence id {seqid}")
    target_idx = db.target_idx_cache.get(m.target)
    if target_idx is None:
        target_idx = next((i for i, a in enumerate(target_bns.anns)
                           if a.name == m.target), -1)
        if target_idx < 0:
            raise RemapRangeError(
                f"Failed to locate remapping target: {m.target}")
        db.target_idx_cache[m.target] = target_idx
    if not m.exact:
        altpos = pac_coor - db.bns.anns[seqid].offset
        ok, offset = remap_cigar_pos(m.cigar or [], altpos,
                                     db.bns.anns[seqid].length)
        if not ok:
            return 0, 0
        rv = m.start + offset
    else:
        rv = pac_coor - db.bns.anns[seqid].offset
    if not m.exact and (rv < m.start or rv > m.stop):
        raise RemapRangeError(
            f"remapped position out of range ({rv} should be in "
            f"[{m.start}, {m.stop}])")
    return 1, rv + target_bns.anns[target_idx].offset


def remap_entry(p, dbs, dbidx: int, gap: int) -> int:
    """__remap (bwape.c:201-219 / filter_alignments.cpp:14-33)."""
    db = dbs.dbs[dbidx]
    if db.remap is None:
        p.remapped_seqid = -1
        p.remapped_pos = p.pos
        return 1
    local = p.pos - db.offset
    seqid = dbs.seq_for_pos(db.bns, local)
    p.remapped_seqid = seqid
    target = dbs.dbs[0]
    status, x = remap_position_with_seqid(db, target.bns, local, seqid)
    # global coordinates: the target is db 0, offset added below
    p.remapped_pos = x + target.offset if status else 0
    m = db.remap[seqid]
    relpos = local - db.bns.anns[seqid].offset
    p.remap_identical = is_remapped_sequence_identical(
        m, relpos - gap if relpos > gap else 0, p.len + gap)
    return status


def extract_remapped(dbs, dbidx: int, seqid: int, beg: int,
                     length: int):
    """dbset_extract_remapped (dbset.c:261-304): stitch primary flanks
    around the alt contig (replicates the reference's use of `beg` for
    the middle segment)."""
    import numpy as np

    db = dbs.dbs[dbidx]
    ann = db.bns.anns[seqid]
    seq_begin = db.offset + ann.offset
    parts = []
    total = 0
    target = dbs.dbs[0]

    if beg < seq_begin:
        status, remapped_begin = remap_position_with_seqid(
            db, target.bns, ann.offset, seqid)
        remapped_begin += target.offset
        sublen = seq_begin - beg
        offset = remapped_begin - sublen
        if sublen > remapped_begin or status == 0:
            raise RemapRangeError("request too far ahead of remapped region")
        seg = dbs.extract_sequence(offset, sublen)
        parts.append(seg)
        total += len(seg)

    if total < length:
        sublen = length - total
        if sublen > ann.length:
            sublen = ann.length
        seg = dbs.extract_sequence(beg, sublen)
        parts.append(seg)
        total += len(seg)

    if total < length:
        status, rend = remap_position_with_seqid(
            db, target.bns, ann.offset + ann.length - 1, seqid)
        if status == 0:
            raise RemapRangeError("request too far ahead of remapped region")
        remapped_end = rend + target.offset + 1
        seg = dbs.extract_sequence(remapped_end, length - total)
        parts.append(seg)
        total += len(seg)

    if total != length:
        raise RemapRangeError(
            f"logic error: got {total} bases instead of {length}")
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)


class _CigarBuilder:
    def __init__(self):
        self.cigar: list[int] = []

    def push(self, op: int, length: int) -> None:
        if self.cigar and (self.cigar[-1] >> 29) == op:
            self.cigar[-1] = (op << 29) | ((self.cigar[-1] & 0x1FFFFFFF)
                                           + length)
        else:
            self.cigar.append((op << 29) | length)


def translate_cigar(runs: list[tuple[int, str]], start: int,
                    read_cigar: list[int] | None,
                    read_len: int) -> list[int] | None:
    """translate_cigar (translate_cigar.cpp:71-357): compose the read's
    CIGAR (vs the alt contig) with the contig's remap CIGAR (vs primary)."""
    try:
        return _translate(runs, start, read_cigar, read_len)
    except Exception as e:  # noqa: BLE001 — mirrors the C++ catch-all
        print(f"Error translating cigar string: {e}", file=sys.stderr)
        return None


def _translate(runs, start, read_cigar, total_read_len):
    cb = _CigarBuilder()
    seq_iter = iter(runs)

    def seq_advance():
        nonlocal seq_len, seq_op, seq_exhausted
        try:
            seq_len, seq_op = next(seq_iter)
        except StopIteration:
            seq_len, seq_op = 0, ""
            seq_exhausted = True

    read_idx = 0

    def read_advance():
        nonlocal read_len, read_op, read_idx
        if read_cigar is None:
            return
        read_len = read_cigar[read_idx] & 0x1FFFFFFF
        read_op = read_cigar[read_idx] >> 29
        read_idx += 1

    seq_len = 0
    seq_op = ""
    seq_exhausted = False
    read_len = 0
    read_op = 0
    seq_advance()
    read_advance()

    def eos():
        return seq_len == 0 and seq_exhausted

    def eor():
        return read_len == 0 and read_idx >= len(read_cigar or [])

    # find_start_pos (translate_cigar.cpp:267-300)
    cpos = 0
    while cpos < start and not eos():
        if seq_len == 0:
            seq_advance()
            continue
        if seq_op in "=MXI":
            dist = start - cpos
            if seq_len > dist:
                seq_len -= start - cpos
                cpos = start
            else:
                cpos += seq_len
                seq_len = 0
        elif seq_op in "ND":
            seq_len = 0
        else:
            raise ValueError(f"Invalid cigar character: {seq_op}")
    if cpos < start:
        raise ValueError(f"Failed to seek to position {start}")

    def tr_seqop(op: str) -> int:
        # like the C++ tr_seqop, X/= are NOT accepted (they throw)
        table = {"M": FROM_M, "I": FROM_I, "D": FROM_D, "S": FROM_S,
                 "N": FROM_N}
        if op not in table:
            raise ValueError(f"Unknown cigar operation: {op}")
        return table[op]

    if read_cigar is None:
        ln = 0
        while ln < total_read_len and not eos():
            if seq_len == 0:
                seq_advance()
                continue
            dist = total_read_len - ln
            if seq_len < dist:
                cb.push(tr_seqop(seq_op), seq_len)
                ln += seq_len
                seq_advance()
            else:
                cb.push(tr_seqop(seq_op), dist)
                break
        return cb.cigar

    while not eor() and not eos():
        if seq_len == 0:
            seq_advance()
        if read_len == 0:
            read_advance()
        if _OPS[read_op] == "S":
            cb.push(read_op, read_len)
            read_len = 0
            if not eor():
                read_advance()
            continue

        if seq_op in "=MX":       # in_match
            rc = _OPS[read_op]
            if rc in "MND":
                if seq_len >= read_len:
                    cb.push(read_op, read_len)
                    seq_len -= read_len
                    read_len = 0
                else:
                    cb.push(read_op, seq_len)
                    read_len -= seq_len
                    seq_len = 0
            elif rc == "I":
                cb.push(read_op, read_len)
                read_len = 0
            else:
                raise ValueError("Unknown cigar op in read")
        elif seq_op == "I":       # in_insertion
            rc = _OPS[read_op]
            if rc == "M":
                if seq_len < read_len:
                    cb.push(1, seq_len)
                    read_len -= seq_len
                    seq_len = 0
                else:
                    cb.push(1, read_len)
                    seq_len -= read_len
                    read_len = 0
            elif rc == "I":
                cb.push(read_op, read_len)
                read_len = 0
            elif rc in "ND":
                if seq_len > read_len:
                    seq_len -= read_len
                    read_len = 0
                else:
                    read_len -= seq_len
                    seq_len = 0
            else:
                raise ValueError("Unknown cigar op in read")
        elif seq_op in "ND":      # in_deletion
            rc = _OPS[read_op]
            if rc == "M":
                cb.push(tr_seqop(seq_op), seq_len)
                seq_advance()
            elif rc == "I":
                cb.push(tr_seqop(seq_op), seq_len)
                seq_advance()
                cb.push(read_op, read_len)
                read_advance()
            elif rc in "ND":
                cb.push(tr_seqop(seq_op), seq_len)
                seq_len = 0
            else:
                raise ValueError("Unknown cigar op in read")
        else:
            raise ValueError(f"Invalid cigar character: {seq_op}")

    while not eor():
        if read_len == 0:
            read_advance()
        if _OPS[read_op] in "MIS":
            cb.push(FROM_S, read_len)
        read_len = 0

    return cb.cigar
