"""ctypes glue for the native sampe per-read stage (pe_stage.cpp).

The Python sampe module (sam/sampe.py) remains the orchestrator and the
semantic reference; this wrapper swaps its per-read inner loops — SE
selection, PE candidate expansion, pairing sweep and XA selection — for
the compiled implementations, mirroring how the reference runs them as
threaded C (bwape.c:238-297).  Set IBWA_PURE_PY=1 to force the Python
path (used to cross-check parity).

Copy of `ibwa_tpu/sam/pe_native.py`: the port keeps its own host code and
imports nothing of `ibwa_tpu`.  `device_available()` is left out: it read
IBWA_PE_DEVICE and imported jax.  Whether `sampe` walks on a device is the
caller's explicit choice (`sam.sampe.sai2sam_pe(device=...)`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from .bwase import Multi, TYPE_REPEAT, TYPE_UNIQUE
from .remap import RemapRecord

_RM_CODE = {"M": 0, "X": 1, "=": 2, "N": 3, "D": 4, "I": 5}

_sigs_done = False


def _lib():
    global _sigs_done
    lib = native.load()
    if _sigs_done:
        return lib
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ibwa_pe_new.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.ibwa_pe_new.restype = ctypes.c_void_p
    lib.ibwa_pe_free.argtypes = [ctypes.c_void_p]
    lib.ibwa_pe_add_db.argtypes = [
        ctypes.c_void_p, u32p, ctypes.c_uint32, u32p, ctypes.c_uint32,
        u32p, ctypes.c_uint32, ctypes.c_uint32, u32p, u32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i64p, i32p,
        ctypes.c_int32, ctypes.c_int32, i32p, u8p, i64p, i64p,
        i64p, i32p, u8p, i32p]
    lib.ibwa_pe_set_sai.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, i32p, u32p,
        ctypes.c_int64]
    lib.ibwa_pe_se_stage.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i32p, i32p, i32p, u64p, i64p, i32p]
    lib.ibwa_pe_pe_stage.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i32p, i32p, i32p,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        u64p, i64p, i32p, ctypes.c_int32, i32p, i64p, i32p]
    lib.ibwa_pe_pe_stage.restype = ctypes.c_int64
    lib.ibwa_sai_scan.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                  i32p, u32p]
    lib.ibwa_sai_scan.restype = ctypes.c_int64
    lib.ibwa_se_stage.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, u64p, i64p, i32p,
        ctypes.c_int32, i32p, i64p, i32p]
    lib.ibwa_pe_set_emit_db.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, u8p, ctypes.c_int64, i64p, i32p,
        u8p, i64p, i32p]
    lib.ibwa_pe_emit.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        u8p, i64p,               # orig, orig_off
        u8p, i64p,               # qual, qual_off
        u8p, i64p,               # name, name_off
        u8p, i64p,               # bc, bc_off
        i32p, i32p, i32p,        # clip_len, full_len, max_diff
        i64p, i32p,              # io_i64, io_i32
        i32p, i64p, i32p, ctypes.c_int32,   # multis
        u32p, i64p, i32p,        # in_cig, in_cig_off, in_cig_cnt
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p]
    lib.ibwa_pe_emit.restype = ctypes.c_int64
    lib.ibwa_pe_emit_buf.argtypes = [ctypes.c_void_p]
    lib.ibwa_pe_emit_buf.restype = ctypes.c_void_p
    lib.ibwa_interleave_blobs.argtypes = [
        u8p, i64p, u8p, i64p, ctypes.c_int64, ctypes.c_int64, u8p, i64p]
    lib.ibwa_pe_prefill_walks.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        u32p, u32p, i64p, u32p]
    _sigs_done = True
    return lib


def interleave_blobs(blob0, off0, blob1, off1, start: int, n: int):
    """End-read-ordered (r0/e0, r0/e1, r1/e0, ...) flat blob from two
    per-file blob sets, sliced to [start, start+n) (native memcpy loop)."""
    lib = _lib()
    total = int(off0[start + n] - off0[start]
                + off1[start + n] - off1[start])
    out = np.empty(max(total, 1), dtype=np.uint8)
    off = np.empty(2 * n + 1, dtype=np.int64)
    lib.ibwa_interleave_blobs(
        _ptr(blob0, ctypes.c_uint8), _ptr(off0, ctypes.c_int64),
        _ptr(blob1, ctypes.c_uint8), _ptr(off1, ctypes.c_int64),
        start, n, _ptr(out, ctypes.c_uint8), _ptr(off, ctypes.c_int64))
    return out, off


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# i64 per-end-read fields (pe_stage.cpp enum): pos, rpos, sa, c1, c2
NF64 = 5
# i32 fields: type, strand, nmm, ngapo, ngape, score, mapQ, seQ, dbidx,
#             rseqid, rident, extra_flag
NF32 = 12


class PeNative:
    """One sampe run's native context: db tables + per-batch sai groups."""

    def __init__(self, dbs, popt, gopt):
        self._lib = _lib()
        self._keep = []  # keep every passed array alive
        self._ctx = self._lib.ibwa_pe_new(int(popt.remapping),
                                          int(gopt.s_mm))
        self._dbs = dbs
        for db in dbs.dbs:
            self._add_db(db)

    def _add_db(self, db) -> None:
        fmf = db.load_fm(0)
        fmr = db.load_fm(1)
        keep = self._keep
        itl_f = np.ascontiguousarray(fmf._interleaved, dtype=np.uint32)
        itl_r = np.ascontiguousarray(fmr._interleaved, dtype=np.uint32)
        l2 = np.ascontiguousarray(fmf.L2, dtype=np.uint32)
        sa_f = np.ascontiguousarray(fmf.sa, dtype=np.uint32)
        sa_r = np.ascontiguousarray(fmr.sa, dtype=np.uint32)
        ann_off = np.array([a.offset for a in db.bns.anns], dtype=np.int64)
        ann_len = np.array([a.length for a in db.bns.anns], dtype=np.int32)
        keep += [itl_f, itl_r, l2, sa_f, sa_r, ann_off, ann_len]

        has_remap = db.remap is not None
        if has_remap:
            n_rm = max(db.remap.keys()) + 1 if db.remap else 0
            rm_target = np.full(n_rm, -1, dtype=np.int32)
            rm_exact = np.zeros(n_rm, dtype=np.uint8)
            rm_start = np.zeros(n_rm, dtype=np.int64)
            rm_stop = np.zeros(n_rm, dtype=np.int64)
            rm_begin = np.zeros(n_rm, dtype=np.int64)
            rm_cnt = np.zeros(n_rm, dtype=np.int32)
            ops_all: list[int] = []
            lens_all: list[int] = []
            target_bns = self._dbs.dbs[0].bns
            name_idx = {a.name: i for i, a in enumerate(target_bns.anns)}
            for seqid in range(n_rm):
                m: RemapRecord | None = db.remap.get(seqid)
                if m is None:
                    continue  # missing id -> C++ fatal if ever touched
                ti = name_idx.get(m.target, -1)
                rm_target[seqid] = ti
                rm_exact[seqid] = 1 if m.exact else 0
                rm_start[seqid] = m.start
                rm_stop[seqid] = m.stop
                rm_begin[seqid] = len(ops_all)
                runs = m.cigar or []
                rm_cnt[seqid] = len(runs)
                for ln, op in runs:
                    ops_all.append(_RM_CODE.get(op, 6))
                    lens_all.append(ln)
            rm_ops = np.array(ops_all, dtype=np.uint8)
            rm_lens = np.array(lens_all, dtype=np.int32)
        else:
            n_rm = 0
            rm_target = np.zeros(0, dtype=np.int32)
            rm_exact = np.zeros(0, dtype=np.uint8)
            rm_start = np.zeros(0, dtype=np.int64)
            rm_stop = np.zeros(0, dtype=np.int64)
            rm_begin = np.zeros(0, dtype=np.int64)
            rm_cnt = np.zeros(0, dtype=np.int32)
            rm_ops = np.zeros(0, dtype=np.uint8)
            rm_lens = np.zeros(0, dtype=np.int32)
        keep += [rm_target, rm_exact, rm_start, rm_stop, rm_begin, rm_cnt,
                 rm_ops, rm_lens]

        u32 = ctypes.c_uint32
        self._lib.ibwa_pe_add_db(
            self._ctx, _ptr(itl_f, u32), fmf.primary, _ptr(itl_r, u32),
            fmr.primary, _ptr(l2, u32), fmf.seq_len, fmf.sa_intv,
            _ptr(sa_f, u32), _ptr(sa_r, u32),
            db.offset, db.bns.l_pac, len(db.bns.anns),
            _ptr(ann_off, ctypes.c_int64), _ptr(ann_len, ctypes.c_int32),
            1 if has_remap else 0, n_rm,
            _ptr(rm_target, ctypes.c_int32), _ptr(rm_exact, ctypes.c_uint8),
            _ptr(rm_start, ctypes.c_int64), _ptr(rm_stop, ctypes.c_int64),
            _ptr(rm_begin, ctypes.c_int64), _ptr(rm_cnt, ctypes.c_int32),
            _ptr(rm_ops, ctypes.c_uint8), _ptr(rm_lens, ctypes.c_int32))

    def set_sai_batch(self, end: int, dbidx: int, counts: np.ndarray,
                      recs: np.ndarray, n_reads: int) -> None:
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        recs = np.ascontiguousarray(recs, dtype=np.uint32)
        # replace previous batch's keepalive for this slot
        self._batch_keep = getattr(self, "_batch_keep", {})
        self._batch_keep[(end, dbidx)] = (counts, recs)
        self._lib.ibwa_pe_set_sai(self._ctx, end, dbidx,
                                  _ptr(counts, ctypes.c_int32),
                                  _ptr(recs, ctypes.c_uint32), n_reads)

    def se_select_arrays(self, n: int, n_occ: int, rng):
        """samse selection returning the raw state arrays (no per-read
        Python objects) for the native emit path."""
        i64 = np.zeros(n * NF64, dtype=np.int64)
        i32 = np.zeros(n * NF32, dtype=np.int32)
        st = np.array([rng.x], dtype=np.uint64)
        cap = max(n_occ, 1)
        mc = np.zeros(n, dtype=np.int32)
        mpos = np.zeros(n * cap, dtype=np.int64)
        mmeta = np.zeros(n * cap * 4, dtype=np.int32)
        self._lib.ibwa_se_stage(
            self._ctx, n, n_occ, _ptr(st, ctypes.c_uint64),
            _ptr(i64, ctypes.c_int64), _ptr(i32, ctypes.c_int32), cap,
            _ptr(mc, ctypes.c_int32), _ptr(mpos, ctypes.c_int64),
            _ptr(mmeta, ctypes.c_int32))
        rng.x = int(st[0])
        return i64, i32, mc, mpos, mmeta, cap

    def se_stage_arrays(self, n: int, lens, fulls, max_diffs, i64, i32,
                        rng) -> None:
        """Serial PE SE-selection over raw state arrays (no AlnSeq)."""
        md = np.ascontiguousarray(max_diffs, dtype=np.int32)
        st = np.array([rng.x], dtype=np.uint64)
        self._lib.ibwa_pe_se_stage(
            self._ctx, n, _ptr(lens, ctypes.c_int32),
            _ptr(fulls, ctypes.c_int32), _ptr(md, ctypes.c_int32),
            _ptr(st, ctypes.c_uint64), _ptr(i64, ctypes.c_int64),
            _ptr(i32, ctypes.c_int32))
        rng.x = int(st[0])

    def pe_stage_arrays(self, n: int, lens, fulls, max_diffs, ii, popt,
                        i64, i32, rng):
        """PE candidate expansion + pairing + XA over raw state arrays.

        Returns (cnt_chg, mc, mpos, mmeta, cap)."""
        md = np.ascontiguousarray(max_diffs, dtype=np.int32)
        st = np.array([rng.x], dtype=np.uint64)
        cap = max(popt.n_multi, popt.N_multi, 1)
        mc = np.zeros(2 * n, dtype=np.int32)
        mpos = np.zeros(2 * n * cap, dtype=np.int64)
        mmeta = np.zeros(2 * n * cap * 4, dtype=np.int32)
        cnt_chg = self._lib.ibwa_pe_pe_stage(
            self._ctx, n, _ptr(lens, ctypes.c_int32),
            _ptr(fulls, ctypes.c_int32), _ptr(md, ctypes.c_int32),
            float(ii.avg), float(ii.std), int(ii.low), int(ii.high),
            int(ii.high_bayesian), int(popt.max_isize),
            int(popt.n_multi), int(popt.N_multi),
            _ptr(st, ctypes.c_uint64), _ptr(i64, ctypes.c_int64),
            _ptr(i32, ctypes.c_int32), cap, _ptr(mc, ctypes.c_int32),
            _ptr(mpos, ctypes.c_int64), _ptr(mmeta, ctypes.c_int32))
        rng.x = int(st[0])
        return int(cnt_chg), mc, mpos, mmeta, cap

    # total SA rows expanded per device prefill call (walk arrays are
    # ~8 B/row host-side; the native cache caps itself independently)
    PREFILL_MAX_ROWS = 16 << 20

    def device_prefill_walks(self, walkers, recs_by_db
                             ) -> tuple[int, int, int, int]:
        """Resolve every SA interval of a batch's .sai records on the
        device and prefill the native stage's walk cache, so
        compute_coords (pe_stage.cpp) never LF-walks on the host core.

        walkers: per-db fm.walk.DeviceWalker (None entries skip that db),
        in DbSet's order; recs_by_db: per-db list of u32[n,4] .sai record
        arrays (meta,k,l,score) — both ends' scans for the batch.

        Returns (rows resolved on the device, dispatches, rows and
        intervals left to the host walks past PREFILL_MAX_ROWS)."""
        n_rows_dev = n_disp = left_rows = left_ivs = 0
        for dbidx, recs_list in enumerate(recs_by_db):
            w = walkers[dbidx] if dbidx < len(walkers) else None
            recs_list = [r for r in recs_list if len(r)]
            if w is None or not recs_list:
                continue
            recs = (np.concatenate(recs_list) if len(recs_list) > 1
                    else recs_list[0])
            a = ((recs[:, 0] >> 24) & 1).astype(np.uint8)
            groups = []
            rows_parts, strd_parts = [], []
            total = 0
            for av in (0, 1):
                sel = recs[a == av]
                if not len(sel):
                    continue
                key = (sel[:, 1].astype(np.uint64) << np.uint64(32)) \
                    | sel[:, 2].astype(np.uint64)
                key = np.unique(key)
                ks = (key >> np.uint64(32)).astype(np.uint32)
                ls = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                widths = ls.astype(np.int64) - ks + 1
                # drop widest intervals past the row budget (they fall
                # back to host walks + the native wide-interval cache;
                # counted in what this returns)
                csum = np.cumsum(widths[np.argsort(widths)])
                budget = self.PREFILL_MAX_ROWS - total
                n_keep = int(np.searchsorted(csum, budget, side="right"))
                if n_keep < len(widths):
                    order = np.argsort(widths)[:n_keep]
                    left_rows += int(csum[-1]) - (int(csum[n_keep - 1])
                                                  if n_keep else 0)
                    left_ivs += len(widths) - n_keep
                    ks, ls = ks[order], ls[order]
                    widths = widths[order]
                if not len(ks):
                    continue
                off = np.zeros(len(ks) + 1, dtype=np.int64)
                np.cumsum(widths, out=off[1:])
                n_rows = int(off[-1])
                total += n_rows
                pos = (np.arange(n_rows, dtype=np.int64)
                       - np.repeat(off[:-1], widths))
                rows = (np.repeat(ks.astype(np.int64), widths)
                        + pos).astype(np.uint32)
                rows_parts.append(rows)
                # device strand: a=1 walks the forward index (walker 0)
                strd_parts.append(
                    np.full(n_rows, 1 - av, dtype=np.uint32))
                groups.append((av, ks, ls, off, n_rows))
            if not groups:
                continue
            all_rows = np.concatenate(rows_parts)
            all_strd = np.concatenate(strd_parts)
            vals = w.resolve(all_strd, all_rows)
            n_rows_dev += len(all_rows)
            n_disp += -(-len(all_rows) // w.lanes)
            base = 0
            for av, ks, ls, off, n_rows in groups:
                self._lib.ibwa_pe_prefill_walks(
                    self._ctx, dbidx, av, len(ks),
                    _ptr(np.ascontiguousarray(ks), ctypes.c_uint32),
                    _ptr(np.ascontiguousarray(ls), ctypes.c_uint32),
                    _ptr(off, ctypes.c_int64),
                    _ptr(np.ascontiguousarray(vals[base:base + n_rows]),
                         ctypes.c_uint32))
                base += n_rows
        return n_rows_dev, n_disp, left_rows, left_ivs

    def enable_emit(self) -> None:
        """Register the emit-time per-db data (pac codes, .amb holes,
        contig names, remap gap-opens) for ibwa_pe_emit."""
        if getattr(self, "_emit_ready", False):
            return
        for i, db in enumerate(self._dbs.dbs):
            pac = db.load_pac_packed()
            if not pac.flags.c_contiguous:
                pac = np.ascontiguousarray(pac)
            bns = db.bns
            amb_off = np.array([h.offset for h in bns.ambs], dtype=np.int64)
            amb_len = np.array([h.length for h in bns.ambs], dtype=np.int32)
            names = [a.name.encode("latin-1") for a in bns.anns]
            name_off = np.zeros(len(names) + 1, dtype=np.int64)
            name_off[1:] = np.cumsum([len(n) for n in names])
            name_blob = np.frombuffer(b"".join(names) or b"\0",
                                      dtype=np.uint8)
            n_rm = 0
            if db.remap is not None and db.remap:
                n_rm = max(db.remap.keys()) + 1
            rm_ngapo = np.zeros(max(n_rm, 1), dtype=np.int32)
            if db.remap:
                for seqid, m in db.remap.items():
                    rm_ngapo[seqid] = m.n_gapo
            self._keep += [pac, amb_off, amb_len, name_blob, name_off,
                           rm_ngapo]
            self._lib.ibwa_pe_set_emit_db(
                self._ctx, i, _ptr(pac, ctypes.c_uint8), len(bns.ambs),
                _ptr(amb_off, ctypes.c_int64), _ptr(amb_len, ctypes.c_int32),
                _ptr(name_blob, ctypes.c_uint8),
                _ptr(name_off, ctypes.c_int64),
                _ptr(rm_ngapo, ctypes.c_int32))
        self._emit_ready = True

    def emit(self, reads_by_e, lens, fulls, max_diff, i64, i32,
             multi_cnt, multi_pos, multi_meta, multi_cap: int,
             in_cigs: dict | None, mode: int, max_top2: int,
             rg_id: str | None, is_pe: bool, se_mode: bool) -> bytes:
        """emit_blobs over per-read Read objects (slow-loader paths:
        -q trimming, barcodes, BAM input)."""
        n_er = len(reads_by_e)
        orig_blob = (np.concatenate([r.orig for r in reads_by_e])
                     if n_er else np.zeros(0, np.uint8))
        orig_off = np.zeros(n_er + 1, dtype=np.int64)
        orig_off[1:] = np.cumsum(np.asarray(fulls, dtype=np.int64))
        quals = [r.qual or b"" for r in reads_by_e]
        qual_off = np.zeros(n_er + 1, dtype=np.int64)
        qual_off[1:] = np.cumsum([len(q) for q in quals])
        qual_blob = np.frombuffer(b"".join(quals) or b"\0", dtype=np.uint8)
        names = [r.name.encode("latin-1") for r in reads_by_e]
        name_off = np.zeros(n_er + 1, dtype=np.int64)
        name_off[1:] = np.cumsum([len(n) for n in names])
        name_blob = np.frombuffer(b"".join(names) or b"\0", dtype=np.uint8)
        bcs = [r.bc.encode("latin-1") for r in reads_by_e]
        bc_off = np.zeros(n_er + 1, dtype=np.int64)
        bc_off[1:] = np.cumsum([len(b) for b in bcs])
        bc_blob = np.frombuffer(b"".join(bcs) or b"\0", dtype=np.uint8)
        return self.emit_blobs(
            n_er, orig_blob, orig_off, qual_blob, qual_off, name_blob,
            name_off, bc_blob, bc_off, lens, fulls, max_diff, i64, i32,
            multi_cnt, multi_pos, multi_meta, multi_cap, in_cigs, mode,
            max_top2, rg_id, is_pe, se_mode)

    def emit_blobs(self, n_er, orig_blob, orig_off, qual_blob, qual_off,
                   name_blob, name_off, bc_blob, bc_off, lens, fulls,
                   max_diff, i64, i32, multi_cnt, multi_pos, multi_meta,
                   multi_cap: int, in_cigs: dict | None, mode: int,
                   max_top2: int, rg_id: str | None, is_pe: bool,
                   se_mode: bool) -> bytes:
        """Native refine + MD + correct_trimmed + print_sam1 for a batch
        (ibwa_pe_emit) over flat end-read-ordered blobs.  Returns the SAM
        text for the batch as bytes."""
        self.enable_emit()
        if in_cigs:
            cnts = np.zeros(n_er, dtype=np.int32)
            for e, cig in in_cigs.items():
                cnts[e] = len(cig)
            cig_off = np.zeros(n_er + 1, dtype=np.int64)
            cig_off[1:] = np.cumsum(cnts)
            cig_blob = np.zeros(max(int(cig_off[-1]), 1), dtype=np.uint32)
            for e, cig in in_cigs.items():
                cig_blob[cig_off[e]:cig_off[e] + len(cig)] = cig
        else:
            cnts = np.zeros(n_er, dtype=np.int32)
            cig_off = np.zeros(n_er + 1, dtype=np.int64)
            cig_blob = np.zeros(1, dtype=np.uint32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        fulls = np.ascontiguousarray(fulls, dtype=np.int32)
        md = np.ascontiguousarray(max_diff, dtype=np.int32)
        orig_blob = np.ascontiguousarray(orig_blob, dtype=np.uint8)
        orig_off = np.ascontiguousarray(orig_off, dtype=np.int64)
        qual_off = np.ascontiguousarray(qual_off, dtype=np.int64)
        name_off = np.ascontiguousarray(name_off, dtype=np.int64)
        n = self._lib.ibwa_pe_emit(
            self._ctx, 1 if is_pe else 0, 1 if se_mode else 0,
            n_er // 2 if is_pe else n_er,
            _ptr(orig_blob, ctypes.c_uint8), _ptr(orig_off, ctypes.c_int64),
            _ptr(qual_blob, ctypes.c_uint8), _ptr(qual_off, ctypes.c_int64),
            _ptr(name_blob, ctypes.c_uint8), _ptr(name_off, ctypes.c_int64),
            _ptr(bc_blob, ctypes.c_uint8), _ptr(bc_off, ctypes.c_int64),
            _ptr(lens, ctypes.c_int32), _ptr(fulls, ctypes.c_int32),
            _ptr(md, ctypes.c_int32),
            _ptr(i64, ctypes.c_int64), _ptr(i32, ctypes.c_int32),
            _ptr(multi_cnt, ctypes.c_int32), _ptr(multi_pos, ctypes.c_int64),
            _ptr(multi_meta, ctypes.c_int32), multi_cap,
            _ptr(cig_blob, ctypes.c_uint32), _ptr(cig_off, ctypes.c_int64),
            _ptr(cnts, ctypes.c_int32),
            mode, max_top2,
            rg_id.encode("latin-1") if rg_id else None)
        if n < 0:
            raise RuntimeError("ibwa_pe_emit failed")
        return ctypes.string_at(self._lib.ibwa_pe_emit_buf(self._ctx), n)

    def __del__(self):
        try:
            self._lib.ibwa_pe_free(self._ctx)
        except Exception:
            pass


def scan_sai_batch(blob: bytes, n_reads: int
                   ) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse n_reads .sai records from blob via the native scanner.

    Returns (counts[n], recs[tot,4] u32, bytes_consumed)."""
    lib = _lib()
    buf = np.frombuffer(blob, dtype=np.uint8)
    counts = np.zeros(n_reads, dtype=np.int32)
    cap = max(len(blob) // 16 + 1, 1)
    recs = np.empty((cap, 4), dtype=np.uint32)
    used = lib.ibwa_sai_scan(_ptr(buf, ctypes.c_uint8), len(blob), n_reads,
                             _ptr(counts, ctypes.c_int32),
                             _ptr(recs, ctypes.c_uint32))
    if used < 0:
        raise ValueError("truncated .sai stream")
    tot = int(counts.sum())
    return counts, recs[:tot].copy(), int(used)
