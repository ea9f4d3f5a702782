"""Tables above 2^31 rows on the CPU: the lifted tables of
`ibwa_tpu_torch/tall_table.py` against their genome's own table, the occ
query of `csrc/fm_row.cuh` (g++ over the CUDA stand-in) at and above 2^31,
and `aln` and the SA walker on a lifted table held against `ibwa_tpu`.

* The lift's invariants on a 29,950 bp genome lifted by 1,280 rows: L2',
  the checkpoints, the sampled SA, LF'(r) = LF(r - m) + m for every row of
  the genome but the primary (LF' of the primary is 0, of a padding row r
  r + 1), and the SA walk's value + m (its value itself where the walk
  passes the primary row, to row 0, whose sample the format fixes).
* `fm_row.cuh`'s `occ_block`, `fetch_occ_row`, `occ_count`, `occ_count4`
  and `prefetch_pair` / `take_pair` on the `straddle` (m = 2^31 - 2^14:
  its rows cross 2^31) and `top` (seq_len' = 2^32 - 2) lifts of that
  genome, a row source that computes the
  padding rows on the fly (no table of 2^31 rows is stored), at k = 0, m
  and its neighbours, 2^31 and its neighbours, primary' and its
  neighbours, seq_len' - 1, seq_len', NEG1 and random rows: the row asked
  for, the offset, the NEG1 / seq_len flags and the counts against the
  plain `occ4_plain` of the genome's table raised by m in A's column; and
  `FlatRows` / `ShardRows` addresses and `shards_ok` at 2^27 table rows.
* `aln` on the straddle lift (m = 2^31 - 2^19) of a 1.04 Mbp genome with a
  600 kbp poly-A run (so that a read of 100 A's has a hit of more than 2^31
  rows, and hits of one mismatch beside it), 64 simulated reads and four
  poly-A reads: the port's torch route on the CPU (the plain kernels,
  IBWA_HOST_FRAC=0) at its default caps and with every read kept on the
  plain route (ACAP 1024, iter_cap 6,144), and its native route, all
  byte-equal to `ibwa_tpu`'s JAX engine with every read on its device
  search (one CPU device, the same caps).  `ibwa_tpu`'s native search
  differs from its own JAX engine there (its best_cnt is a long long, the
  reference's and the engine's an int): an `xfail(strict=True)` case.
* The plain SA walker (`resolve_intervals_plain`) on the .sai's intervals
  and on random intervals of rows at and above 2^31 of that lift against
  the native host walk.
"""

import contextlib
import ctypes
import gc
import io
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
from ibwa_tpu.align import engine_jax
from ibwa_tpu.align.opts import GapOpt as JGapOpt
from ibwa_tpu.fm.fmindex import FmIndex as JFmIndex
from ibwa_tpu.index.builder import load_index as j_load_index
from ibwa_tpu.io import sai as j_sai
from ibwa_tpu.io.reads import load_reads as j_load_reads

from ibwa_tpu_torch import native, tall_table
from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.align import pipeline as t_pipeline
from ibwa_tpu_torch.align.opts import GapOpt
from ibwa_tpu_torch.fm import device as tdev
from ibwa_tpu_torch.fm import walk
from ibwa_tpu_torch.fm.fmindex import FmIndex
from ibwa_tpu_torch.index import builder, formats
from ibwa_tpu_torch.io.sai import iter_sai
from ibwa_tpu_torch.u32 import MASK, NEG1

from test_torch_chunk import CSRC, STANDIN, standin_source

torch.set_num_threads(1)

HIGH = 1 << 31
SMALL_BP = 29_950       # = 2^32 - 2 mod 128: the top lift ends at 2^32 - 2
SMALL_M = 1280
LANES = 64
WIDE_CAPS = {"ACAP": 1024, "ITER_CAP": 6144}   # every read on the device
PROBES = ("A" * 100, "A" * 60 + "C" + "A" * 39, "T" * 100)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_fa(path, contigs) -> None:
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")


def _random(rng, n: int) -> str:
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    fa = tmp_path_factory.mktemp("tall_small") / "g.fa"
    _write_fa(fa, [("c1", _random(np.random.default_rng(1901), SMALL_BP))])
    builder.bwa_index(str(fa))
    return str(fa)


def _fms(prefix: str):
    return tuple(FmIndex(builder.load_index(prefix, s)) for s in (0, 1))


# ---- the lift's invariants --

def _lf_all(fm: tdev.DeviceFmPair, n_rows: int):
    """LF of every row 0..n_rows - 1 of both strands (int64[2,
    n_rows]), by the plain walker's step."""
    k = torch.arange(n_rows, dtype=torch.int64)
    return torch.stack([walk.lf_step_plain(fm, torch.full_like(k, s), k)
                        for s in (0, 1)])


def test_lift_invariants(small, tmp_path):
    out = str(tmp_path / "lift")
    rep = tall_table.lift(small, out, SMALL_M)
    m, blocks = SMALL_M, SMALL_M // 128
    for s, (bwt_ext, sa_ext) in enumerate(tall_table.STRANDS):
        a = formats.read_bwt(small + bwt_ext)
        formats.read_sa(small + sa_ext, a)
        b = formats.read_bwt(out + bwt_ext)
        formats.read_sa(out + sa_ext, b)
        assert b.seq_len == a.seq_len + m == rep["seq_len"]
        assert b.primary == a.primary + m == rep["primary"][s]
        assert b.L2[0] == 0
        assert (b.L2[1:].astype(np.int64) == a.L2[1:] + m).all()
        itl = np.asarray(b.interleaved)
        pad = itl[:12 * blocks].reshape(blocks, 12)
        assert (pad[:, 0] == 128 * np.arange(blocks)).all()
        assert not pad[:, 1:].any()
        want = np.array(a.interleaved, dtype=np.int64)
        n_blk = -(-a.seq_len // 128)
        want[0:12 * (n_blk - 1) + 1:12] += m
        want[-4] += m
        assert (itl[12 * blocks:] == want).all()
        step = m // a.sa_intv
        assert len(b.sa) == len(a.sa) + step
        assert (b.sa[step:] == (a.sa.astype(np.int64) + m) & MASK).all()
        assert (b.sa[1:step] == m - 1 - a.sa_intv * np.arange(1, step)).all()
    # LF'(r) = LF(r - m) + m on the genome's rows, but LF'(primary') = 0;
    # LF'(r) = r + 1 on the padding's
    fa, fb = _fms(small), _fms(out)
    ta = tdev.build_device_pair(*fa, "cpu")
    tb = tdev.build_device_pair(*fb, "cpu")
    n = fa[0].seq_len
    la, lb = _lf_all(ta, n + 1), _lf_all(tb, n + m + 1)
    for s in (0, 1):
        got, want = lb[s, m:].clone(), la[s] + m
        p = fa[s].primary
        assert int(got[p]) == 0 and int(want[p]) == m
        got[p] = want[p]
        assert torch.equal(got, want)
        assert torch.equal(lb[s, :m], torch.arange(1, m + 1))
    # the SA walk: the genome's value + m, or the value itself where the
    # walk passes the primary row (it ends on row 0 then)
    rows = np.arange(n + 1, dtype=np.int64)
    for s in (0, 1):
        va = native.sa_lookup(fa[s]._interleaved, fa[s].primary, fa[s].L2,
                              n, fa[s].sa_intv, fa[s].sa,
                              rows.astype(np.uint32))
        vb = native.sa_lookup(fb[s]._interleaved, fb[s].primary, fb[s].L2,
                              n + m, fb[s].sa_intv, fb[s].sa,
                              (rows + m).astype(np.uint32))
        add, kfin = walk.lf_walk_plain(ta, torch.full((n + 1,), s),
                                       torch.from_numpy(rows),
                                       fa[s].sa_intv - 1)
        via0 = (kfin.numpy() == 0) & (add.numpy() > 0)
        assert via0.any() and (~via0).any()
        want = np.where(via0, va, (va.astype(np.int64) + m) & MASK)
        np.testing.assert_array_equal(vb, want)


def test_lift_bounds(small):
    n = _fms(small)[0].seq_len
    assert tall_table.lift_m("straddle", n) == HIGH - (1 << 14)
    assert tall_table.lift_m("straddle", 32_000_000) == HIGH - (1 << 24)
    top = tall_table.lift_m("top", n)
    assert n + top == tall_table.TOP_SEQ_LEN == 2 ** 32 - 2
    for bad in (100, 0, top + 128):
        with pytest.raises(ValueError):
            tall_table.check_m(bad, n)


# ---- fm_row.cuh through the stand-in, rows computed on the fly --

FM_ROW_PROBE = r"""
#include <cstdint>
#include "cuda_runtime.h"
#include "fm_row.cuh"
using namespace ibwa_fm;

// A lifted table's rows (intv 64), made when asked for: a strand's first
// pad rows are padding (row i counts 64 i A's before it, its text all A),
// the rest the genome's row i - pad with m more A's before it.
struct LiftRows {
  const uint32_t* small;   // the genome's table, [2 * small_blk][8]
  uint32_t small_blk, pad, n_blk, m;
  uint32_t (*buf)[8];
  int* next;
  uint64_t* asked;
  template <int ROWW>
  const uint32_t* row(uint64_t r) const {
    *asked = r;
    uint32_t* b = buf[(*next)++ & 3];
    const uint64_t s = r / n_blk, i = r % n_blk;
    for (int j = 0; j < 8; ++j) b[j] = 0;
    if (i < pad) {
      b[0] = (uint32_t)(i * 64);
    } else {
      const uint32_t* g = small + (s * small_blk + (i - pad)) * 8;
      for (int j = 0; j < 8; ++j) b[j] = g[j];
      b[0] += m;
    }
    return b;
  }
};

extern "C" void probe(const uint32_t* small, uint32_t small_blk,
                      uint32_t pad, uint32_t n_blk, uint32_t m,
                      const uint32_t* prim, uint32_t seq_len,
                      const uint32_t* l2d_in, int n, const uint32_t* ks,
                      const uint32_t* strands, uint64_t* out) {
  uint32_t buf[4][8];
  int next = 0;
  uint64_t asked = 0;
  LiftRows src{small, small_blk, pad, n_blk, m, buf, &next, &asked};
  uint32_t l2d[4] = {l2d_in[0], l2d_in[1], l2d_in[2], l2d_in[3]};
  alignas(16) uint32_t pair[kPairWords];
  for (int q = 0; q < n; ++q) {
    uint64_t* o = out + 16 * q;
    const uint32_t k = ks[q], s = strands[q];
    OccRow<4> r;
    fetch_occ_row<4>(src, k, prim[s], seq_len, n_blk, s, r);
    o[0] = asked;
    o[1] = r.off;
    o[2] = r.neg;
    o[3] = r.full;
    uint32_t c4[4];
    occ_count4<4>(r, l2d, c4);
    for (int c = 0; c < 4; ++c) o[4 + c] = c4[c];
    for (int c = 0; c < 4; ++c) o[8 + c] = occ_count<4>(r, c, l2d);
    // the pair asked ahead for (k, k): every lane of the warp that copies
    for (int lane = 0; lane < 32; ++lane)
      prefetch_pair<4>(src, k, k, prim[s], seq_len, n_blk, s, pair, lane);
    copy_async_wait();
    OccRow<4> p0, p1;
    take_pair<4>(pair, k, k, prim[s], seq_len, n_blk, p0, p1);
    uint32_t d4[4], e4[4];
    occ_count4<4>(p0, l2d, d4);
    occ_count4<4>(p1, l2d, e4);
    for (int c = 0; c < 4; ++c) o[12 + c] = d4[c] == e4[c] ? d4[c] : ~0u;
  }
}

// FlatRows and ShardRows addresses (as offsets from the bases) and
// shards_ok, for rows r of a table of `rows_total` rows in 2 ranges.
extern "C" int addresses(int n, const uint64_t* rs, int64_t rows_total,
                         uint64_t* flat_off, uint64_t* shard_off,
                         int64_t* shard_of) {
  static const uint32_t base_words[2] = {0, 0};
  IbwaShards sh{};
  sh.n = 2;
  sh.rows = (rows_total + 1) / 2;
  sh.base[0] = base_words;
  sh.base[1] = base_words + 1;
  if (!shards_ok(sh, rows_total)) return 1;
  IbwaShards short_sh = sh;
  short_sh.rows = rows_total / 2 - 1;
  if (shards_ok(short_sh, rows_total)) return 2;
  const FlatRows flat{base_words};
  const ShardRows shard = ShardRows::of(nullptr, sh);
  for (int i = 0; i < n; ++i) {
    flat_off[i] = ((uintptr_t)flat.row<8>(rs[i]) - (uintptr_t)base_words) / 4;
    const uint64_t q = rs[i] / (uint64_t)sh.rows;
    shard_of[i] = (int64_t)q;
    shard_off[i] =
        ((uintptr_t)shard.row<8>(rs[i]) - (uintptr_t)sh.base[q]) / 4;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def fm_row_probe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build fm_row.cuh with")
    out = tmp_path_factory.mktemp("fm_row_probe")
    cpp = out / "probe.cpp"
    cpp.write_text(standin_source(FM_ROW_PROBE))
    so = out / "libprobe.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(STANDIN), "-I", str(CSRC), "-o", str(so), str(cpp)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.probe.restype = None
    lib.addresses.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _lift_queries(m: int, small_fm: tdev.DeviceFmPair, rng) -> np.ndarray:
    """The k of module 3: 0, m and its neighbours, 2^31 and its, primary'
    and its (both strands), seq_len' - 1, seq_len', 2^32 - 2 where it is
    seq_len', NEG1, and random rows."""
    top = small_fm.seq_len + m
    ks = {0, 1, m - 1, m, m + 1, HIGH - 1, HIGH, HIGH + 1, top - 1, top,
          NEG1}
    for p in small_fm.primary.tolist():
        ks |= {p + m - 1, p + m, p + m + 1}
    ks = np.array(sorted(k for k in ks if k <= top or k == NEG1),
                  dtype=np.int64)
    return np.concatenate([ks, rng.integers(0, top + 1, 400)])


@pytest.mark.parametrize("lift", tall_table.LIFTS)
def test_fm_row_above_2_31(small, fm_row_probe, lift):
    fms = _fms(small)
    sfm = tdev.build_device_pair(*fms, "cpu", intv=64)
    m = tall_table.lift_m(lift, sfm.seq_len)
    seq_len = sfm.seq_len + m
    pad = m // 64
    n_blk = -(-seq_len // 64)
    prim = np.array(sfm.primary.tolist(), dtype=np.uint32) + np.uint32(m)
    l2d = (sfm.l2diff + torch.tensor([m, 0, 0, 0])).numpy().astype(
        np.uint32)
    rng = np.random.default_rng(2031)
    ks = _lift_queries(m, sfm, rng)
    strand = np.arange(len(ks)) % 2
    small_rows = np.ascontiguousarray(sfm.blocks.numpy().view(np.uint32))
    out = np.zeros((len(ks), 16), dtype=np.uint64)
    ks32, st32 = ks.astype(np.uint32), strand.astype(np.uint32)
    fm_row_probe.probe(_ptr(small_rows), sfm.n_blk, pad, n_blk, m,
                       _ptr(prim), seq_len, _ptr(l2d), len(ks), _ptr(ks32),
                       _ptr(st32), _ptr(out))
    # the plain twins: the genome's own occ4 at k - m, raised by m in A's
    # column; k < m counts k + 1 A's; NEG1 nothing; seq_len' the totals
    pr = prim.astype(np.int64)[strand]
    kk = np.minimum(ks - (ks >= pr), seq_len - 1)
    want_row = strand * n_blk + np.minimum(kk >> 6, n_blk - 1)
    np.testing.assert_array_equal(out[:, 0], want_row)
    np.testing.assert_array_equal(out[:, 1], kk & 63)
    np.testing.assert_array_equal(out[:, 2], ks == NEG1)
    np.testing.assert_array_equal(out[:, 3], ks == seq_len)
    inner = (ks >= m) & (ks != NEG1)
    occ = tdev.occ4_plain(sfm, torch.from_numpy(strand),
                          torch.from_numpy(np.where(inner, ks - m, 0)))
    want = occ.numpy() + np.array([m, 0, 0, 0])
    pad_cnt = np.zeros((len(ks), 4), dtype=np.int64)
    pad_cnt[:, 0] = ks + 1
    want = np.where(inner[:, None], want, pad_cnt)
    want[ks == NEG1] = 0
    for cols in (slice(4, 8), slice(8, 12), slice(12, 16)):
        np.testing.assert_array_equal(out[:, cols], want)
    assert ((ks >= HIGH) & (ks != NEG1)).any()
    assert lift == "straddle" or (want[:, 0] >= HIGH).any()
    # addresses of the table's 2 * n_blk rows, flat and split in two
    rows_total = 2 * n_blk
    rs = np.array([0, HIGH >> 6, rows_total // 2 - 1, rows_total // 2,
                   (rows_total + 1) // 2, rows_total - 1], dtype=np.uint64)
    flat_off = np.zeros(len(rs), np.uint64)
    shard_off = np.zeros(len(rs), np.uint64)
    shard_of = np.zeros(len(rs), np.int64)
    assert fm_row_probe.addresses(len(rs), _ptr(rs),
                                  ctypes.c_int64(rows_total), _ptr(flat_off),
                                  _ptr(shard_off), _ptr(shard_of)) == 0
    half = (rows_total + 1) // 2
    np.testing.assert_array_equal(flat_off, rs * 8)
    np.testing.assert_array_equal(shard_of, rs // half)
    np.testing.assert_array_equal(shard_off, (rs % half) * 8)


# ---- aln and the walker on the straddle lift of a poly-A genome --

@pytest.fixture(scope="module")
def straddle(tmp_path_factory):
    """A 1.04 Mbp genome (a 400 kbp contig; a contig of 20 kbp, 600 kbp of
    A and 20 kbp), its straddle lift, and 64 simulated reads (one
    substitution each, every other one reverse-complemented) followed by
    the poly-A reads."""
    tmp = tmp_path_factory.mktemp("tall_straddle")
    rng = np.random.default_rng(1917)
    c1 = _random(rng, 400_000)
    c2 = _random(rng, 20_000) + "A" * 600_000 + _random(rng, 20_000)
    fa = tmp / "g.fa"
    _write_fa(fa, [("c1", c1), ("c2", c2)])
    builder.bwa_index(str(fa))
    lift = str(tmp / "lift")
    m = tall_table.lift_m("straddle", 1_040_000)
    assert m == HIGH - (1 << 19)
    rep = tall_table.lift(str(fa), lift, m)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(64):
        p = int(rng.integers(0, len(c1) - 100))
        s = list(c1[p:p + 100])
        j = int(rng.integers(0, 100))
        s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
        s = "".join(s)
        reads.append(s.translate(comp)[::-1] if i % 2 else s)
    reads += [*PROBES, c2[19_950:20_000] + "A" * 50]
    fq = tmp / "r.fq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                          for i, s in enumerate(reads)))
    return lift, str(fq), rep, tmp


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kw)


def _port_sai(prefix, fq, route: str, wide: bool = False) -> bytes:
    buf = io.BytesIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "DEV_BATCH", LANES)
        mp.setenv("IBWA_HOST_FRAC", "0")
        if wide:
            for name, v in WIDE_CAPS.items():
                mp.setattr(engine, name, v)
        _quiet(t_pipeline.aln_to_stream, prefix, fq, GapOpt(), buf,
               engine=route, device="cpu")
    gc.collect()
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_sai(straddle):
    """ibwa_tpu's JAX engine on the lift, every read on its device search
    (one CPU device, 128-base rows: the table once, the .sai does not
    depend on the rows' width), as its pipeline writes the .sai."""
    lift, fq = straddle[:2]
    fms = tuple(JFmIndex(j_load_index(lift, s)) for s in (0, 1))
    reads = j_load_reads(fq)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IBWA_DEV_INTV", "128")
        mp.setenv("IBWA_HOST_FRAC", "0")
        mp.setattr(engine_jax, "PALLAS_STACK", False)
        mp.setattr(engine_jax, "DEV_BATCH", LANES)
        mp.setattr(engine_jax, "PERSIST_N", 640)
        for name, v in WIDE_CAPS.items():
            mp.setattr(engine_jax, name, v)
        eng = engine_jax.JaxAlnEngine(fms, devices=jax.devices()[:1])
        hits = _quiet(eng.align_batch, [r.seq for r in reads],
                      [r.rseq for r in reads], JGapOpt())
        fallback = eng.stats["fallback_reads"]
    buf = io.BytesIO()
    j_sai.write_header(buf, JGapOpt())
    for h in hits:
        j_sai.write_read_hits(buf, h)
    del eng, fms
    gc.collect()
    return buf.getvalue(), fallback


def _hits(path):
    return list(iter_sai(str(path)))


def test_straddle_sai_equals_jax(straddle, jax_sai):
    lift, fq, rep, tmp = straddle
    want, fallback = jax_sai
    assert fallback == 0
    assert rep["seq_len"] > HIGH > rep["m"]
    for route, wide in (("torch", False), ("torch", True), ("native", False)):
        assert _port_sai(lift, fq, route, wide) == want, (route, wide)
    (tmp / "want.sai").write_bytes(want)
    hits = _hits(tmp / "want.sai")
    assert sum(h.k >= HIGH for hs in hits for h in hs) > 0
    # the read of 100 A's: an exact hit of more than 2^31 rows, and the
    # hits of one mismatch that the int best_cnt lets in after it
    poly = hits[64]
    assert poly[0].n_mm == 0 and poly[0].l - poly[0].k + 1 > HIGH
    assert len(poly) > 1 and all(h.n_mm == 1 for h in poly[1:])


@pytest.mark.xfail(strict=True, reason=(
    "ibwa_tpu/native/src/core.cpp:1270 sums best_cnt in a long long, where "
    "bwtgap.c's is an int and ibwa_tpu's JAX engine wraps it in int32 "
    "(align/engine_jax.py:386-388, :665): after the exact hit of 2^31 rows "
    "and more it stops at the first worse hit, the engine does not"))
def test_jax_native_equals_its_engine(straddle, jax_sai):
    lift, fq = straddle[:2]
    buf = io.BytesIO()
    from ibwa_tpu.align import pipeline as j_pipeline
    _quiet(j_pipeline.aln_to_stream, lift, fq, JGapOpt(), buf,
           engine="native")
    assert buf.getvalue() == jax_sai[0]


def test_walker_plain_above_2_31(straddle, jax_sai):
    lift, fq, rep, tmp = straddle
    fms = _fms(lift)
    seq_len = rep["seq_len"]
    # the .sai's intervals of at most 256 rows (walker strand 1 - a), and
    # random intervals of 1 to 4 rows at and above 2^31
    (tmp / "want.sai").write_bytes(jax_sai[0])
    iv = [(1 - h.a, h.k, h.l) for hs in _hits(tmp / "want.sai")
          for h in hs if h.l - h.k < tall_table.WALK_MAX_WIDTH]
    rng = np.random.default_rng(2032)
    ks = rng.integers(HIGH, seq_len + 1, 2000)
    ls = np.minimum(ks + rng.integers(0, 4, len(ks)), seq_len)
    strand = np.concatenate([[s for s, _, _ in iv],
                             rng.integers(0, 2, len(ks))]).astype(np.uint32)
    ks = np.concatenate([[k for _, k, _ in iv], ks]).astype(np.uint32)
    ls = np.concatenate([[l for _, _, l in iv], ls]).astype(np.uint32)
    walker = walk.DeviceWalker(fms[0], fms[1], "cpu")
    off, vals = walker.resolve_intervals(strand, ks, ls)
    rows = np.concatenate([np.arange(k, l + 1, dtype=np.int64)
                           for k, l in zip(ks.tolist(), ls.tolist())])
    row_strand = np.repeat(strand, ls.astype(np.int64) - ks + 1)
    want = np.empty(len(rows), dtype=np.uint32)
    for s in (0, 1):
        f, sel = fms[s], row_strand == s
        want[sel] = native.sa_lookup(f._interleaved, f.primary, f.L2,
                                     seq_len, f.sa_intv, f.sa,
                                     rows[sel].astype(np.uint32))
    np.testing.assert_array_equal(vals, want)
    assert len(iv) > 0 and (rows >= HIGH).sum() > 0
    assert (vals >= HIGH).sum() > 0


def test_lift_without_jax(small, tmp_path):
    """The module in a process where jax, ibwa_tpu and bench cannot be
    imported: a lift, the probe FASTQ and the .sai's hits as arrays."""
    import os
    import sys

    from conftest import REPO
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\nACGT\n+\nIIII\n")
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'ibwa_tpu', 'bench')\n"
        "for m in BLOCKED:\n"
        "    sys.modules[m] = None\n"
        "import pathlib\n"
        "from ibwa_tpu_torch import tall_table\n"
        f"rep = tall_table.lift({small!r}, {str(tmp_path / 'lift')!r}, "
        f"{SMALL_M})\n"
        f"assert rep['seq_len'] == {SMALL_BP + SMALL_M}, rep\n"
        f"out = tall_table.probe_fastq({str(fq)!r}, "
        f"pathlib.Path({str(tmp_path / 'p.fq')!r}))\n"
        "assert out.read_text().count('@') == len(tall_table.PROBE_READS) "
        "+ 1\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None "
        "and m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
