"""The port's LF walker (`ibwa_tpu_torch/fm/walk.py`) against ibwa_tpu's.

`lf_step_plain` against `_lf_step` for one step, `lf_walk_plain`'s
(add, kfin) against `_lf_walk`'s, `DeviceWalker.resolve` against the JAX
`DeviceWalker.resolve` and the host walk `FmIndex.sa_at`, and
`resolve_intervals_plain` (through `DeviceWalker.resolve_intervals`)
against `_lf_walk` + the host lookup and the native `sa_lookup` on
intervals of width 1 and wide ones, at block intervals 32, 64 and 128.
K5's source, `csrc/lf_walk.cu`, built with g++ over the CUDA stand-in
(`tests/cuda_standin`), against the plain version, on grids far smaller
than the rows.  The state is carried as numpy arrays by `convert.py`.
Exact comparison: this is integer arithmetic, and it wraps mod 2^32 (the
sampled array stores sa[0] = 0xFFFFFFFF).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ibwa_tpu.fm import device as jdev
from ibwa_tpu.fm import walk as jwalk
from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index import builder

from ibwa_tpu_torch import convert, kernels, native
from ibwa_tpu_torch.fm import walk as twalk

from conftest import make_genome
from test_torch_chunk import CSRC, STANDIN, standin_source

torch.set_num_threads(1)

INTVS = [32, 64, 128]


@pytest.fixture(scope="module")
def walk_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("twalk")
    fa = tmp / "g.fa"
    make_genome(fa, [("c1", "", 30000, 0.0), ("c2", "", 12000, 0.0)],
                seed=516)
    builder.bwa_index(str(fa))
    return (FmIndex(builder.load_index(str(fa), 0)),
            FmIndex(builder.load_index(str(fa), 1)))


def _edge_rows(fms):
    """Rows on and next to sampled slots and block boundaries, the
    primary rows (k == primary -> 0, a sampled row) and their neighbours
    (the sentinel skip is k > primary), and k = seq_len (the clamp)."""
    n, intv = fms[0].seq_len, fms[0].sa_intv
    ks = [1, 15, 16, 17, 31, 33, 63, 65, 127, 129, n - 1, n]
    for base in (0, intv, 7 * intv, n // intv * intv):
        ks += [base - 1, base, base + 1]
    for fm in fms:
        ks += [fm.primary - 1, fm.primary, fm.primary + 1]
    ks = [k for k in ks if 0 <= k <= n]
    rows = np.array(ks * 2, dtype=np.uint32)
    strand = np.array([0] * len(ks) + [1] * len(ks), dtype=np.uint32)
    return strand, rows


def _queries(fms, n, seed):
    rng = np.random.default_rng(seed)
    es, ek = _edge_rows(fms)
    rows = np.concatenate(
        [rng.integers(0, fms[0].seq_len + 1, n).astype(np.uint32), ek])
    strand = np.concatenate([rng.integers(0, 2, n).astype(np.uint32), es])
    return strand, rows


def _host_sa(fms, strand, rows):
    return np.array([fms[int(s)].sa_at(int(k)) & 0xFFFFFFFF
                     for s, k in zip(strand, rows)], dtype=np.uint32)


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _pair(fms, intv):
    """The JAX table (device arrays), and the port's made from the same
    table's numpy fields."""
    jfm = jdev.build_device_pair(fms[0], fms[1], dimer=False, intv=intv)
    jnp_fm = jdev.build_device_pair(fms[0], fms[1], put=np.asarray,
                                    dimer=False, intv=intv)
    return jfm, convert.fm_from_numpy(jnp_fm)


@pytest.mark.parametrize("intv", INTVS)
def test_lf_step_plain_matches_jax(walk_index, intv):
    fms = walk_index
    jfm, tfm = _pair(fms, intv)
    strand, rows = _queries(fms, 600, 21 + intv)
    want = np.asarray(jwalk._lf_step(jfm, jnp.asarray(strand),
                                     jnp.asarray(rows)))
    got = twalk.lf_step_plain(tfm, _t64(strand), _t64(rows))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the step agrees with the host's inverse-psi too
    host = np.array([fms[int(s)].inv_psi(int(k))
                     for s, k in zip(strand, rows)], dtype=np.int64)
    np.testing.assert_array_equal(got.numpy(), host & 0xFFFFFFFF)


@pytest.mark.parametrize("intv", INTVS)
def test_lf_walk_plain_matches_jax(walk_index, intv):
    fms = walk_index
    jfm, tfm = _pair(fms, intv)
    strand, rows = _queries(fms, 600, 31 + intv)
    mask = fms[0].sa_intv - 1
    jadd, jk = jwalk._lf_walk(jfm.blocks, jfm.L2, jfm.l2diff, jfm.primary,
                              jnp.asarray(strand), jnp.asarray(rows),
                              seq_len=jfm.seq_len, n_blk=jfm.n_blk,
                              intv_mask=mask, blk_intv=jfm.intv)
    add, kfin = twalk.lf_walk_plain(tfm, _t64(strand), _t64(rows), mask)
    np.testing.assert_array_equal(add.numpy(),
                                  np.asarray(jadd).astype(np.int64))
    np.testing.assert_array_equal(kfin.numpy(),
                                  np.asarray(jk).astype(np.int64))
    assert int((kfin & mask).max()) == 0         # every lane retired
    # the wrapper sends a CPU table to the plain version
    add2, kfin2 = twalk.lf_walk(tfm, _t64(strand), _t64(rows), mask)
    assert torch.equal(add2, add) and torch.equal(kfin2, kfin)


@pytest.mark.parametrize("intv", INTVS)
def test_device_walker_matches_jax_and_host(walk_index, intv):
    fms = walk_index
    strand, rows = _queries(fms, 600, 41 + intv)
    jw = jwalk.DeviceWalker(fms[0], fms[1])
    jw.fm = jdev.build_device_pair(fms[0], fms[1], dimer=False, intv=intv)
    jnp_fm = jdev.build_device_pair(fms[0], fms[1], put=np.asarray,
                                    dimer=False, intv=intv)
    tw = convert.walker_from_numpy(jnp_fm, jw.sampled, jw.sa_intv)
    got = tw.resolve(strand, rows)
    assert got.dtype == np.uint32
    assert tw.last["waves"] == 1 and tw.last["rows"] == len(rows)
    want = jw.resolve(strand, rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host_sa(fms, strand, rows))
    # 3 waves, the last one ragged: the same values
    off, waved = tw.resolve_intervals(strand, rows, rows, wave_rows=256)
    assert tw.last["waves"] == 3 and tw.last["launches"] == 0
    np.testing.assert_array_equal(off, np.arange(len(rows) + 1))
    np.testing.assert_array_equal(waved, want)


def _intervals(fms, seed):
    """Intervals from a seed: widths 1 to 40 and a few of 200-700 rows,
    both strands, and width-1 and wide ones on the edges: row 0, the
    primary rows, seq_len.  (strand, ks, ls) as uint32."""
    rng = np.random.default_rng(seed)
    n = fms[0].seq_len
    w = np.concatenate([rng.integers(1, 41, 160), rng.integers(200, 700, 4)])
    ks = rng.integers(0, n + 1 - w)
    es, ek = _edge_rows(fms)
    wide = [0, fms[0].primary - 3, fms[1].primary - 40, n - 99]
    ks = np.concatenate([ks, ek, wide])
    ls = np.concatenate([ks[:len(w)] + w - 1, ek, [40, fms[0].primary + 3,
                                                    fms[1].primary, n]])
    strand = np.concatenate([rng.integers(0, 2, len(w)), es, [0, 0, 1, 1]])
    order = rng.permutation(len(ks))
    return (strand[order].astype(np.uint32), ks[order].astype(np.uint32),
            ls[order].astype(np.uint32))


def _rows_of(strand, ks, ls):
    widths = ls.astype(np.int64) - ks + 1
    rows = np.concatenate([np.arange(k, l + 1) for k, l in zip(ks, ls)])
    return np.repeat(strand, widths), rows.astype(np.uint32)


@pytest.mark.parametrize("intv", INTVS)
def test_resolve_intervals_plain_matches_jax_and_native(walk_index, intv):
    """Every row of seeded intervals: the plain version against ibwa_tpu's
    walk plus the host lookup, and against the port's native sa_lookup."""
    fms = walk_index
    strand, ks, ls = _intervals(fms, 51 + intv)
    jnp_fm = jdev.build_device_pair(fms[0], fms[1], put=np.asarray,
                                    dimer=False, intv=intv)
    tw = convert.walker_from_numpy(jnp_fm, (fms[0].sa, fms[1].sa),
                                   fms[0].sa_intv)
    off, got = tw.resolve_intervals(strand, ks, ls)
    rs, rows = _rows_of(strand, ks, ls)
    assert off[-1] == len(rows) == tw.last["rows"] and got.dtype == np.uint32
    assert (np.diff(off) == ls.astype(np.int64) - ks + 1).all()
    assert (np.diff(off) >= 200).sum() == 4 and (np.diff(off) == 1).sum() > 10
    jfm = jdev.build_device_pair(fms[0], fms[1], dimer=False, intv=intv)
    mask = fms[0].sa_intv - 1
    jadd, jk = jwalk._lf_walk(jfm.blocks, jfm.L2, jfm.l2diff, jfm.primary,
                              jnp.asarray(rs), jnp.asarray(rows),
                              seq_len=jfm.seq_len, n_blk=jfm.n_blk,
                              intv_mask=mask, blk_intv=jfm.intv)
    jadd, slot = np.asarray(jadd), np.asarray(jk) >> 5
    want = (jadd + np.where(rs == 0, fms[0].sa[slot], fms[1].sa[slot])
            ).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert tw.last["steps"] == int(jadd.sum())
    assert tw.last["longest"] == int(jadd.max())
    for s in (0, 1):
        f = fms[s]
        sel = rs == s
        np.testing.assert_array_equal(
            got[sel], native.sa_lookup(f._interleaved, f.primary, f.L2,
                                       f.seq_len, f.sa_intv, f.sa,
                                       rows[sel]))


@pytest.fixture(scope="module")
def walk_standin(tmp_path_factory):
    """`csrc/lf_walk.cu` built with g++ over the stand-in header, loaded
    as `kernels.lib()` would load the nvcc build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source with")
    out = tmp_path_factory.mktemp("walk_standin")
    cpp = out / "lf_walk.cpp"
    cpp.write_text(standin_source((CSRC / "lf_walk.cu").read_text()))
    so = out / "libibwa_walk_standin.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(STANDIN), "-I", str(CSRC), "-o", str(so), str(cpp)],
                   check=True)
    handle = ctypes.CDLL(str(so))
    for entry in ("ibwa_lf_resolve", "ibwa_lf_walk"):
        fn = getattr(handle, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return handle


@pytest.mark.parametrize("intv,max_blocks", [(64, 0), (32, 1), (128, 2)])
def test_resolve_source_equals_plain(walk_index, walk_standin, monkeypatch,
                                     intv, max_blocks):
    """K5's persistent kernel, its queue and its interval search, run on
    the CPU through the stand-in, against `resolve_intervals_plain`:
    bitwise, on the stand-in card's 8 resident blocks (1,024 lanes) and on
    grids of 1 and 2 blocks, so that lanes take their second and later
    rows; the rows in one wave and in three, where a wave starts inside an
    interval."""
    fms = walk_index
    strand, ks, ls = _intervals(fms, 61 + intv)
    jnp_fm = jdev.build_device_pair(fms[0], fms[1], put=np.asarray,
                                    dimer=False, intv=intv)
    tw = convert.walker_from_numpy(jnp_fm, (fms[0].sa, fms[1].sa),
                                   fms[0].sa_intv)
    off, want = tw.resolve_intervals(strand, ks, ls)
    n = int(off[-1])
    iv = torch.from_numpy(np.stack([strand, ks]).view(np.int32))
    off_t = torch.from_numpy(off)
    monkeypatch.setattr(kernels, "lib", lambda: walk_standin)
    mask = fms[0].sa_intv - 1
    before = kernels.launches["lf_walk"]
    got, st = twalk._launch_resolve(tw.fm, tw.sampled, iv, off_t, 0, n, mask,
                                    0, max_blocks)
    assert kernels.launches["lf_walk"] == before + 1
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    queue, steps, longest = st.tolist()
    lanes = 128 * (max_blocks or 8)
    assert n > 3 * lanes and queue >= n
    assert (steps, longest) == (tw.last["steps"], tw.last["longest"])
    cut = [0, n // 3 + 5, 2 * n // 3 - 7, n]     # inside intervals
    waves = [twalk._launch_resolve(tw.fm, tw.sampled, iv, off_t, a, b, mask,
                                   0, max_blocks)[0]
             for a, b in zip(cut, cut[1:])]
    np.testing.assert_array_equal(
        torch.cat(waves).numpy().view(np.uint32), want)


def test_resolve_source_first_version(walk_index, walk_standin):
    """The first version's entry, kept for timing beside the new one:
    (add, kfin) through the stand-in equal to `lf_walk_plain`."""
    fms = walk_index
    _, tfm = _pair(fms, 64)
    strand, rows = _queries(fms, 300, 71)
    ts, tk = _t64(strand), _t64(rows)
    want = twalk.lf_walk_plain(tfm, ts, tk, 31)
    add = torch.empty(len(rows), dtype=torch.int64)
    kfin = torch.empty_like(add)
    rc = walk_standin.ibwa_lf_walk(
        tfm.blocks.data_ptr(), tfm.primary.data_ptr(), tfm.L2.data_ptr(),
        ts.data_ptr(), tk.data_ptr(), add.data_ptr(), kfin.data_ptr(),
        len(rows), tfm.seq_len, tfm.n_blk, 64, 31, None)
    assert rc == 0
    assert torch.equal(add, want[0]) and torch.equal(kfin, want[1])


def test_device_walker_from_port_index(walk_index):
    """`DeviceWalker(fwd, rev, "cpu")` over the port's own FmIndex (carried
    by `fmindex_from_jax`) resolves the edge rows like the host walk, and
    the wrap of `add + sampled[0]` (0xFFFFFFFF) is exercised."""
    fms = walk_index
    pfms = tuple(convert.fmindex_from_jax(f) for f in fms)
    assert pfms[0].sa[0] == 0xFFFFFFFF
    tw = twalk.DeviceWalker(pfms[0], pfms[1], "cpu")
    assert tw.fm.intv == 64
    assert tw.sampled.shape == (2, len(pfms[0].sa))
    assert tw.sampled.dtype == torch.int32
    strand, rows = _edge_rows(fms)
    got = tw.resolve(strand, rows)
    np.testing.assert_array_equal(got, _host_sa(fms, strand, rows))
    # a walk that ends on row 0 adds its steps to 0xFFFFFFFF and wraps
    add, kfin = twalk.lf_walk(tw.fm, _t64(strand), _t64(rows),
                              tw.sa_intv - 1)
    ends0 = (kfin == 0) & (add > 0)
    assert bool(ends0.any())
    np.testing.assert_array_equal(
        got[ends0.numpy()], (add[ends0].numpy() - 1).astype(np.uint32))


def test_lf_walk_rejects_bad_arguments(walk_index):
    fms = walk_index
    _, tfm = _pair(fms, 64)
    k = _t64([1, 2, 3])
    with pytest.raises(ValueError):
        twalk.lf_walk(tfm, k.to(torch.int32), k, 31)
    with pytest.raises(ValueError):
        twalk.lf_walk(tfm, k, k, 30)                 # not 2**s - 1
    with pytest.raises(ValueError):
        twalk.DeviceWalker.from_table(tfm, (fms[0].sa, fms[1].sa), 24)
    tw = twalk.DeviceWalker.from_table(tfm, (fms[0].sa, fms[1].sa), 32)
    one = np.array([5], dtype=np.uint32)
    with pytest.raises(ValueError, match="non-empty"):
        tw.resolve_intervals(one * 0, one, one - 1)  # l < k
    with pytest.raises(ValueError, match="non-empty"):
        tw.resolve_intervals(one * 2, one, one)      # no strand 2
    with pytest.raises(ValueError):
        twalk.lf_resolve(tfm, tw.sampled, torch.zeros((2, 1), dtype=torch.int64),
                         torch.zeros(2, dtype=torch.int64), 0, 1, 31)
    off, vals = tw.resolve_intervals(one[:0], one[:0], one[:0])
    assert off.tolist() == [0] and len(vals) == 0
