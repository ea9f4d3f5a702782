"""The port's LF walker (`ibwa_tpu_torch/fm/walk.py`) against ibwa_tpu's.

`lf_step_plain` against `_lf_step` for one step, `lf_walk_plain`'s
(add, kfin) against `_lf_walk`'s, and `DeviceWalker.resolve` against the
JAX `DeviceWalker.resolve` and the host walk `FmIndex.sa_at`, at block
intervals 32, 64 and 128.  The state is carried as numpy arrays by
`convert.py`.  Exact comparison: this is integer arithmetic, and it wraps
mod 2^32 (the sampled array stores sa[0] = 0xFFFFFFFF).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ibwa_tpu.fm import device as jdev
from ibwa_tpu.fm import walk as jwalk
from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index import builder

from ibwa_tpu_torch import convert
from ibwa_tpu_torch.fm import walk as twalk

from conftest import make_genome

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
def test_device_walker_matches_jax_and_host(walk_index, intv, monkeypatch):
    fms = walk_index
    # 3 dispatches, the last one ragged
    monkeypatch.setenv("IBWA_WALK_LANES", "256")
    strand, rows = _queries(fms, 600, 41 + intv)
    jw = jwalk.DeviceWalker(fms[0], fms[1])
    jw.fm = jdev.build_device_pair(fms[0], fms[1], dimer=False, intv=intv)
    jnp_fm = jdev.build_device_pair(fms[0], fms[1], put=np.asarray,
                                    dimer=False, intv=intv)
    tw = convert.walker_from_numpy(jnp_fm, jw.sampled, jw.sa_intv)
    assert tw.lanes == 256
    got = tw.resolve(strand, rows)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jw.resolve(strand, rows))
    np.testing.assert_array_equal(got, _host_sa(fms, strand, rows))


def test_device_walker_from_port_index(walk_index):
    """`DeviceWalker(fwd, rev, "cpu")` over the port's own FmIndex (carried
    by `fmindex_from_jax`) resolves the edge rows like the host walk, and
    the wrap of `add + sampled[0]` (0xFFFFFFFF) is exercised."""
    fms = walk_index
    pfms = tuple(convert.fmindex_from_jax(f) for f in fms)
    assert pfms[0].sa[0] == 0xFFFFFFFF
    tw = twalk.DeviceWalker(pfms[0], pfms[1], "cpu")
    assert tw.fm.intv == 64 and tw.lanes == twalk.WALK_LANES
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
