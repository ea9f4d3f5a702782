"""ibwa_tpu_torch's FM block table and occ twins against ibwa_tpu's.

The block table must be byte-equal to `ibwa_tpu.fm.device.build_device_pair`
for every block interval, and the plain occ twins (the CPU side of
kernel K2) must equal JAX's occ4/occ1 at random and edge k: NEG1, 0,
primary +- 1, seq_len - 1, seq_len and block boundaries.  Exact
comparison: this is integer arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ibwa_tpu.align import engine_ref
from ibwa_tpu.fm import device as jdev
from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index import builder

from ibwa_tpu_torch import convert, u32
from ibwa_tpu_torch.fm import device as tdev

from conftest import make_genome

# small tensors: one intra-op thread (the suite runs files in parallel
# workers, and more threads only spin)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def occ_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tocc")
    fa = tmp / "g.fa"
    make_genome(fa, [("c1", "", 20000, 0.0), ("c2", "", 7001, 0.0)],
                seed=903)
    builder.bwa_index(str(fa))
    return (FmIndex(builder.load_index(str(fa), 0)),
            FmIndex(builder.load_index(str(fa), 1)))


def _queries(fms, seed):
    n = fms[0].seq_len
    ks = [0, 1, 15, 16, 31, 32, 63, 64, 127, 128, n - 1, n, u32.NEG1]
    for fm in fms:
        p = fm.primary
        ks += [p - 1, p, p + 1]
    rng = np.random.default_rng(seed)
    ks = np.concatenate([rng.integers(0, n + 1, 400),
                         np.array(ks, dtype=np.int64)]) & u32.MASK
    strand = np.arange(len(ks)) % 2
    return strand.astype(np.int64), ks.astype(np.int64), rng


@pytest.mark.parametrize("intv", [32, 64, 128])
def test_blocks_byte_equal(occ_index, intv):
    fwd, rev = occ_index
    want = jdev.build_device_pair(fwd, rev, put=np.asarray, dimer=False,
                                  intv=intv)
    got = tdev.build_device_pair(fwd, rev, "cpu", intv=intv)
    assert got.blocks.numpy().tobytes() == \
        np.asarray(want.blocks, dtype=np.uint32).tobytes()
    assert (got.n_blk, got.seq_len, got.intv) == \
        (want.n_blk, want.seq_len, want.intv)
    np.testing.assert_array_equal(got.L2.numpy(), want.L2)
    np.testing.assert_array_equal(got.l2diff.numpy(), want.l2diff)
    np.testing.assert_array_equal(got.primary.numpy(), want.primary)
    # convert.fm_from_numpy carries the JAX-side table over unchanged
    conv = convert.fm_from_numpy(want)
    assert torch.equal(conv.blocks, got.blocks)
    assert torch.equal(conv.l2diff, got.l2diff)


@pytest.mark.parametrize("intv", [32, 64, 128])
def test_occ_twins_match_jax(occ_index, intv):
    fwd, rev = occ_index
    jfm = jdev.build_device_pair(fwd, rev, dimer=False, intv=intv)
    tfm = tdev.build_device_pair(fwd, rev, "cpu", intv=intv)
    strand, ks, rng = _queries(occ_index, 7 + intv)
    cs = rng.integers(0, 4, len(ks))
    want4 = np.asarray(jdev.occ4(jfm, jnp.asarray(strand, jnp.uint32),
                                 jnp.asarray(ks, jnp.uint32)))
    got4 = tdev.occ4_plain(tfm, torch.from_numpy(strand),
                           torch.from_numpy(ks))
    np.testing.assert_array_equal(got4.numpy(), want4.astype(np.int64))
    want1 = np.asarray(jdev.occ1(jfm, jnp.asarray(strand, jnp.uint32),
                                 jnp.asarray(ks, jnp.uint32),
                                 jnp.asarray(cs, jnp.uint32)))
    got1 = tdev.occ1_plain(tfm, torch.from_numpy(strand),
                           torch.from_numpy(ks), torch.from_numpy(cs))
    np.testing.assert_array_equal(got1.numpy(), want1.astype(np.int64))


def test_occ_pairs_ask_k_minus_1_and_l(occ_index):
    """occ4_pair / occ1_pair on CPU tensors: counts at (k - 1, l), with
    k == 0 asking NEG1 (the u32 wrap the search depends on)."""
    fwd, rev = occ_index
    jfm = jdev.build_device_pair(fwd, rev, dimer=False, intv=64)
    tfm = tdev.build_device_pair(fwd, rev, "cpu", intv=64)
    strand, ks, rng = _queries(occ_index, 11)
    ks = np.minimum(ks, fwd.seq_len)            # a bound, not NEG1
    ls = rng.integers(0, fwd.seq_len + 1, len(ks)).astype(np.int64)
    cs = rng.integers(0, 4, len(ks)).astype(np.int64)
    kl = np.stack([(ks - 1) & u32.MASK, ls], axis=-1)
    js = jnp.asarray(strand[:, None], jnp.uint32)
    want4 = np.asarray(jdev.occ4(jfm, js, jnp.asarray(kl, jnp.uint32)))
    want1 = np.asarray(jdev.occ1(jfm, js, jnp.asarray(kl, jnp.uint32),
                                 jnp.asarray(cs[:, None], jnp.uint32)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got4 = tdev.occ4_pair(tfm, t(strand), t(ks), t(ls))
    got1 = tdev.occ1_pair(tfm, t(strand), t(ks), t(ls), t(cs))
    np.testing.assert_array_equal(got4.numpy(), want4.astype(np.int64))
    np.testing.assert_array_equal(got1.numpy(), want1.astype(np.int64))


def test_u32_helpers():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 1 << 32, 1000),
                        [0, 1, 0xFFFFFFFF, 0x80000000]]).astype(np.int64)
    tx = torch.from_numpy(x)
    assert u32.popcount(tx).tolist() == [bin(int(v)).count("1") for v in x]
    assert u32.wrap_i32(tx).numpy().tolist() == \
        x.astype(np.uint32).view(np.int32).tolist()
    assert torch.equal(u32.from_bits(u32.to_bits(tx)), tx)
    nb = torch.arange(1, 17)
    want = [~((1 << ((16 - n) * 2)) - 1) & 0xFFFFFFFF for n in range(1, 17)]
    assert u32.partial_mask(nb).tolist() == want
    v = torch.arange(0, 40)
    assert u32.int_log2(v, 39).tolist() == \
        [engine_ref._int_log2(int(i)) for i in range(40)]
