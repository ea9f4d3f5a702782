"""The port's dependent-gather probe against `scripts/bench_chase.py`.

`chase_plain` / `chase_plain_mw` (the plain versions of kernels K3 / K4,
and what a CPU table runs) must equal the JAX probe's `chase_xla` and its
two Pallas kernels, which run in interpret mode on the CPU as the script
itself runs them there.  Same table and start rows, made with numpy from
a seed.  Exact comparison: this is integer arithmetic.
"""

import importlib.util

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibwa_tpu_torch import bench_chase as tchase

from conftest import REPO

torch.set_num_threads(1)

N_ROWS, ROWW, LANES, STEPS = 4096, 128, 64, 16


@pytest.fixture(scope="module")
def jchase():
    """scripts/bench_chase.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_chase", REPO / "scripts" / "bench_chase.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(jchase):
    table = jchase.make_table(N_ROWS, ROWW, seed=5)
    # high bits set in the words the chain reads: the remainder must be
    # unsigned, and the xor bitwise on the int32 pattern
    table[::3, 0] |= np.uint32(0x80000000)
    table[::5, 1] |= np.uint32(0xC0000000)
    idx0 = np.random.default_rng(1).integers(0, N_ROWS, LANES,
                                             dtype=np.int32)
    return table, idx0


def _torch_args(table, idx0):
    return (torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx0))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_table_matches(jchase):
    np.testing.assert_array_equal(tchase.make_table(512, 8, seed=3),
                                  jchase.make_table(512, 8, seed=3))
    t = tchase.make_table_device(1000, 8, 7, "cpu")
    assert t.dtype == torch.int32 and t.shape == (1000, 8)
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    assert torch.equal(t, tchase.make_table_device(1000, 8, 7, "cpu"))


def test_chase_plain_matches_xla(jchase, inputs):
    table, idx0 = inputs
    want = jchase.chase_xla(jnp.asarray(table), jnp.asarray(idx0), STEPS,
                            N_ROWS)
    tt, ti = _torch_args(table, idx0)
    _same(tchase.chase_plain(tt, ti, STEPS, N_ROWS), want)
    # the wrapper sends a CPU table to the plain version
    _same(tchase.chase(tt, ti, STEPS, N_ROWS), want)


def test_chase_plain_matches_pallas(jchase, inputs):
    table, idx0 = inputs
    want = jchase.chase_pallas(jnp.asarray(table), jnp.asarray(idx0), STEPS,
                               N_ROWS)
    _same(tchase.chase_plain(*_torch_args(table, idx0), STEPS, N_ROWS), want)


@pytest.mark.parametrize("waves", [1, 4])
def test_chase_plain_mw_matches_xla_and_pallas(jchase, inputs, waves):
    table, idx0 = inputs
    jt, ji = jnp.asarray(table), jnp.asarray(idx0)
    want = jchase.chase_xla(jt, ji, STEPS, N_ROWS)
    want_mw = jchase.chase_xla_mw(jt, ji, STEPS, N_ROWS, waves)
    want_pl = jchase.chase_pallas_mw(jt, ji, STEPS, N_ROWS, waves)
    tt, ti = _torch_args(table, idx0)
    got = tchase.chase_plain_mw(tt, ti, STEPS, N_ROWS, waves)
    _same(got, want)
    _same(got, want_mw)
    _same(got, want_pl)
    _same(tchase.chase_mw(tt, ti, STEPS, N_ROWS, waves), want)


def test_wrappers_reject_bad_arguments(inputs):
    table, idx0 = inputs
    tt, ti = _torch_args(table, idx0)
    with pytest.raises(ValueError):
        tchase.chase(tt, ti.to(torch.int64), STEPS, N_ROWS)
    with pytest.raises(ValueError):
        tchase.chase(tt, ti, STEPS, N_ROWS + 1)     # not the table's rows
    with pytest.raises(ValueError):
        tchase.chase_mw(tt, ti, STEPS, N_ROWS, 3)   # 3 does not divide 64
    with pytest.raises(ValueError):
        tchase.make_table_device(1 << 31, 4, 0, "cpu")


def test_probe_report_on_cpu(inputs, capsys):
    """The probe's report on a CPU table: the plain variants only, rows
    counted as lanes x steps, parity true."""
    table, _ = inputs
    recs = tchase.probe(torch.from_numpy(table.view(np.int32)), [LANES], [4],
                        steps=4, delta=4, reps=1, label="t")
    assert [r["variant"] for r in recs] == ["torch", "torch-mw4"]
    assert all(r["parity"] and r["rows_fetched"] == LANES * 4 for r in recs)
    assert "us/step" in capsys.readouterr().out
