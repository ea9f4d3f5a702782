"""The stack-update twin (the CPU side of kernel K1) against ibwa_tpu's
Pallas kernel, run in interpret mode, and against its XLA twin.

Inputs come from `stack_kernel.random_case` (the same generator the chip
check uses): full arenas (overflow), key ties, inactive lanes, repeated
child offsets.  Exact comparison of all 13 outputs.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ibwa_tpu.align import stack_kernel as jsk

from ibwa_tpu_torch.align import stack_kernel as tsk

# small tensors: one intra-op thread (the suite runs files in parallel
# workers, and more threads only spin)
torch.set_num_threads(1)

NAMES = ("key", "sk", "sl", "sm1", "sm2", "ovf", "npush", "pslot", "pkey",
         "pk", "pl", "pm1", "pm2")


def _assert_equal(got, want):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32 and g.dtype == np.int32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(
            g.astype(np.int64), w.astype(np.int64), err_msg=name)


def _jax_args(case):
    return [jnp.asarray(case[n]) for n in (
        "slot0", "act", "cv", "ofs", "kv", "ck", "cl", "cm1", "cm2",
        "key", "sk", "sl", "sm1", "sm2")]


@pytest.mark.parametrize("B", [64, 128])
@pytest.mark.parametrize("acap", [256, 1024])
def test_twin_matches_pallas_and_xla(B, acap, monkeypatch):
    case = tsk.random_case(np.random.default_rng(B * 7 + acap), B, acap)
    # the case exercises what it claims to
    free = case["key"] == tsk.INT32_MAX
    assert (~free).all(axis=1).any() and free.all(axis=1).any()
    assert (~case["act"]).any()

    args = tsk.case_tensors(case, "cpu")
    before = [a.clone() for a in args]
    got = tsk.stack_update(*args)
    for a, b in zip(args, before):   # the twin leaves its inputs alone
        assert torch.equal(a, b)
    assert got[5].any()               # some lane overflowed its arena

    want_xla = jsk.stack_update_xla(*_jax_args(case), acap=acap)
    _assert_equal(got, want_xla)

    monkeypatch.setattr(jsk.pl, "pallas_call",
                        functools.partial(jsk.pl.pallas_call,
                                          interpret=True))
    want_pallas = jsk.stack_update(*_jax_args(case), acap=acap)
    _assert_equal(got, want_pallas)


def test_wrapper_rejects_bad_inputs():
    case = tsk.random_case(np.random.default_rng(1), 8, 64)
    args = tsk.case_tensors(case, "cpu")
    bad = list(args)
    bad[3] = bad[3].to(torch.int32)          # ofs must be int64
    with pytest.raises(ValueError):
        tsk.stack_update(*bad)
    bad = list(args)
    bad[9] = bad[9].t().contiguous().t()     # key plane not contiguous
    with pytest.raises(ValueError):
        tsk.stack_update(*bad)
