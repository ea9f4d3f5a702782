"""ibwa_tpu_torch's persistent lanes against ibwa_tpu's, on the CPU.

* the persistent run as a whole: `engine.run_search_persistent` against
  JAX's jitted `_run_search_persistent` on 96 short reads over 32 lanes
  (several reloads per lane, parked lanes, a read with too many Ns, reads
  that overflow the step budget): hits, hit counts, fallback flags and the
  step count, equal;
* `switch_cases`, the chunks the lane-switch kernel is held against on the
  card: between them they reach every branch of the switch phase, and the
  plain switch does on each what the phase is meant to;
* the kernels update a chunk in place, so no two of its tensors may share
  memory;
* the CUDA-only route rejects other devices.
Exact comparison everywhere: this is integer search.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ibwa_tpu.align import engine_jax
from ibwa_tpu.fm import device as jdev

from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.fm import device as tdev

from test_engine_jax import CASES, _make_reads
from test_torch_engine import _batch, small_index  # noqa: F401 (fixture)

torch.set_num_threads(1)

N_READS, N_LANES = 96, 32
ITER_CAP = 200   # a step budget some of the short reads overflow


@pytest.fixture(scope="module")
def chunk_inputs(small_index):
    """96 reads of 24 bases for 32 lanes; every third read carries an N,
    and read 7 more Ns than its diff budget (`bad`)."""
    fms, seq = small_index
    seqs, rseqs = _make_reads(seq, n=N_READS, read_len=24, seed=5)
    for i in range(0, N_READS, 3):
        seqs[i][i % 24] = rseqs[i][i % 24] = 4
    seqs[7][:12] = rseqs[7][:12] = 4
    jcfg, tcfg, arrs = _batch(fms, seqs, rseqs, CASES["default"])
    jcfg = dataclasses.replace(jcfg, iter_cap=ITER_CAP)
    tcfg = dataclasses.replace(tcfg, iter_cap=ITER_CAP)
    assert arrs[5][7] and arrs[5].sum() == 1            # the one bad read
    return fms, jcfg, tcfg, arrs


def test_persistent_run_matches_jax(chunk_inputs):
    fms, jcfg, tcfg, arrs = chunk_inputs
    sq, lens, md, hs, ssq, bad = arrs
    jfm = jdev.build_device_pair(fms[0], fms[1], dimer=False)
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    jhits, jnh, jfb, jit = engine_jax._run_search_persistent(
        jcfg, jfm.blocks, jfm.L2, jfm.l2diff, jfm.primary, jnp.asarray(sq),
        jnp.asarray(lens, jnp.int32), jnp.asarray(md, jnp.int32),
        jnp.asarray(hs), jnp.asarray(ssq), jnp.asarray(bad),
        seq_len=jfm.seq_len, n_blk=jfm.n_blk, n_lanes=N_LANES)
    hits, nh, fb, steps = engine.run_search_persistent(
        tcfg, tfm, *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs),
        n_lanes=N_LANES)
    assert steps == int(jit)
    np.testing.assert_array_equal(fb.numpy(), np.asarray(jfb))
    np.testing.assert_array_equal(nh.numpy(), np.asarray(jnh))
    np.testing.assert_array_equal(hits.numpy(),
                                  np.asarray(jhits).astype(np.int64))
    # the run did what the test is for: lanes reloaded several times, some
    # reads overflowed the budget, most did not, the bad read found nothing
    assert steps >= 3 * engine.SWITCH_K
    assert 0 < int(fb.sum()) < N_READS // 2
    assert int(nh[7]) == 0 and not bool(fb[7])
    assert int((nh > 0).sum()) > N_READS // 2


@pytest.fixture(scope="module")
def switch_case_sets(chunk_inputs):
    """`engine.switch_cases` on the small index at ACAP 256 and 1024."""
    fms, _, tcfg, arrs = chunk_inputs
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)
    return tfm, {acap: engine.switch_cases(
        dataclasses.replace(tcfg, acap=acap), tfm, *args, n_lanes=N_LANES)
        for acap in (256, 1024)}


SWITCH_BRANCHES = {"flush", "flush_fb", "load", "load_bad", "park",
                   "park_again", "untouched", "nothing_to_flush"}


def test_switch_cases_reach_every_branch(switch_case_sets):
    """Every branch of the switch phase is taken by some lane of some
    case, and on every case the plain switch leaves what the phase is
    meant to: unfinished lanes as they were, flushed rows in the outputs,
    loaded lanes at the root of their next read."""
    _, sets = switch_case_sets
    reached = set()
    for acap, cases in sets.items():
        assert [name for name, _ in cases] == [
            "first", "mid", "park", "last", "bad", "none", "all", "tail"]
        for name, ch in cases:
            st = ch.st
            fin = st.done | st.fb
            valid = fin & (st.rid >= 0) & (st.rid < ch.N)
            load = fin & (st.rid + ch.B < ch.N)
            nxt = torch.clamp(st.rid + ch.B, 0, ch.N - 1)
            found = {
                "flush": valid & st.done, "flush_fb": valid & st.fb,
                "load": load, "load_bad": load & ch.bad[nxt],
                "park": fin & ~load & (st.rid < ch.N),
                "park_again": fin & (st.rid >= ch.N),
                "untouched": ~fin, "nothing_to_flush": fin & (st.rid < 0)}
            reached |= {k for k, v in found.items() if bool(v.any())}

            after = ch.clone()
            after.switch()          # CPU tensors: the plain switch
            for f in engine.FIELDS:
                a, b = getattr(after.st, f), getattr(st, f)
                if f != "it":
                    assert torch.equal(a[~fin], b[~fin]), (acap, name, f)
            assert int(after.remaining) == int(ch.remaining) - int(
                valid.sum())
            rows = st.rid[valid]
            for out, src in zip(after.out_h, (st.hm, st.hk, st.hl)):
                assert torch.equal(out[rows], src[valid]), (acap, name)
            assert torch.equal(after.out_nh[rows], st.n_hits[valid])
            assert torch.equal(after.out_fb[rows], st.fb[valid])
            assert torch.equal(after.st.rid[fin], st.rid[fin] + ch.B)
            assert not bool(after.st.fb.any())
            assert torch.equal(after.st.done[fin],
                               (~load | ch.bad[nxt])[fin])
            for plane, big in zip((after.st.w, after.st.bid, after.st.meta),
                                  ch.big):
                assert torch.equal(plane[load], big[nxt[load]])
            assert bool((after.st.stack_n[load] == 2).all())
            assert bool((after.st.pslot[load] == 1).all())
            assert torch.equal(after.st.lens[load], ch.lens[nxt[load]])
    assert reached == SWITCH_BRANCHES, SWITCH_BRANCHES - reached


def test_chunk_tensors_share_no_memory(switch_case_sets):
    """The kernels write a chunk's state, outputs and counters in place:
    a fresh chunk and a clone hold every one of them in memory of its
    own."""
    _, sets = switch_case_sets
    first = sets[256][0][1]
    fresh = engine._Chunk(first.cfg, first.fm, first.big, first.lens,
                          first.max_diff0, first.has_seed, first.bad, N_LANES)
    for ch in (fresh, first, first.clone()):
        tensors = ([getattr(ch.st, f) for f in engine.FIELDS] + ch.out_h
                   + [ch.out_nh, ch.out_fb, ch.remaining])
        spans = sorted((t.data_ptr(), t.data_ptr() + t.numel()
                        * t.element_size()) for t in tensors)
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert end <= start
        assert ch.remaining.data_ptr() == ch.sync.data_ptr()
        assert ch.st.it.data_ptr() == ch.sync[1].data_ptr()


def test_switch_rejects_other_devices(switch_case_sets):
    """Only CPU tensors take the plain switch; an index on any device but
    a CUDA card raises."""
    tfm, sets = switch_case_sets
    ch = sets[256][0][1].clone()
    ch.fm = dataclasses.replace(tfm, blocks=tfm.blocks.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ch.switch()
