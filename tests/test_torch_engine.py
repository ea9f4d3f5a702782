"""ibwa_tpu_torch's search engine against ibwa_tpu's JAX engine and the
host emulator (engine_ref, the semantic oracle), on the CPU.

* widths / meta planes equal JAX's `_compute_widths` / `_pack_meta` /
  `_init_state` on reads of every shape the width pass tells apart;
* step-level parity: from one JAX `_init_state`, 32 JAX `_search_step`s
  (with `stack_update_xla`) and 32 port steps leave every one of the 30
  state planes equal after every step — the test that finds a broken step;
  `search_steps(..., n)` equals them at n = 16 and 32;
* `step_cases`, the states the search-step kernel is held against on the
  card: between them they reach every branch the kernel has to get right,
  and `search_steps` equals n plain steps on each;
* the 5 engine cases of test_engine_jax equal engine_ref hit for hit;
* chunked dispatch (every chunk launched before the first is collected),
  variable read lengths, lane-count invariance and the fixed full host
  share.
Exact comparison everywhere: this is integer search.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ibwa_tpu.align import engine_jax, engine_ref
from ibwa_tpu.align.opts import GapOpt, cal_maxdiff
from ibwa_tpu.fm import device as jdev
from ibwa_tpu.fm.fmindex import FmIndex
from ibwa_tpu.index import builder

from ibwa_tpu_torch import convert
from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.fm import device as tdev

from test_engine_jax import CASES, _make_reads

# small tensors: one intra-op thread (the suite runs files in parallel
# workers, and more threads only spin)
torch.set_num_threads(1)


def _tuples(results):
    """Per-read hit lists as plain tuples: the port's `Hit` and
    ibwa_tpu's are two classes with the same fields."""
    return [[dataclasses.astuple(h) for h in hits] for hits in results]


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("teng")
    rng = random.Random(4242)
    seq = "".join(rng.choice("ACGT") for _ in range(40000))
    fa = tmp / "g.fa"
    with open(fa, "w") as f:
        f.write(">c1\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")
    builder.bwa_index(str(fa))
    fms = (FmIndex(builder.load_index(str(fa), 0)),
           FmIndex(builder.load_index(str(fa), 1)))
    return fms, seq


@pytest.fixture
def small_lanes(monkeypatch):
    """CPU-sized lanes; the heavy-tail cap off so the device path must
    match the oracle on its own (capacity fallbacks only)."""
    monkeypatch.setattr(engine, "DEV_BATCH", 64)
    monkeypatch.setattr(engine, "ITER_CAP", 1 << 30)


def _batch(fms, seqs, rseqs, opt):
    """align_batch's preamble: configs of both engines + packed inputs."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    bopt = dataclasses.replace(opt)
    if opt.fnr > 0.0:
        bopt.max_diff = cal_maxdiff(int(lens.max()), thres=opt.fnr)
        md = np.array([cal_maxdiff(int(n), thres=opt.fnr) for n in lens])
    else:
        md = np.full(len(seqs), bopt.max_diff)
    if bopt.max_diff < bopt.max_gapo:
        bopt.max_gapo = bopt.max_diff
    L = int(max(8, (lens.max() + 7) // 8 * 8))
    n = fms[0].seq_len
    jcfg = engine_jax.make_config(L, int(md.max()), bopt, seq_len=n,
                                  dimer=False)
    tcfg = engine.make_config(L, int(md.max()), bopt, seq_len=n)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert not jcfg.pallas_stack and not jcfg.dimer_unroll
    sq, ssq, hs, bad = engine._pack_reads(seqs, rseqs, lens, md, L,
                                          tcfg.SL, opt.seed_len)
    return jcfg, tcfg, (sq, lens, md.astype(np.int64), hs, ssq, bad)


def _assert_state_equal(tst, jst, step):
    got = convert.state_to_tuple(tst)
    for name, g, w in zip(engine.FIELDS, got, jst):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (step, name)
        np.testing.assert_array_equal(g, w, err_msg=f"step {step}: {name}")


def _width_reads(seq, case):
    """Reads for one case of the width pass, as (seqs, rseqs) code arrays
    stored reversed like `_make_reads`'s: 24 reads from a numpy seed."""
    if case == "mixed":
        return _make_reads(seq, n=24, read_len=60, seed=3)
    rng = np.random.default_rng(11)
    nt4 = np.frombuffer(seq.encode(), dtype=np.uint8)
    genome = np.select([nt4 == ord(c) for c in "ACGT"], [0, 1, 2, 3])
    lengths = {"full": [56], "short": [56, 40, 33, 50],
               "no_seed": [56, 32, 24, 31]}.get(case, [56, 48])
    seqs, rseqs = [], []
    for i in range(24):
        n = lengths[i % len(lengths)]
        pos = int(rng.integers(0, len(genome) - n))
        codes = genome[pos:pos + n].astype(np.uint8)
        if case == "n_inside":
            codes[rng.integers(1, n - 1, size=1 + i % 3)] = 4
        elif case == "n_at_ends":
            codes[[0, -1][i % 2]] = 4
            if i % 3 == 0:
                codes[[0, -1]] = 4
        elif case == "resets" and i % 2 == 0:
            # no such sequence in the genome: the interval empties and
            # starts over every few bases
            codes = rng.integers(0, 4, n).astype(np.uint8)
        rc = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
        seqs.append(codes[::-1].copy())
        rseqs.append(rc[::-1].copy())
    return seqs, rseqs


@pytest.mark.parametrize("case", ["mixed", "full", "short", "no_seed",
                                  "n_inside", "n_at_ends", "resets"])
def test_widths_and_meta_match_jax(small_index, case):
    """The width pass against JAX: reads as long as the padded length,
    shorter ones, reads too short for a seed, N bases inside and at both
    ends, and reads whose interval resets several times."""
    fms, seq = small_index
    seqs, rseqs = _width_reads(seq, case)
    jcfg, tcfg, (sq, lens, md, hs, ssq, bad) = _batch(fms, seqs, rseqs,
                                                      GapOpt())
    if case == "full":
        assert (lens == tcfg.L).all()
    elif case == "short":
        assert (lens < tcfg.L).any() and hs.all()
    elif case == "no_seed":
        assert (~hs).any() and hs.any() and (lens == 32).any()
    elif case.startswith("n_"):
        assert ((sq == 4) & (np.arange(tcfg.L) < lens[:, None, None])).any()
    jfm = jdev.build_device_pair(fms[0], fms[1], dimer=False)
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    jw, jbid = engine_jax._compute_widths(jfm, jnp.asarray(sq),
                                          jnp.asarray(lens, jnp.int32),
                                          tcfg.L)
    tw, tbid = engine._compute_widths(tfm, torch.from_numpy(sq),
                                      torch.from_numpy(lens), tcfg.L)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tbid.numpy(), np.asarray(jbid))
    np.testing.assert_array_equal(
        engine._pack_meta(tw, tbid).numpy(),
        np.asarray(engine_jax._pack_meta(jw, jbid)))
    if case == "resets":   # bid counts the resets: several in one read
        assert int(tbid.max()) >= 4
    # the full per-chunk planes, seed widths included
    big = engine.big_planes(tcfg, tfm, torch.from_numpy(sq),
                            torch.from_numpy(lens), torch.from_numpy(hs),
                            torch.from_numpy(ssq))
    jst = engine_jax._init_state(
        jcfg, jfm, jnp.asarray(sq), jnp.asarray(lens, jnp.int32),
        jnp.asarray(md, jnp.int32), jnp.asarray(hs), jnp.asarray(ssq),
        jnp.asarray(bad))
    for t, j in zip(big, jst[11:14]):    # w, bid, meta
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_big_planes_rejects_other_devices(small_index):
    """Only CPU tensors take the plain width pass; an index on any device
    but a CUDA card raises."""
    fms, seq = small_index
    seqs, rseqs = _width_reads(seq, "short")
    _, tcfg, arrs = _batch(fms, seqs, rseqs, GapOpt())
    sq, lens, _, hs, ssq, _ = (torch.from_numpy(a) for a in arrs)
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    meta_fm = dataclasses.replace(tfm, blocks=tfm.blocks.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        engine.big_planes(tcfg, meta_fm, sq, lens, hs, ssq)


@pytest.mark.parametrize("case", ["default", "gappy"])
def test_step_parity_32_steps(small_index, case):
    fms, seq = small_index
    seqs, rseqs = _make_reads(seq, n=24, read_len=24, seed=5)
    jcfg, tcfg, (sq, lens, md, hs, ssq, bad) = _batch(fms, seqs, rseqs,
                                                      CASES[case])
    jfm = jdev.build_device_pair(fms[0], fms[1], dimer=False)
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    jsq = jnp.asarray(sq)
    jst = engine_jax._init_state(
        jcfg, jfm, jsq, jnp.asarray(lens, jnp.int32),
        jnp.asarray(md, jnp.int32), jnp.asarray(hs), jnp.asarray(ssq),
        jnp.asarray(bad))
    tst = convert.state_from_jax_tuple(jst)
    _assert_state_equal(tst, jst, 0)
    tst0 = engine.clone_state(tst)
    jstep = jax.jit(engine_jax._search_step, static_argnums=0)
    tsq = torch.from_numpy(sq)
    for k in range(1, 33):
        jst = jstep(jcfg, jfm, jsq, jst)
        tst = engine._search_step(tcfg, tfm, tsq, tst)
        _assert_state_equal(tst, jst, k)
        if k in (16, 32):   # the n-step entry, from the first state
            tn = engine.search_steps(tcfg, tfm, tsq,
                                     engine.clone_state(tst0), k)
            _assert_state_equal(tn, jst, k)
    # the steps reached hit bookkeeping and the gap_shadow refresh
    assert int(tst.n_hits.sum()) > 0


BRANCHES = {"hit_direct", "hit_e", "dup", "hovf", "gap_shadow", "arena",
            "seq_ovf", "iter_cap", "e_stops_at_n"}


def _branches(cfg, seqs, st0, st1) -> set:
    """The branches of the step that some lane took between `st0` and its
    successor `st1`, read from the entry each lane popped and from what
    the step changed."""
    m1, m2 = st0.pm1, st0.pm2
    is_e = (m1 & 3) == engine.STATE_E
    e_a, e_i = (m1 >> 2) & 1, (m1 >> 3) & 0x1FFF
    e_gapo = (m2 >> 8) & 0xFF
    spent = (m2 & 0xFF) + e_gapo + (((m2 >> 16) & 0xFF) if cfg.gape_mode
                                    else 0)
    stepped = st1.lane_it > st0.lane_it          # got past the gating
    capped = stepped & (st1.lane_it > cfg.iter_cap)
    brk = (st0.pkey >> 20) > st0.best_score + cfg.s_mm
    ran = stepped & ~capped & ~(brk & (not cfg.nonstop))
    new_fb = st1.fb & ~st0.fb
    added = st1.n_hits > st0.n_hits
    seen = torch.arange(engine.HCAP)[None, :] < st0.n_hits[:, None]
    dup = ((st0.hk == st0.pk[:, None]) & (st0.hl == st0.pl[:, None])
           & seen).any(dim=1)
    hit = ran & (e_i == 0) & (is_e | (st0.max_diff - spent >= 0))
    full = st0.n_hits >= engine.HCAP
    near_seq = st0.seqc + 10 >= engine.MAX_SEQ
    crid = torch.clamp(st0.rid, 0, seqs.shape[0] - 1)
    base = seqs[crid, e_a, torch.clamp(e_i - 1, 0, cfg.L - 1)]
    found = {
        "hit_direct": ran & added & ~is_e,
        "hit_e": ran & added & is_e,
        "dup": (hit & ~added & dup & (e_gapo > 0) & ~full
                & ~(st1.done & ~st0.done)),
        "hovf": hit & new_fb & full,
        "gap_shadow": added & (st1.w > st0.w).any(dim=2).any(dim=1),
        "arena": (ran & new_fb & ~full & ~near_seq
                  & ((st1.key == engine.INT32_MAX).sum(dim=1) == 0)),
        "seq_ovf": ran & new_fb & near_seq,
        "iter_cap": capped,
        "e_stops_at_n": ran & is_e & (e_i > 0) & (base >= 4),
    }
    return {name for name, lanes in found.items() if bool(lanes.any())}


@pytest.fixture(scope="module")
def step_case_sets(small_index):
    """`engine.step_cases` on the small index: defaults and the gappy
    options, ACAP 256 and 1024, a third of the reads with an N."""
    fms, seq = small_index
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    seqs, rseqs = _make_reads(seq, n=96, read_len=24, seed=5)
    for i in range(0, len(seqs), 3):
        seqs[i][i % 24] = rseqs[i][i % 24] = 4
    sets = {}
    for case in ("default", "gappy"):
        _, tcfg, arrs = _batch(fms, seqs, rseqs, CASES[case])
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)
        for acap in (256, 1024):
            cfg = dataclasses.replace(tcfg, acap=acap)
            sets[case, acap] = engine.step_cases(cfg, tfm, *args, n_lanes=32)
    return tfm, sets


def test_step_cases_reach_every_branch(step_case_sets):
    tfm, sets = step_case_sets
    reached = set()
    for cases in sets.values():
        assert [c[0] for c in cases] == [
            "phase0", "phase2", "phase5", "hovf", "seq_ovf", "arena", "dup",
            "n_bases", "iter_cap"]
        for _, cfg, seqs, st in cases:
            st = engine.clone_state(st)
            for _ in range(engine.SWITCH_K):
                nxt = engine._search_step(cfg, tfm, seqs,
                                          engine.clone_state(st))
                reached |= _branches(cfg, seqs, st, nxt)
                st = nxt
    assert reached == BRANCHES, BRANCHES - reached


@pytest.mark.parametrize("acap", [256, 1024])
@pytest.mark.parametrize("case", ["default", "gappy"])
def test_search_steps_equal_plain_steps(step_case_sets, case, acap):
    """On the CPU `search_steps(..., n)` is n plain steps, for every case
    the kernel is held against on the card; the state it is given is
    what a step leaves (`meta` packed from `w` / `bid`), which is all the
    kernel relies on."""
    tfm, sets = step_case_sets
    for name, cfg, seqs, st in sets[case, acap]:
        np.testing.assert_array_equal(
            st.meta.numpy(), engine._pack_meta(st.w, st.bid).numpy(), name)
        for n in (1, engine.SWITCH_K):
            want = engine.clone_state(st)
            for _ in range(n):
                want = engine._search_step(cfg, tfm, seqs, want)
            got = engine.search_steps(cfg, tfm, seqs,
                                      engine.clone_state(st), n)
            for f in engine.FIELDS:
                assert torch.equal(getattr(got, f), getattr(want, f)), \
                    (name, n, f)
            assert int(got.it) == int(st.it) + n


def test_search_steps_rejects_other_devices(step_case_sets):
    """Only CPU tensors take the plain step; a tensor on any device but a
    CUDA card raises."""
    tfm, sets = step_case_sets
    _, cfg, seqs, st = sets["default", 256][0]
    meta_fm = dataclasses.replace(tfm, blocks=tfm.blocks.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        engine.search_steps(cfg, meta_fm, seqs, st, 1)


def test_empty_lanes_are_a_step_fixed_point(small_index):
    """The lanes before the first read hold what a step would leave (the
    pop of an empty arena, the meta of zero planes), so a step, and the
    kernel that skips idle lanes, changes nothing but `it`."""
    fms, seq = small_index
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    seqs, rseqs = _make_reads(seq, n=8, read_len=24, seed=5)
    _, tcfg, arrs = _batch(fms, seqs, rseqs, CASES["default"])
    st = engine._empty_lanes(tcfg, 8, "cpu")
    nxt = engine._search_step(tcfg, tfm, torch.from_numpy(arrs[0]),
                              engine.clone_state(st))
    for f in engine.FIELDS:
        if f != "it":
            assert torch.equal(getattr(nxt, f), getattr(st, f)), f
    assert int(nxt.it) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_engine_cases_match_ref(small_index, case, small_lanes):
    fms, seq = small_index
    opt = CASES[case]
    seqs, rseqs = _make_reads(seq)
    ref = _tuples(engine_ref.align_batch(fms, seqs, rseqs, opt))
    eng = engine.TorchAlnEngine(fms, "cpu")
    try:
        got = _tuples(eng.align_batch(seqs, rseqs, opt))
    finally:
        eng.close()
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g == r, f"read {i}: {g} != {r}"
    # the device path must do nearly all the work itself
    assert eng.stats["fallback_reads"] <= len(seqs) // 10


def test_chunked_dispatch(small_index, small_lanes, monkeypatch):
    """PERSIST_N < n_reads: chunk results and background fallback futures
    merge back in read order."""
    fms, seq = small_index
    opt = CASES["seeded"]
    seqs, rseqs = _make_reads(seq)
    ref = _tuples(engine_ref.align_batch(fms, seqs, rseqs, opt))
    monkeypatch.setattr(engine, "PERSIST_N", 16)      # 40 reads -> 3 chunks
    eng = engine.TorchAlnEngine(fms, "cpu")
    try:
        assert _tuples(eng.align_batch(seqs, rseqs, opt)) == ref
    finally:
        eng.close()


def test_chunks_launched_before_any_is_collected(small_index, small_lanes,
                                                 monkeypatch):
    """align_batch launches every chunk of its device share before it
    reads the first back, as engine_jax.py:1061-1102 dispatches them, and
    the hits are those of the one-by-one order (each chunk collected as
    soon as it is launched) and of engine_ref."""
    fms, seq = small_index
    opt = CASES["seeded"]
    seqs, rseqs = _make_reads(seq)
    ref = _tuples(engine_ref.align_batch(fms, seqs, rseqs, opt))
    monkeypatch.setattr(engine, "PERSIST_N", 16)      # 40 reads -> 3 chunks
    launch, collect = engine.launch_search, engine.collect_search
    calls = []

    def launch_rec(*a, **k):
        calls.append(("launch", a[2].shape[0]))
        return launch(*a, **k)

    def collect_rec(launched):
        calls.append(("collect", launched[1].shape[0]))
        return collect(launched)

    def run():
        eng = engine.TorchAlnEngine(fms, "cpu")
        try:
            return _tuples(eng.align_batch(seqs, rseqs, opt))
        finally:
            eng.close()

    monkeypatch.setattr(engine, "launch_search", launch_rec)
    monkeypatch.setattr(engine, "collect_search", collect_rec)
    ahead = run()
    assert calls == [("launch", 16), ("launch", 16), ("launch", 8),
                     ("collect", 16), ("collect", 16), ("collect", 8)]

    # the one-by-one order: each chunk collected as soon as it is launched
    serial = []

    def launch_collect(*a, **k):
        serial.append(collect(launch(*a, **k)))
        hits, n_hits, fb, steps = serial[-1]
        return hits, n_hits, fb, torch.tensor([0, steps])

    monkeypatch.setattr(engine, "launch_search", launch_collect)
    monkeypatch.setattr(engine, "collect_search", collect)
    one_by_one = run()
    assert len(serial) == 3
    assert ahead == one_by_one == ref


def test_lane_count_invariant(small_index, monkeypatch):
    """64 and 128 persistent lanes give the same hits (and the oracle's)."""
    fms, seq = small_index
    opt = CASES["exact"]
    seqs, rseqs = _make_reads(seq, n=150, seed=9)
    ref = _tuples(engine_ref.align_batch(fms, seqs, rseqs, opt))
    monkeypatch.setattr(engine, "ITER_CAP", 1 << 30)
    for lanes in (64, 128):
        monkeypatch.setattr(engine, "DEV_BATCH", lanes)
        eng = engine.TorchAlnEngine(fms, "cpu")
        try:
            assert _tuples(eng.align_batch(seqs, rseqs, opt)) == ref, lanes
        finally:
            eng.close()


def test_variable_lengths(small_index, small_lanes):
    fms, seq = small_index
    rng = random.Random(1)
    nt4 = {"A": 0, "C": 1, "G": 2, "T": 3}
    seqs, rseqs = [], []
    for ln in [36, 50, 75, 100, 120, 36, 64]:
        pos = rng.randrange(0, len(seq) - 130)
        codes = np.array([nt4[c] for c in seq[pos:pos + ln]], dtype=np.uint8)
        seqs.append(codes[::-1].copy())
        rseqs.append((3 - codes)[::-1].copy())
    opt = GapOpt()
    ref = _tuples(engine_ref.align_batch(fms, seqs, rseqs, opt))
    eng = engine.TorchAlnEngine(fms, "cpu")
    try:
        assert _tuples(eng.align_batch(seqs, rseqs, opt)) == ref
    finally:
        eng.close()


def test_fixed_full_host_share(small_index, monkeypatch):
    """IBWA_HOST_FRAC is a FIXED share: 1.0 sends the whole batch to the
    native search and the controller does not adapt it."""
    fms, seq = small_index
    opt = CASES["default"]
    seqs, rseqs = _make_reads(seq)
    ref = _tuples(engine_ref.align_batch(fms, seqs, rseqs, opt))
    monkeypatch.setenv("IBWA_HOST_FRAC", "1.0")
    eng = engine.TorchAlnEngine(fms, "cpu")
    try:
        assert eng._frac_fixed and eng.host_frac == 1.0
        assert _tuples(eng.align_batch(seqs, rseqs, opt)) == ref
    finally:
        eng.close()
    assert eng.host_frac == 1.0
    assert eng.stats["host_reads"] == len(seqs)
    assert eng.stats["device_reads"] == 0
