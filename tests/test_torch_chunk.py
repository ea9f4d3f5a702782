"""ibwa_tpu_torch's one-launch chunk search against its plain version, the
phased loop, on the CPU.

* the premise the kernel rests on: what the phased loop finds (hit counts,
  fallback flags, the hits below each count) does not depend on SWITCH_K,
  only its step count does, and `engine.chunk_steps` gives that count from
  each read's own iterations, for SWITCH_K 1, 4 and 16 and at the loop's
  iteration bound;
* the kernel's source itself: `csrc/search_chunk.cu` (and the phased
  kernels `csrc/search_step.cu` / `csrc/lane_switch.cu`, which share its
  device code, and its first version `csrc/search_chunk_first.cu`) built
  with g++ against `tests/cuda_standin/cuda_runtime.h`, a header that
  stands in for the CUDA runtime, and run on CPU tensors against the
  plain loop: its outputs, its reads' own iterations (from which
  `engine.finish_chunk` gives the loop's step count), the fallback's
  cause of every read, at every grid (the queue's order does not matter)
  and at the capacities' edges;
* the routes: CPU tensors take the phased loop, `search_chunk` itself takes
  CUDA tensors only, any other device raises.
The inputs are `test_torch_switch`'s: 96 reads of 24 bases over 32 lanes, a
bad read, reads that overflow the step budget.  Exact comparison everywhere:
this is integer search.
"""

import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ibwa_tpu_torch import kernels
from ibwa_tpu_torch.align import engine, engine_ref
from ibwa_tpu_torch.fm import device as tdev

from test_engine_jax import CASES, _make_reads
from test_torch_engine import (_batch, small_index,  # noqa: F401
                               step_case_sets)
from test_torch_switch import (N_LANES, N_READS, chunk_inputs,  # noqa: F401
                               chunk_reads, switch_case_sets)

torch.set_num_threads(1)

CSRC = pathlib.Path(kernels.CSRC)
STANDIN = pathlib.Path(__file__).resolve().parent / "cuda_standin"


@pytest.fixture(scope="module")
def chunk(chunk_inputs):
    """(config, index on the CPU, `run_search_persistent`'s read
    arguments)."""
    fms, _, tcfg, arrs = chunk_inputs
    tfm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    return tcfg, tfm, tuple(torch.from_numpy(np.ascontiguousarray(a))
                            for a in arrs)


_masked = engine.masked_hits


def _traced_phased(cfg, fm, args, k: int):
    """The plain phased loop with `k` steps per phase, by hand; returns
    its result and, per read, the clock of the switch that loaded it and of
    the one that flushed it."""
    seqs, bad = args[0], args[5]
    ch = engine._plain_chunk(cfg, fm, *args, n_lanes=N_LANES)
    N = ch.N
    load, flush = np.full(N, -1), np.full(N, -1)
    while True:
        st, now = ch.st, int(ch.st.it)
        fin = st.done | st.fb
        flush[st.rid[fin & (st.rid >= 0) & (st.rid < N)].numpy()] = now
        ch.switch_plain()
        load[ch.st.rid[fin & (ch.st.rid < N)].numpy()] = now
        for _ in range(k):
            ch.st = engine._search_step(cfg, fm, seqs, ch.st)
        left, steps = ch.counters()
        if left <= 0 or steps >= engine.MAX_ITERS * 8:
            break
    hits = torch.stack(ch.out_h, dim=-1)[:N]
    return (hits, ch.out_nh[:N], ch.out_fb[:N] | (left > 0), steps,
            load, flush)


@pytest.fixture(scope="module")
def read_iters(chunk):
    """The phased loop at one step per phase: its result and each read's
    iteration count (a read loaded at t whose flag is set in iteration j
    is flushed at t + max(1, j))."""
    cfg, fm, args = chunk
    hits, nh, fb, steps, load, flush = _traced_phased(cfg, fm, args, 1)
    assert (load >= 0).all() and (flush > load).all()
    return hits, nh, fb, steps, flush - load


@pytest.mark.parametrize("k", [1, 4, 16])
def test_chunk_steps_gives_the_phased_loops_count(chunk, read_iters,
                                                  monkeypatch, k):
    cfg, fm, args = chunk
    hits1, nh1, fb1, _, iters = read_iters
    bad = args[5].numpy()
    monkeypatch.setattr(engine, "SWITCH_K", k)
    hits, nh, fb, steps, _ = engine.run_search_persistent(cfg, fm, *args,
                                                          n_lanes=N_LANES)
    assert steps == engine.chunk_steps(iters, bad, N_LANES, k)
    # what the search finds does not depend on the phase length
    assert torch.equal(nh, nh1) and torch.equal(fb, fb1)
    assert torch.equal(_masked(hits, nh, fb), _masked(hits1, nh1, fb1))
    # the inputs reach what makes the clock hard: a read done at its load,
    # reads that end on a phase's last step, reads of several phases
    live = iters[~bad]
    assert bad.any() and (live % 4 == 0).any() and (live > 16).any()
    assert 0 < int(fb.sum()) < N_READS // 2


def test_chunk_steps_at_the_iteration_bound(chunk, read_iters, monkeypatch):
    """A loop cut by its iteration bound: every read falls back, the step
    count is the bound rounded up to a phase, and `chunk_steps` says so."""
    cfg, fm, args = chunk
    _, _, _, steps1, iters = read_iters
    bad = args[5].numpy()
    monkeypatch.setattr(engine, "MAX_ITERS", 5)          # bound: 40 steps
    assert steps1 > 48
    for k in (16, 4):
        monkeypatch.setattr(engine, "SWITCH_K", k)
        _, _, fb, steps, _ = engine.run_search_persistent(cfg, fm, *args,
                                                          n_lanes=N_LANES)
        assert steps == -(-40 // k) * k and bool(fb.all())
        assert engine.chunk_steps(iters, bad, N_LANES, k, bound=40) == steps
    # ... and a bound the run just stays under changes nothing
    assert engine.chunk_steps(iters, bad, N_LANES, 1, bound=steps1) == steps1
    assert engine.chunk_steps(iters, bad, N_LANES, 1,
                              bound=steps1 - 1) == steps1 - 1


def test_chunk_steps_small_cases():
    """Hand-checked clocks: one lane, three reads of 1, 16 and 17
    iterations at 16 steps a phase take 1 + 1 + 2 phases, and the loop runs
    one phase more; a bad read takes a phase; fewer reads than lanes."""
    no = np.zeros(3, bool)
    assert engine.chunk_steps([1, 16, 17], no, 1, 16) == 5 * 16
    assert engine.chunk_steps([1, 16, 17], no, 3, 16) == 3 * 16
    assert engine.chunk_steps([1, 16, 17], no, 8, 16) == 3 * 16
    assert engine.chunk_steps([99, 16, 17], [True, False, False], 1,
                              16) == 5 * 16
    assert engine.chunk_steps([5, 3], no[:2], 1, 1) == 9
    assert engine.chunk_steps([5, 3], no[:2], 1, 1, bound=8) == 8


def standin_source(text: str) -> str:
    """A CUDA source as g++ takes it with `cuda_standin/cuda_runtime.h`:
    a kernel launch becomes a call, dynamic shared memory (aligned or not;
    the stand-in's buffer is 16-byte aligned) a pointer."""
    text = re.sub(r"(\w+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"cuda_standin::launch(\2, [&] { \1(\3); });", text,
                  flags=re.S)
    return re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)cuda_standin::dynamic_smem();", text)


STANDIN_ENTRIES = {"search_chunk": "ibwa_search_chunk",
                   "search_chunk_first": "ibwa_search_chunk_first",
                   "search_step": "ibwa_search_steps",
                   "lane_switch": "ibwa_lane_switch",
                   "stack_update": "ibwa_stack_update"}


@pytest.fixture(scope="module")
def standin_lib(tmp_path_factory):
    """The search kernels' sources built with g++ over the stand-in
    header, loaded as `kernels.lib()` would load the nvcc build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' sources with")
    out = tmp_path_factory.mktemp("standin")
    cpps = []
    for name in STANDIN_ENTRIES:
        cpp = out / f"{name}.cpp"
        cpp.write_text(standin_source((CSRC / f"{name}.cu").read_text()))
        cpps.append(str(cpp))
    so = out / "libibwa_standin.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(STANDIN), "-I", str(CSRC), "-o", str(so),
                    *cpps], check=True)
    handle = ctypes.CDLL(str(so))
    for entry in (*STANDIN_ENTRIES.values(), "ibwa_search_chunk_shape"):
        fn = getattr(handle, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return handle


def _standin_chunk(cfg, fm, args, mode: int = 1, max_blocks: int = 0):
    """`csrc/search_chunk.cu` (the caller put the stand-in build in place
    of `kernels.lib()`) on width planes of its own: its outputs, and the
    planes it updated in place."""
    seqs, lens, md, hs, ssq, bad = args
    big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    return engine._launch_search_chunk(cfg, fm, seqs, big, lens, md, hs, bad,
                                       0, mode, max_blocks), big


def _hold_chunk(got, want, n_lanes: int = N_LANES) -> int:
    """K8's outputs, finished as the engine finishes them
    (`engine.finish_chunk`), against a phased loop's (hits, n_hits, fb,
    steps, cause): the step count, counts, flags, causes and the hits
    below each count, bitwise.  Returns the step count."""
    out_h, nh, fb, it, cause = got[:5]
    hits, nh, fb, steps, cause = engine.finish_chunk(
        out_h.permute(1, 2, 0), nh, fb, it, cause, n_lanes)
    want_h, want_nh, want_fb, want_steps, want_cause = want
    assert steps == want_steps
    assert torch.equal(nh, want_nh) and torch.equal(fb, want_fb)
    assert torch.equal(cause, want_cause)
    assert torch.equal(_masked(hits, nh, fb),
                       _masked(want_h, want_nh, want_fb))
    return steps


@pytest.mark.parametrize("acap,mode,k", [
    (256, 1, 16), (256, 0, 16), (1024, 0, 16), (1024, 1, 16), (256, 1, 4),
    (256, 1, 1)])
def test_search_chunk_source_equals_phased_loop(chunk, standin_lib,
                                                monkeypatch, acap, mode, k):
    """`csrc/search_chunk.cu`, run on the CPU through the stand-in, against
    the plain phased loop: hit counts, fallback flags and causes, steps
    (from the reads' own iterations), the hits below each count, the
    counters, and the reads' planes where the search changed them.  With
    and without the step's rows asked ahead, at both arena sizes, and at
    phases of 16, 4 and 1 steps (the shorter the phase, the more reads end
    on its last step, where the step count is easiest to get wrong)."""
    cfg, fm, args = chunk
    cfg = dataclasses.replace(cfg, acap=acap)
    monkeypatch.setattr(engine, "SWITCH_K", k)
    seqs, lens, md, hs, ssq, bad = args
    want = engine.run_search_phased(cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    before = kernels.launches["search_chunk"]
    got, big = _standin_chunk(cfg, fm, args, mode)
    assert kernels.launches["search_chunk"] == before + 1
    _hold_chunk(got, want)
    out_h, nh, fb, it, cause, counters = got
    taken, flushed, longest, total, rows, *by_cause, e_fetch = \
        counters.tolist()
    lanes = engine.search_chunk_shape(cfg, fm, seqs, big, lens, md, hs,
                                      bad, mode)["lanes"]
    # every lane's last take finds the queue empty
    assert flushed == N_READS and taken == N_READS + lanes
    assert total == int(it.sum()) and 0 < longest <= total
    # at most two rows for the occ4 bounds and two per base of the E-chain
    assert 0 < rows <= 2 * total * engine.E_UNROLL and rows % 2 == 0
    assert 0 < 2 * e_fetch < rows
    # the fallback's split: the counters and the reads' codes agree
    assert by_cause == [int(((cause == c) & fb).sum()) for c in (
        engine.FB_ITER_CAP, engine.FB_ARENA, engine.FB_HITS,
        engine.FB_SEQNO)]
    assert sum(by_cause) == int(fb.sum()) > 0
    hits = out_h.permute(1, 2, 0)
    assert bool((hits == _masked(hits, nh, torch.zeros_like(fb))).all())
    # in place: gap_shadow changed the rows of reads with hits, no others
    fresh = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    changed = (big[0] != fresh[0]).flatten(1).any(dim=1)
    assert bool(changed.any()) and not bool(changed[nh == 0].any())
    assert torch.equal(big[2], engine._pack_meta(big[0], big[1]))


def test_search_chunk_source_at_the_iteration_bound(chunk, standin_lib,
                                                    monkeypatch):
    """The loop's bound: reads run at most to it, the step count is the
    bound, every read falls back, and the reads the loop would not have
    flushed carry no hits and the bound as their cause."""
    cfg, fm, args = chunk
    monkeypatch.setattr(engine, "MAX_ITERS", 5)
    want = engine.run_search_phased(cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    got, _ = _standin_chunk(cfg, fm, args)
    assert _hold_chunk(got, want) == 48 and bool(want[2].all())
    assert int(got[3].max()) == 48   # the reads stopped at the bound
    assert bool((want[4] == engine.FB_BOUND).any())


@pytest.mark.parametrize("blocks", [1, 3, 8])
def test_search_chunk_source_any_grid(chunk, read_iters, standin_lib,
                                      monkeypatch, blocks):
    """The queue's order does not matter: on a grid of 1 block (four lanes
    take every read), of 3, and of the launch's own 8 (the stand-in card's
    resident blocks, 32 lanes), the outputs equal the plain loop's, and
    each read's own iteration count equals the plain loop's per-read
    iterations (0 for the bad read, done at its start)."""
    cfg, fm, args = chunk
    seqs, lens, md, hs, ssq, bad = args
    want = engine.run_search_plain(cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    got, big = _standin_chunk(cfg, fm, args, max_blocks=blocks % 8)
    shape = engine.search_chunk_shape(cfg, fm, seqs, big, lens, md, hs, bad,
                                      max_blocks=blocks % 8)
    assert shape["blocks"] == blocks and shape["blocks_per_sm"] == 4
    _hold_chunk(got, want)
    it, iters, bad = got[3].numpy(), read_iters[4], bad.numpy()
    assert (it[bad] == 0).all() and (it[~bad] == iters[~bad]).all()
    assert got[5].tolist()[0] == N_READS + 4 * blocks


@pytest.mark.parametrize("edge", ["iter_cap", "arena", "hits", "seqno"])
def test_search_chunk_source_fallback_causes(chunk, small_index, standin_lib,
                                             monkeypatch, edge):
    """Each capacity set where the chunk's reads run into it (a step budget
    of 40, an arena of 32 slots, a seqno field of 64 pushes; one hit row
    for reads of 12 bases, some of which have two hits): the kernel's
    outputs and every read's cause equal the plain loop's, and that cause
    is among them."""
    cfg, fm, args = chunk
    code = {"iter_cap": engine.FB_ITER_CAP, "arena": engine.FB_ARENA,
            "hits": engine.FB_HITS, "seqno": engine.FB_SEQNO}[edge]
    if edge == "iter_cap":
        cfg = dataclasses.replace(cfg, iter_cap=40)
    elif edge == "arena":
        cfg = dataclasses.replace(cfg, acap=32)
    elif edge == "hits":
        monkeypatch.setattr(engine, "HCAP", 1)
        fms, seq = small_index
        _, cfg, arrs = _batch(fms, *_make_reads(seq, n=N_READS, read_len=12,
                                                seed=5), CASES["default"])
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)
    else:
        monkeypatch.setattr(engine, "MAX_SEQ", 64)
    want = engine.run_search_plain(cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    got, _ = _standin_chunk(cfg, fm, args)
    _hold_chunk(got, want)
    assert int((want[4] == code).sum()) > 0


def test_plain_step_causes_at_the_edges(step_case_sets):
    """The plain step's cause on `engine.step_cases`' edge states: every
    lane whose fb flag the steps set gets a code, the edge's among them
    (a lane may meet another edge first), and no other lane gets one."""
    tfm, sets = step_case_sets
    codes = {"hovf": engine.FB_HITS, "seq_ovf": engine.FB_SEQNO,
             "arena": engine.FB_ARENA, "iter_cap": engine.FB_ITER_CAP}
    for name, cfg, seqs, st in sets["default", 256]:
        if name not in codes:
            continue
        cause = torch.zeros_like(st.lens)
        got = engine.clone_state(st)
        for _ in range(engine.SWITCH_K):
            got = engine._search_step(cfg, tfm, seqs, got, cause)
        new = got.fb & ~st.fb
        assert bool((cause[new] == codes[name]).any()), name
        assert bool((cause[new] > 0).all()), name
        assert not bool(cause[~new].any()), name


def test_search_chunk_source_higher_iter_cap(chunk, chunk_reads,
                                             standin_lib, monkeypatch):
    """A step budget three times the chunk's: the kernel equals the plain
    loop at that budget, it keeps reads on the card that the lower budget
    sends to the host, and every read it keeps decodes to the hits that
    the host search and `engine_ref` give it."""
    cfg, fm, args = chunk
    fms, seqs_l, rseqs_l, opt = chunk_reads
    high = dataclasses.replace(cfg, iter_cap=3 * cfg.iter_cap)
    low = engine.run_search_plain(cfg, fm, *args, n_lanes=N_LANES)
    want = engine.run_search_plain(high, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    got, _ = _standin_chunk(high, fm, args)
    _hold_chunk(got, want)
    fb, nh = got[2].numpy(), got[1].numpy()
    assert (low[2].numpy() & ~fb).any()
    out = [None] * N_READS
    engine._decode(got[0].permute(1, 2, 0).numpy(), nh, fb, opt, out, 0)
    kept = np.nonzero(~fb)[0]
    picked = ([seqs_l[i] for i in kept], [rseqs_l[i] for i in kept])
    host = engine.native_align_batch(fms, *picked, opt)
    ref = engine_ref.align_batch(fms, *picked, opt)
    for i, h, r in zip(kept, host, ref):
        assert out[i] == h == r, i


def test_search_chunk_first_source_equals_phased_loop(chunk, standin_lib,
                                                      monkeypatch):
    """K8's first version (`csrc/search_chunk_first.cu`, kept to be timed
    beside the redesign) through the stand-in: its own step count, counts,
    flags and the hits below each count equal the phased loop's; its
    profiling mode clocks every lane's stages."""
    cfg, fm, args = chunk
    seqs, lens, md, hs, ssq, bad = args
    want_h, want_nh, want_fb, want_steps, _ = engine.run_search_phased(
        cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    out_h, nh, fb, counters = engine._launch_search_chunk_first(
        cfg, fm, seqs, big, lens, md, hs, bad, N_LANES, 0)
    assert counters.tolist()[:2] == [0, want_steps]
    assert torch.equal(nh, want_nh) and torch.equal(fb, want_fb)
    assert torch.equal(_masked(out_h.permute(1, 2, 0), nh, fb),
                       _masked(want_h, want_nh, want_fb))
    # mode 2: the same, and a row of stage clocks a lane
    prof = engine._launch_search_chunk_first(
        cfg, fm, seqs, engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq),
        lens, md, hs, bad, N_LANES, 0, 2)[4]
    assert prof.shape == (N_LANES, engine.N_STAGES) and bool((prof > 0).all())


def test_search_chunk_source_stage_clocks(chunk, standin_lib, monkeypatch):
    """Mode 2, the profiling instantiation: the outputs of mode 1, and a
    row of stage clocks a lane, every stage clocked by every lane that
    stepped (on the stand-in the first block's lanes take every read)."""
    cfg, fm, args = chunk
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    one, _ = _standin_chunk(cfg, fm, args, 1)
    two, _ = _standin_chunk(cfg, fm, args, 2)
    for a, b in zip(one, two[:6]):
        assert torch.equal(a, b)
    prof = two[6]
    assert prof.shape == (32, engine.N_STAGES)
    stepped = prof.sum(dim=1) > 0   # the stand-in's first block takes all
    assert bool(stepped.any()) and bool((prof[stepped] > 0).all())


def test_phased_kernel_sources_equal_plain_loop(chunk, standin_lib,
                                                monkeypatch):
    """`csrc/lane_switch.cu` and `csrc/search_step.cu` driving the whole
    phased loop in place on one chunk, through the stand-in, against the
    plain loop: every output word, stale ones included."""
    cfg, fm, args = chunk
    seqs = args[0]
    want_h, want_nh, want_fb, want_steps, _ = engine.run_search_phased(
        cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    ch = engine._plain_chunk(cfg, fm, *args, n_lanes=N_LANES)
    left = ch.N
    while left > 0:
        ch._launch_switch(0)
        engine._launch_search_steps(cfg, fm, seqs, ch.st, engine.SWITCH_K, 0)
        left, steps = ch.sync.tolist()
    assert steps == want_steps
    assert torch.equal(torch.stack(ch.out_h, dim=-1)[:ch.N], want_h)
    assert torch.equal(ch.out_nh[:ch.N], want_nh)
    assert torch.equal(ch.out_fb[:ch.N], want_fb)


@pytest.mark.parametrize("acap", [256, 1024])
@pytest.mark.parametrize("case", ["default", "gappy"])
def test_search_step_source_equals_plain_steps(step_case_sets, standin_lib,
                                               monkeypatch, case, acap):
    """`csrc/search_step.cu` through the stand-in on every state of
    `engine.step_cases` (the capacity edges included), 1 and SWITCH_K steps
    a launch: all 30 fields equal to the plain steps."""
    tfm, sets = step_case_sets
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    for name, cfg, seqs, st in sets[case, acap]:
        for n in (1, engine.SWITCH_K):
            want = engine.clone_state(st)
            for _ in range(n):
                want = engine._search_step(cfg, tfm, seqs, want)
            got = engine.clone_state(st)
            engine._launch_search_steps(cfg, tfm, seqs, got, n, 0)
            for f in engine.FIELDS:
                assert torch.equal(getattr(got, f), getattr(want, f)), \
                    (name, n, f)


def test_lane_switch_source_equals_plain_switch(switch_case_sets,
                                                standin_lib, monkeypatch):
    """`csrc/lane_switch.cu` through the stand-in on every chunk of
    `engine.switch_cases`: the 30 fields, the outputs and the count of
    reads left equal to the plain switch."""
    _, sets = switch_case_sets
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    for acap, cases in sets.items():
        for name, ch in cases:
            want, got = ch.clone(), ch.clone()
            want.switch_plain()
            got._launch_switch(0)
            for f in engine.FIELDS:
                assert torch.equal(getattr(got.st, f), getattr(want.st, f)), \
                    (acap, name, f)
            for g, w in zip(got.out_h + [got.out_nh, got.out_fb],
                            want.out_h + [want.out_nh, want.out_fb]):
                assert torch.equal(g, w), (acap, name)
            assert int(got.remaining) == int(want.remaining)


@pytest.mark.parametrize("acap", [96, 256, 1024])
def test_stack_update_source_equals_plain(standin_lib, acap):
    """`csrc/stack_update.cu` (the arena pass of `csrc/stack_commit.cuh`,
    which the search step runs as its last stage) through the stand-in on
    random planes with ties, full rows and inactive lanes: all 13 outputs
    equal to `stack_update_plain`, at a row shorter than one group of
    chunks, one group and four."""
    from ibwa_tpu_torch.align import stack_kernel as sk
    B = 64
    case = sk.random_case(np.random.default_rng(20261016 + acap), B, acap)
    args = sk.case_tensors(case, "cpu")
    want = sk.stack_update_plain(*args)
    ins = [a.contiguous() for a in args[:9]]
    planes = [a.clone() for a in args[9:]]
    ovf = torch.zeros(B, dtype=torch.bool)
    outs = [torch.zeros(B, dtype=torch.int64) for _ in range(7)]
    rc = standin_lib.ibwa_stack_update(
        *[a.data_ptr() for a in ins + planes], ovf.data_ptr(),
        *[a.data_ptr() for a in outs], B, acap, 0)
    assert rc == 0
    for name, g, w in zip(("key", "sk", "sl", "sm1", "sm2", "ovf", "npush",
                           "pslot", "pkey", "pk", "pl", "pm1", "pm2"),
                          planes + [ovf] + outs, want):
        assert torch.equal(g, w), name


def test_search_routes_by_device(chunk):
    """CPU tensors take the phased loop; `search_chunk` itself is the
    card's; an index on any other device raises."""
    cfg, fm, args = chunk
    seqs, lens, md, hs, ssq, bad = args
    big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    with pytest.raises(ValueError, match="unsupported device"):
        engine.search_chunk(cfg, fm, seqs, big, lens, md, hs, bad)
    meta = dataclasses.replace(fm, blocks=fm.blocks.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        engine.run_search_persistent(cfg, meta, *args, n_lanes=N_LANES)
    with pytest.raises(ValueError, match="unsupported device"):
        engine.search_chunk(cfg, meta, seqs, big, lens, md, hs, bad)


def test_profile_step_stages_through_the_standin(chunk, standin_lib,
                                                 monkeypatch):
    """`ibwa_tpu_torch.profile_step --mode stages`'s measurement, on the
    stand-in build: a stage table of the redesign and of the first version
    (all seven stages, shares that add up to one, clocks an iteration),
    and the lanes and iterations the kernels' counters give; the entry
    point itself refuses a device that is not a card."""
    from ibwa_tpu_torch import profile_step
    cfg, fm, args = chunk
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    for first in (False, True):
        got = profile_step.profile_stages(cfg, fm, args, 0, 1000.0,
                                          first=first, n_lanes=N_LANES)
        assert list(got["stages"]) == list(engine.STAGES)
        shares = [v["share"] for v in got["stages"].values()]
        assert abs(sum(shares) - 1) < 1e-9 and min(shares) > 0
        row = got["stages"]["commit"]
        assert row["per_iteration"] == row["clocks"] / got["iterations"]
        assert row["us_per_iteration"] == row["per_iteration"] / 1000.0
        assert got["lanes"] == N_LANES and 0 < got["longest_lane"]
    assert profile_step.main(["--device", "cpu"]) == 2
