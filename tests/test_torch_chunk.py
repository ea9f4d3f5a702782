"""ibwa_tpu_torch's one-launch chunk search against its plain version, the
phased loop, on the CPU.

* the premise the kernel rests on: what the phased loop finds (hit counts,
  fallback flags, the hits below each count) does not depend on SWITCH_K,
  only its step count does, and `engine.chunk_steps` gives that count from
  each read's own iterations, for SWITCH_K 1, 4 and 16 and at the loop's
  iteration bound;
* the kernel's source itself: `csrc/search_chunk.cu` (and the phased
  kernels `csrc/search_step.cu` / `csrc/lane_switch.cu`, which share its
  device code) built with g++ against `tests/cuda_standin/cuda_runtime.h`,
  a header that stands in for the CUDA runtime, and run on CPU tensors
  against the plain loop;
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
from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.fm import device as tdev

from test_torch_engine import small_index, step_case_sets  # noqa: F401
from test_torch_switch import (N_LANES, N_READS, chunk_inputs,  # noqa: F401
                               switch_case_sets)

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
    hits, nh, fb, steps = engine.run_search_persistent(cfg, fm, *args,
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
        _, _, fb, steps = engine.run_search_persistent(cfg, fm, *args,
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
    a kernel launch becomes a call, dynamic shared memory a pointer."""
    text = re.sub(r"(\w+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"cuda_standin::launch(\2, [&] { \1(\3); });", text,
                  flags=re.S)
    return re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)cuda_standin::dynamic_smem();", text)


STANDIN_ENTRIES = {"search_chunk": "ibwa_search_chunk",
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
    for entry in STANDIN_ENTRIES.values():
        fn = getattr(handle, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return handle


@pytest.mark.parametrize("acap,mode,k", [
    (256, 1, 16), (256, 0, 16), (1024, 0, 16), (1024, 1, 16), (256, 1, 4),
    (256, 1, 1)])
def test_search_chunk_source_equals_phased_loop(chunk, standin_lib,
                                                monkeypatch, acap, mode, k):
    """`csrc/search_chunk.cu`, run on the CPU through the stand-in, against
    the plain phased loop: hit counts, fallback flags, steps, the hits
    below each count, and the reads' planes where the search changed
    them.  With and without the step's rows asked ahead, at both arena
    sizes, and at
    phases of 16, 4 and 1 steps (the shorter the phase, the more reads end
    on its last step, where the kernel's clock is easiest to get wrong)."""
    cfg, fm, args = chunk
    cfg = dataclasses.replace(cfg, acap=acap)
    monkeypatch.setattr(engine, "SWITCH_K", k)
    seqs, lens, md, hs, ssq, bad = args
    want_h, want_nh, want_fb, want_steps = engine.run_search_phased(
        cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    before = kernels.launches["search_chunk"]
    big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    out_h, nh, fb, counters = engine._launch_search_chunk(
        cfg, fm, seqs, big, lens, md, hs, bad, N_LANES, 0, mode)
    assert kernels.launches["search_chunk"] == before + 1
    left, steps, longest, total, rows = counters.tolist()
    assert (left, steps) == (0, want_steps)
    # at most two rows for the occ4 bounds and two per base of the E-chain
    assert 0 < rows <= 2 * total * engine.E_UNROLL and rows % 2 == 0
    assert torch.equal(nh, want_nh) and torch.equal(fb, want_fb)
    hits = out_h.permute(1, 2, 0)
    assert torch.equal(_masked(hits, nh, fb),
                       _masked(want_h, want_nh, want_fb))
    assert bool((hits == _masked(hits, nh, torch.zeros_like(fb))).all())
    assert 0 < longest <= total <= N_LANES * longest
    # in place: gap_shadow changed the rows of reads with hits, no others
    fresh = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    changed = (big[0] != fresh[0]).flatten(1).any(dim=1)
    assert bool(changed.any()) and not bool(changed[nh == 0].any())
    assert torch.equal(big[2], engine._pack_meta(big[0], big[1]))


def test_search_chunk_source_at_the_iteration_bound(chunk, standin_lib,
                                                    monkeypatch):
    """The kernel's clock at the loop's bound: lanes stop, reads stay
    unflushed, the step count is the bound."""
    cfg, fm, args = chunk
    seqs, lens, md, hs, ssq, bad = args
    monkeypatch.setattr(engine, "MAX_ITERS", 5)
    _, want_nh, want_fb, want_steps = engine.run_search_phased(
        cfg, fm, *args, n_lanes=N_LANES)
    monkeypatch.setattr(kernels, "lib", lambda: standin_lib)
    big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    _, nh, _, counters = engine._launch_search_chunk(
        cfg, fm, seqs, big, lens, md, hs, bad, N_LANES, 0)
    left, steps = counters.tolist()[:2]
    assert left > 0 and steps == want_steps == 48 and bool(want_fb.all())
    assert torch.equal(nh, want_nh)


def test_phased_kernel_sources_equal_plain_loop(chunk, standin_lib,
                                                monkeypatch):
    """`csrc/lane_switch.cu` and `csrc/search_step.cu` driving the whole
    phased loop in place on one chunk, through the stand-in, against the
    plain loop: every output word, stale ones included."""
    cfg, fm, args = chunk
    seqs = args[0]
    want_h, want_nh, want_fb, want_steps = engine.run_search_phased(
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
        engine.search_chunk(cfg, fm, seqs, big, lens, md, hs, bad, N_LANES)
    meta = dataclasses.replace(fm, blocks=fm.blocks.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        engine.run_search_persistent(cfg, meta, *args, n_lanes=N_LANES)
    with pytest.raises(ValueError, match="unsupported device"):
        engine.search_chunk(cfg, meta, seqs, big, lens, md, hs, bad, N_LANES)
