"""K9, the seed extensions of `bwasw` (`ibwa_tpu_torch/ops/dp.py`), against
the JAX package's scan and the native scalar kernel.

The jobs are `tests/test_dp_device.py`'s (random shapes at four seeds and
bands, and jobs shaped as `bsw2_extend_left` makes them), made with numpy
and handed as the native driver hands them over: flat blobs with offsets.
Three implementations must agree exactly, job by job: the port's plain
version (`extend_scan_plain`), `ibwa_tpu.ops.dp.extend_batch` (XLA on the
CPU, one compiled shape for all the jobs) and the port's
`native.extend_aln` (the host kernel of the native driver).  Jobs beyond
the JAX package's compile caps (targets up to ~8,000, queries up to
~3,000) are held against the native kernel alone.  The kernel's source
`csrc/extend_dp.cu` runs through the g++ stand-in of the CUDA runtime
(`tests/cuda_standin`) on grids capped at 1 and 2 blocks and on the
launch's own grid, bitwise equal to the plain version, its counters too,
and so does its first version `csrc/extend_dp_first.cu`.  Six more cases hold the redesign's ring of
cells in shared memory to the host kernel, the JAX scan and the plain
version: bands of 200 and of the widest a ring holds, 251 (several passes
a row), bands of 252 and 700 (the mode with the rows in global memory),
long targets (the ring wraps many times, and a slot read on a first
touch would still hold the cell 512 before), and queries a quarter
substituted, whose band's end shrinks below the cells the rows before
wrote and grows past them again.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ibwa_tpu.ops import dp as jdp

from ibwa_tpu_torch import kernels, native
from ibwa_tpu_torch.ops import dp

from test_torch_chunk import CSRC, STANDIN, standin_source

torch.set_num_threads(1)

SHAPES = [(1, 60, 40, 8), (2, 300, 200, 50), (3, 1500, 1100, 50),
          (4, 25, 90, 33)]          # seed, tmax, qmax, band
CASES = [f"seed{s[0]}" for s in SHAPES] + ["bwasw"]


def _matrix(a=1, b=3):
    m = np.full(25, -b, dtype=np.int32)
    for i in range(4):
        m[i * 5 + i] = a
    return m


def _rand_jobs(rng, n, tmax, qmax, related_frac=0.7):
    """tests/test_dp_device.py's random jobs: `related` ones embed a
    mutated copy of the query in the target so extensions run deep."""
    targets, queries = [], []
    for _ in range(n):
        lt = int(rng.integers(1, tmax))
        lq = int(rng.integers(1, qmax))
        t = rng.integers(0, 4, lt).astype(np.uint8)
        if rng.random() < related_frac and lt > 4:
            q = t[:min(lq, lt)].copy()
            nmut = rng.integers(0, max(len(q) // 8, 1) + 1)
            for _ in range(nmut):
                p = rng.integers(0, len(q))
                q[p] = rng.integers(0, 4)
            if rng.random() < 0.4 and len(q) > 10:
                p = int(rng.integers(2, len(q) - 2))
                q = np.delete(q, p)
        else:
            q = rng.integers(0, 4, lq).astype(np.uint8)
        targets.append(t)
        queries.append(q.astype(np.uint8))
    return targets, queries


def _shape_jobs(seed, tmax, qmax, band):
    rng = np.random.default_rng(seed)
    n = 40
    targets, queries = _rand_jobs(rng, n, tmax, qmax)
    g0 = rng.integers(1, 100, n).astype(np.int32)
    bands = np.full(n, band, dtype=np.int32)
    # a few jobs with tighter per-job bands (opt.bw = min(bw, k))
    bands[::5] = rng.integers(1, band + 1, len(bands[::5]))
    return targets, queries, g0, bands


def _bwasw_jobs():
    """test_dp_device.py's bwasw shapes: G0 from a hit's score, the left
    side's reversed query and target, zero-length edges."""
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 8000).astype(np.uint8)
    targets, queries, g0s = [], [], []
    for _ in range(30):
        lq = int(rng.integers(60, 900))
        p = int(rng.integers(0, len(genome) - lq))
        q = genome[p:p + lq].copy()
        for _ in range(lq // 30):
            q[rng.integers(0, lq)] = rng.integers(0, 4)
        lt = int(rng.integers(0, min(p + lq // 2, 2000) + 1))
        targets.append(np.ascontiguousarray(genome[max(p - lt, 0):p][::-1]))
        queries.append(np.ascontiguousarray(q[::-1]))
        g0s.append(int(rng.integers(1, lq)))
    return (targets, queries, np.array(g0s, dtype=np.int32),
            np.full(len(targets), 50, dtype=np.int32))


def _long_jobs():
    """Beyond the JAX package's caps (L1_CAP 4,096, L2 <= 2,048): long
    related targets and queries, and a narrow band."""
    rng = np.random.default_rng(17)
    targets, queries = [], []
    for lt, lq in ((8000, 3000), (5000, 2500), (7000, 2200), (4500, 900)):
        t = rng.integers(0, 4, lt).astype(np.uint8)
        q = t[:lq].copy()
        for _ in range(lq // 25):
            q[rng.integers(0, lq)] = rng.integers(0, 4)
        targets.append(t)
        queries.append(q)
    return (targets, queries, np.array([40, 5, 90, 12], dtype=np.int32),
            np.array([50, 50, 7, 50], dtype=np.int32))


def _related(rng, t, lq, mut):
    """A query: the target's first lq bases, a share `mut` substituted."""
    q = t[:lq].copy()
    hit = rng.random(len(q)) < mut
    q[hit] = rng.integers(0, 4, int(hit.sum()))
    return q


def _wide_jobs(band):
    """Rows wider than a pass of the warp: G0 in the hundreds keeps cells
    far off the diagonal positive, so the band, not the score, bounds a
    row; a few jobs have narrower bands."""
    rng = np.random.default_rng(band)
    targets, queries = [], []
    for _ in range(10):
        t = rng.integers(0, 4, int(rng.integers(300, 2500))).astype(np.uint8)
        targets.append(t)
        queries.append(_related(rng, t, int(rng.integers(100, 1200)), 0.03))
    bands = np.full(10, band, dtype=np.int32)
    bands[::4] = rng.integers(1, band + 1, 3)
    return (targets, queries, rng.integers(200, 1500, 10).astype(np.int32),
            bands)


def _wrap_jobs():
    """Long targets, so the ring (512 cells) wraps up to 8 times: narrow
    bands on related queries; and unrelated queries with a G0 in the
    hundreds, where the band's start is its bound, so the cells it leaves
    behind hold large values, and the score dies out after 500-900 rows.
    There a slot read on a cell's first touch still holds the cell 512
    before: were it read, the job would run ~400 rows longer."""
    rng = np.random.default_rng(41)
    targets, queries, g0, bands = [], [], [30, 9], [12, 3]
    for lt, lq in ((4000, 3000), (3500, 2000)):
        t = rng.integers(0, 4, lt).astype(np.uint8)
        targets.append(t)
        queries.append(_related(rng, t, lq, 0.04))
    for seed in (3000, 3001):
        rng = np.random.default_rng(seed)
        bands.append(int(rng.integers(30, 100)))
        g0.append(int(rng.integers(600, 1300)))
        targets.append(rng.integers(0, 4, 2500).astype(np.uint8))
        queries.append(rng.integers(0, 4, 1500).astype(np.uint8))
    return (targets, queries, np.array(g0, dtype=np.int32),
            np.array(bands, dtype=np.int32))


def _regrow_jobs():
    """Queries a quarter substituted: the score stays low, the band's end
    shrinks to the last positive cell + 3, below the frontier of cells
    written, and grows past it again (`_frontier_events`)."""
    rng = np.random.default_rng(43)
    targets, queries = [], []
    for _ in range(8):
        t = rng.integers(0, 4, 1500).astype(np.uint8)
        targets.append(t)
        queries.append(_related(rng, t, 900, 0.25))
    return (targets, queries, rng.integers(20, 60, 8).astype(np.int32),
            np.array([40, 40, 40, 40, 25, 60, 40, 40], dtype=np.int32))


NEW_CASES = {"band200": lambda: _wide_jobs(200),
             "ringband": lambda: _wide_jobs(251),
             "band252": lambda: _wide_jobs(252),
             "band700": lambda: _wide_jobs(700),
             "wrap": _wrap_jobs, "regrow": _regrow_jobs}


def _jobs(case):
    if case == "bwasw":
        return _bwasw_jobs()
    if case == "long":
        return _long_jobs()
    if case in NEW_CASES:
        return NEW_CASES[case]()
    return _shape_jobs(*SHAPES[int(case[4:]) - 1])


def _frontier_events(t, q, g0, band, mat, gap_open=5, gap_ext=2):
    """The host kernel's band walk in Python (core.cpp's loop): the rows
    whose end lies below the highest cell written before, and the rows
    whose end grows past it after such a row."""
    len1 = len(t)
    h_, e_ = [0] * (len1 + 2), [0] * (len1 + 2)
    h_[1] = int(g0)
    start, end, hi, below, past = 1, 2, 1, 0, 0
    qr, r, shrunk = gap_open + gap_ext, gap_ext, False
    for j in range(1, len(q) + 1):
        start = max(start, j - band, 1)
        end = min(end, j + band, len1 + 1)
        if start == end:
            break
        if end < hi:
            below += 1
            shrunk = True
        elif end > hi and shrunk:
            past += 1
            shrunk = False
        h1 = f = nstart = nend = 0
        for i in range(start, end):
            h, e = h_[i], e_[i]
            h_[i] = h1
            h = max(h + int(mat[5 * q[j - 1] + t[i - 1]]) if h else 0, e, f)
            h1 = h
            if h > 0:
                nstart = nstart or i
                nend = i
            g = max(h - qr, 0)
            e_[i] = max(e - r, g)
            f = max(f - r, g)
        h_[end], e_[end] = h1, 0
        hi = max(hi, end)
        if nend <= 0:
            break
        start, end = nstart, nend + 3
    return below, past


def _blobs(seqs):
    off = np.zeros(len(seqs) + 1, dtype=np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    blob = np.concatenate(seqs) if off[-1] else np.zeros(0, np.uint8)
    return blob.astype(np.uint8), off


def _native(targets, queries, g0, bands, mat):
    return np.array([native.extend_aln(t, q, 5, 2, int(b), mat.reshape(5, 5),
                                       int(g))
                     for t, q, g, b in zip(targets, queries, g0, bands)],
                    dtype=np.int32).reshape(-1, 3)


def _tensors(case):
    """The case's batch as CPU tensors, the jobs the device runs, and the
    matrix."""
    targets, queries, g0, bands = _jobs(case)
    mat = _matrix()
    tb, to = _blobs(targets)
    qb, qo = _blobs(queries)
    ids, host = dp.device_jobs(to, qo, g0, mat)
    assert not len(host)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(tb), t(to), t(qb), t(qo), t(g0), t(bands), t(ids)), mat


@pytest.fixture(scope="module")
def jax_results():
    """ibwa_tpu's extend_batch on every job of CASES in one call (one
    compiled shape), split back by case."""
    jobs = [_jobs(c) for c in CASES]
    got = jdp.extend_batch(
        [t for j in jobs for t in j[0]], [q for j in jobs for q in j[1]],
        np.concatenate([j[2] for j in jobs]),
        np.concatenate([j[3] for j in jobs]), _matrix(), 5, 2)
    cut = np.cumsum([0] + [len(j[0]) for j in jobs])
    return {c: got[a:b] for c, a, b in zip(CASES, cut, cut[1:])}


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_jax_and_native(jax_results, case):
    """extend_scan_plain through `extend_jobs` on the CPU, job by job equal
    to ibwa_tpu's scan and to the host kernel (empty jobs included)."""
    targets, queries, g0, bands = _jobs(case)
    mat = _matrix()
    tb, to = _blobs(targets)
    qb, qo = _blobs(queries)
    got, counts = dp.extend_jobs(tb, to, qb, qo, g0, bands, mat, 5, 2, "cpu")
    want = _native(targets, queries, g0, bands, mat)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_results[case])
    empty = sum(1 for t, q in zip(targets, queries) if not len(t) * len(q))
    assert counts["device"] == len(targets) - empty and counts["gate"] == 0
    assert counts["stats"][0] == counts["device"]
    assert (got[:, 0] > 0).sum() > len(targets) // 2   # extensions ran


def test_plain_beyond_the_jax_caps():
    """Jobs the JAX package sent to the host for their lengths run on the
    device route like any other, equal to the host kernel."""
    targets, queries, g0, bands = _long_jobs()
    mat = _matrix()
    tb, to = _blobs(targets)
    qb, qo = _blobs(queries)
    got, counts = dp.extend_jobs(tb, to, qb, qo, g0, bands, mat, 5, 2, "cpu")
    np.testing.assert_array_equal(
        got, _native(targets, queries, g0, bands, mat))
    assert counts["device"] == 4 and counts["stats"][3] > 2048
    assert got[0, 2] > 2048 and got[0, 0] > 2000


@pytest.mark.parametrize("case", list(NEW_CASES))
def test_ring_cases_plain_equals_jax_and_native(case):
    """The redesign's cases (wide bands, the ring's wraps, the band's end
    regrowing over stale cells) through `extend_jobs` on the CPU, job by
    job equal to ibwa_tpu's scan and to the host kernel; the regrowth
    case does regrow."""
    targets, queries, g0, bands = _jobs(case)
    mat = _matrix()
    tb, to = _blobs(targets)
    qb, qo = _blobs(queries)
    got, counts = dp.extend_jobs(tb, to, qb, qo, g0, bands, mat, 5, 2, "cpu")
    np.testing.assert_array_equal(
        got, _native(targets, queries, g0, bands, mat))
    np.testing.assert_array_equal(
        got, jdp.extend_batch(targets, queries, g0, bands, mat, 5, 2))
    assert counts["device"] == len(targets) and counts["gate"] == 0
    assert (got[:, 0] > 0).all()
    if case == "regrow":
        events = [_frontier_events(t, q, g, b, mat)
                  for t, q, g, b in zip(targets, queries, g0, bands)]
        assert sum(x for x, _ in events) > 20
        assert sum(1 for _, y in events if y) >= 4


def test_gate_and_empty_jobs_go_to_the_host():
    """Jobs whose score could reach the host kernel's 16-bit rescale
    (G0 + qlen max(matrix) >= 30000) run the host kernel, which rescales,
    and are counted; empty jobs give (-1, 0, 0) and run nowhere."""
    rng = np.random.default_rng(23)
    t = rng.integers(0, 4, 3000).astype(np.uint8)
    q = t[:2500].copy()
    targets = [t, t, t[:0], t[:100], t]
    queries = [q, q[:100], q, q[:0], q[:40]]
    g0 = np.array([30500, 29950, 5, 5, 29959], dtype=np.int32)
    bands = np.full(5, 50, dtype=np.int32)
    mat = _matrix()
    assert not dp.extend_gate_ok(100, 29950, 1)
    assert dp.extend_gate_ok(40, 29959, 1)
    tb, to = _blobs(targets)
    qb, qo = _blobs(queries)
    got, counts = dp.extend_jobs(tb, to, qb, qo, g0, bands, mat, 5, 2, "cpu")
    np.testing.assert_array_equal(
        got, _native(targets, queries, g0, bands, mat))
    assert got[0, 0] > 32000           # past the rescale threshold
    assert (counts["device"], counts["gate"]) == (1, 2)
    assert got[2].tolist() == got[3].tolist() == [-1, 0, 0]


def test_extend_scan_checks_its_inputs():
    """A device that is neither the CPU nor CUDA raises, as does a wrong
    dtype; nothing falls back."""
    args, mat = _tensors("seed1")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        dp.extend_scan(*meta, mat, 5, 2)
    bad = list(args)
    bad[4] = bad[4].to(torch.int64)
    with pytest.raises(ValueError, match="contiguous"):
        dp.extend_scan(*bad, mat, 5, 2)


@pytest.fixture(scope="module")
def dp_standin(tmp_path_factory):
    """`csrc/extend_dp.cu` and its first version `csrc/extend_dp_first.cu`
    built with g++ over the stand-in header, loaded as `kernels.lib()`
    would load the nvcc build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source with")
    out = tmp_path_factory.mktemp("dp_standin")
    cpps = []
    for name in ("extend_dp", "extend_dp_first"):
        cpp = out / f"{name}.cpp"
        cpp.write_text(standin_source((CSRC / f"{name}.cu").read_text()))
        cpps.append(str(cpp))
    so = out / "libibwa_dp_standin.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(STANDIN), "-I", str(CSRC), "-o", str(so), *cpps],
                   check=True)
    handle = ctypes.CDLL(str(so))
    for entry in ("ibwa_extend_dp", "ibwa_extend_dp_first",
                  "ibwa_extend_dp_info"):
        fn = getattr(handle, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return handle


GRIDS = [(c, g) for c in CASES for g in (1, 2, 0)] + [("long", 0)]


@pytest.mark.parametrize("case,max_blocks", GRIDS + [
    (c, 8) for c in CASES] + [(c, g) for c in NEW_CASES for g in (1, 0)])
def test_kernel_source_equals_plain(dp_standin, monkeypatch, case,
                                   max_blocks):
    """K9's source through the stand-in, against extend_scan_plain:
    bitwise, on the launch's own grid (on the stand-in card 6 blocks, 48
    warps, for a batch that fills it), on grids set to 1 and 2 blocks,
    where warps take their second and later jobs from the queue (and find
    on their ring the cells of the jobs before), and on one of 8 blocks,
    more than the launch's own; rows, cells and the longest job's rows
    equal the plain version's.  The jobs beyond the JAX caps run on the
    launch's grid; the wide bands, the ring's wraps and the regrowth on a
    grid of 1 and the launch's.  Every job of a batch whose bands a ring
    holds runs on a ring, of any other on a row in global memory."""
    args, mat = _tensors(case)
    want, wst = dp.extend_scan_plain(
        *args, torch.from_numpy(mat.astype(np.int64)), 5, 2)
    monkeypatch.setattr(kernels, "lib", lambda: dp_standin)
    before = kernels.launches["extend_dp"]
    got, st = dp._launch_extend(*args, mat, 5, 2, 0, max_blocks)
    assert kernels.launches["extend_dp"] == before + 1
    assert torch.equal(got, want)
    queue, rows, cells, longest, on_rings, on_rows = st.tolist()
    m = len(args[6])
    grid = dp.extend_dp_info(m)["grid"]
    assert queue == m + 8 * (min(max_blocks, -(-m // 8)) if max_blocks
                             else grid)
    assert [rows, cells, longest] == wst[1:].tolist()
    wide = int(args[5][args[6].long()].max()) > dp.RING_BAND
    assert (on_rings, on_rows) == ((0, m) if wide else (m, 0))


def test_extend_dp_info(dp_standin, monkeypatch):
    """The launch's shape: 8 warps of 4 cells a lane; a ring of 512 cells
    holds a band of 251 (a row touches 2 band + 9 cells: the row, the two
    it zeroes past its end and the quads' overhang), which is
    `dp.RING_BAND`, the mode's switch; the rings and the matrix in static
    shared memory; a grid of 3 blocks an SM, or as many as the batch has
    whole blocks an SM (at least one), and never more blocks than the jobs
    need (the stand-in card has 2 SMs: 24 jobs are 3 blocks, one an SM;
    32 jobs are 4, two an SM; 48 are 6, three)."""
    monkeypatch.setattr(kernels, "lib", lambda: dp_standin)
    assert dp.extend_dp_info() == {
        "warps": 8, "cells_a_lane": 4, "ring_cells": 512, "ring_band": 251,
        "blocks_an_sm": 3, "grid": 6, "smem_bytes": (8 * 512 + 25) * 4}
    assert dp.RING_BAND == 251
    for jobs, per_sm, grid in ((1, 1, 1), (16, 1, 2), (24, 1, 2),
                               (32, 2, 4), (48, 3, 6), (1000, 3, 6)):
        info = dp.extend_dp_info(jobs)
        assert (info["blocks_an_sm"], info["grid"]) == (per_sm, grid), jobs


@pytest.mark.parametrize("case,max_blocks", GRIDS)
def test_first_version_source_equals_plain(dp_standin, monkeypatch, case,
                                           max_blocks):
    """K9's first version (kept to be timed beside the redesign) through
    the stand-in, against extend_scan_plain, as the redesign is held:
    bitwise, its counters too; it counts its own launches."""
    args, mat = _tensors(case)
    want, wst = dp.extend_scan_plain(
        *args, torch.from_numpy(mat.astype(np.int64)), 5, 2)
    monkeypatch.setattr(kernels, "lib", lambda: dp_standin)
    before = dict(kernels.launches)
    got, st = dp._launch_extend_first(*args, mat, 5, 2, 0, max_blocks)
    assert kernels.launches["extend_dp_first"] == \
        before.get("extend_dp_first", 0) + 1
    assert kernels.launches["extend_dp"] == before.get("extend_dp", 0)
    assert torch.equal(got, want)
    queue, rows, cells, longest = st.tolist()
    warps = 8 * (max_blocks or 8)
    assert queue == len(args[6]) + min(warps, -(-len(args[6]) // 8) * 8)
    assert [rows, cells, longest] == wst[1:].tolist()
