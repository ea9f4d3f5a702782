"""ibwa_tpu_torch's `aln` over several devices against ibwa_tpu's, on the CPU.

* the sharded-index search (`parallel/mesh.py::run_sharded_index_search`,
  the block table split by rows over an idx group; on CPU tensors the plain
  version of B8, `fm/device.py::gather_rows_sharded`) against
  `ibwa_tpu.parallel.mesh.run_sharded_index_search` on 8 virtual CPU
  devices, test_sharded_index.py's problem, at n_idx 2 and 4, and against
  the port's flat search: hits, hit counts and fallback flags, bitwise;
* the `dp` engine (`TorchAlnEngine` over several entries; the same device
  named several times) against one entry and against
  `engine_jax.JaxAlnEngine` on a 2-device CPU mesh, and `aln --device
  cpu,cpu` against `--device cpu`: hit lists and .sai bytes equal;
* the port's `dryrun_multichip` over 4 CPU entries;
* the kernels' sources: the sharded instantiations of `csrc/width_pass.cu`
  and `csrc/search_chunk.cu` built with g++ over the stand-in header
  (tests/cuda_standin) against their flat instantiations and the plain
  versions, at n_idx 2 and 4, bitwise;
* no fallback: a range on a card the launching card cannot reach raises.
Exact comparison everywhere: this is integer search.
"""

import ctypes
import dataclasses
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
from ibwa_tpu.align import engine_jax
from ibwa_tpu.fm.fmindex import FmIndex as JFmIndex
from ibwa_tpu.index.builder import build_bwt_index as j_build_bwt_index
from ibwa_tpu.parallel import mesh as jmesh

from ibwa_tpu_torch import cli, kernels
from ibwa_tpu_torch.align import engine
from ibwa_tpu_torch.convert import fm_from_numpy
from ibwa_tpu_torch.fm import device as tdev
from ibwa_tpu_torch.parallel import mesh

from test_sharded_index import _problem
from test_torch_aln import aln_inputs, genome_index  # noqa: F401
from test_torch_chunk import CSRC, STANDIN, chunk, standin_source  # noqa
from test_torch_engine import small_index  # noqa: F401 (fixture)
from test_torch_switch import (N_LANES, chunk_inputs,  # noqa: F401
                               chunk_reads)

torch.set_num_threads(1)


def _padded(jdfm, n_idx: int):
    """test_sharded_index.py's padding: zero rows to a multiple of n_idx
    (never addressed)."""
    pad = (-jdfm.blocks.shape[0]) % n_idx
    if pad:
        jdfm.blocks = np.concatenate(
            [np.asarray(jdfm.blocks), np.zeros((pad, 12), np.uint32)])
    return jdfm


@pytest.fixture(scope="module", params=[2, 4], ids=["idx2", "idx4"])
def jax_sharded(request):
    """ibwa_tpu's sharded-index search at n_idx = param over 8 virtual CPU
    devices (8 / n_idx dp groups), 8 lanes: its one JAX call."""
    n_idx = request.param
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest asks XLA for 8 host devices"
    old = engine_jax.PALLAS_STACK
    engine_jax.PALLAS_STACK = False
    try:
        dfm, cfg, batch = _problem()
        dfm = _padded(dfm, n_idx)
        got = jmesh.run_sharded_index_search(
            cfg, jmesh.make_mesh_2d(8 // n_idx, n_idx, devices=devs[:8]),
            dfm, *batch, n_lanes=8)
    finally:
        engine_jax.PALLAS_STACK = old
    return n_idx, dfm, batch, tuple(np.asarray(a) for a in got)


def _port_cfg(batch):
    """The port's config of test_sharded_index.py's problem."""
    seqs, lens, md = batch[:3]
    return engine.make_config(seqs.shape[-1], int(md.max()),
                              engine.GapOpt())


def test_sharded_index_search_matches_jax(jax_sharded):
    n_idx, jdfm, batch, (j_hits, j_nh, j_fb, _) = jax_sharded
    tfm = fm_from_numpy(jdfm)
    cfg = _port_cfg(batch)
    grid = mesh.make_mesh_2d(8 // n_idx, n_idx, devices=["cpu"] * 8)
    hits, nh, fb, it = mesh.run_sharded_index_search(cfg, grid, tfm, *batch,
                                                     n_lanes=8)
    assert it.shape == (8 // n_idx,)
    np.testing.assert_array_equal(nh.numpy(), j_nh)
    np.testing.assert_array_equal(fb.numpy(), j_fb)
    assert int(j_nh.sum()) > 0 and not j_fb.any()
    for i in range(len(j_nh)):
        np.testing.assert_array_equal(hits[i, :j_nh[i]].numpy(),
                                      j_hits[i, :j_nh[i]].astype(np.int64))
    # ... and the port's flat search of the whole batch on one device
    flat = engine.run_search_persistent(
        cfg, tfm, *(torch.as_tensor(np.asarray(a)).to(
            torch.int64 if np.asarray(a).dtype == np.int32 else None)
            for a in batch), n_lanes=8)
    assert torch.equal(flat[1], nh) and torch.equal(flat[2], fb)
    assert torch.equal(engine.masked_hits(flat[0], flat[1], flat[2]),
                       engine.masked_hits(hits, nh, fb))


def test_sharded_rows_refused_when_they_do_not_divide(jax_sharded):
    """As ibwa_tpu's: a table whose rows do not divide n_idx is refused
    (the padded table less one row)."""
    n_idx, jdfm, batch, _ = jax_sharded
    tfm = fm_from_numpy(jdfm)
    tfm = dataclasses.replace(tfm, blocks=tfm.blocks[:-1])
    grid = mesh.make_mesh_2d(1, n_idx, devices=["cpu"] * n_idx)
    with pytest.raises(ValueError, match="not divisible by idx"):
        mesh.run_sharded_index_search(_port_cfg(batch), grid, tfm, *batch,
                                      n_lanes=8)


@pytest.mark.parametrize("n_idx", [2, 3, 4])
def test_gather_rows_sharded_equals_flat_rows(small_index, n_idx):
    """The plain B8 over every row of a table split in n_idx ranges (the
    last one padded) equals the flat table's rows; the ranges are copies
    of their own."""
    fms, _ = small_index
    fm = tdev.build_device_pair(fms[0], fms[1], "cpu")
    sp = tdev.shard_pair(fm, ["cpu"] * n_idx)
    rows = fm.blocks.shape[0]
    assert sp.blocks is None and len(sp.shards) == n_idx
    assert sp.shard_rows == -(-rows // n_idx)
    assert all(s.shape == (sp.shard_rows, 4 + fm.wpb) for s in sp.shards)
    assert len({s.data_ptr() for s in sp.shards}) == n_idx
    flat = torch.arange(rows, dtype=torch.int64)
    got = tdev.gather_rows_sharded(sp, flat)
    assert torch.equal(got, fm.blocks.to(torch.int64) & 0xFFFFFFFF)
    # the table's other users refuse a split table (K2's entries, walker)
    with pytest.raises(ValueError, match="split"):
        tdev._check_cuda_table(sp)


def _jax_fms(glen=2048):
    """tiny_problem's genome indexed by ibwa_tpu."""
    rng = random.Random(7)
    seq = np.array([rng.randrange(4) for _ in range(glen)], dtype=np.uint8)
    return (JFmIndex(j_build_bwt_index(seq)),
            JFmIndex(j_build_bwt_index(seq[::-1].copy())))


@pytest.fixture(scope="module")
def dp_problem():
    """40 reads of tiny_problem's genome, and the JAX engine's hit lists
    over a 2-device CPU mesh at the dryrun's geometry (8 lanes, 8 reads a
    chunk a device): its one JAX call."""
    fms, opt, seqs, rseqs = mesh.tiny_problem(n_reads=40, read_len=36,
                                              glen=2048)
    old = (engine_jax.DEV_BATCH, engine_jax.PERSIST_N,
           engine_jax.PALLAS_STACK)
    engine_jax.DEV_BATCH, engine_jax.PERSIST_N = 8, 8
    engine_jax.PALLAS_STACK = False
    try:
        eng = engine_jax.JaxAlnEngine(_jax_fms(),
                                      devices=jax.devices("cpu")[:2])
        assert eng.mesh is not None
        want = eng.align_batch(seqs, rseqs, opt)
    finally:
        (engine_jax.DEV_BATCH, engine_jax.PERSIST_N,
         engine_jax.PALLAS_STACK) = old
    return fms, opt, seqs, rseqs, [[dataclasses.astuple(h) for h in r]
                                   for r in want]


@pytest.mark.parametrize("devices,n_idx,n_dev", [
    ("cpu", 1, 1), (["cpu"] * 2, 1, 2), (["cpu"] * 3, 1, 3),
    ("cpu,cpu,cpu,cpu", 2, 2)], ids=["one", "dp2", "dp3", "dp2xidx2"])
def test_engine_entries_match_one_device_and_jax(dp_problem, monkeypatch,
                                                 devices, n_idx, n_dev):
    """The dp engine at the dryrun's geometry: 40 reads are 3 chunks over
    2 entries (16, 16, 8: the tail on entry 0 alone) and 2 over 3 (24, 16:
    entry 2 idle in the tail); the idx case splits each entry's table over
    2 devices.  Hit lists equal the JAX engine's on a 2-device mesh."""
    fms, opt, seqs, rseqs, want = dp_problem
    monkeypatch.setattr(engine, "DEV_BATCH", 8)
    monkeypatch.setattr(engine, "PERSIST_N", 8)
    launch = engine.launch_search
    sizes = []

    def launch_rec(cfg, fm, *a, **k):
        sizes.append((len(fm.shards), a[0].shape[0]))
        return launch(cfg, fm, *a, **k)

    monkeypatch.setattr(engine, "launch_search", launch_rec)
    eng = engine.TorchAlnEngine(fms, devices, n_idx=n_idx)
    try:
        got = eng.align_batch(seqs, rseqs, opt)
    finally:
        eng.close()
    assert len(eng.dfms) == n_dev
    expect = []
    for lo in range(0, 40, 8 * n_dev):
        expect += [min(8, 40 - a) for a in range(lo, min(lo + 8 * n_dev, 40),
                                                 8)]
    assert [s for _, s in sizes] == expect
    assert {n for n, _ in sizes} == {0 if n_idx == 1 else n_idx}
    assert [[dataclasses.astuple(h) for h in r] for r in got] == want
    assert eng.stats["device_reads"] == 40


def test_engine_copies_the_table_per_entry():
    """The same card named twice holds two tables; "cuda" without a card
    raises instead of falling back."""
    fms, _, _, _ = mesh.tiny_problem(n_reads=1, glen=2048)
    eng = engine.TorchAlnEngine(fms, "cpu,cpu")
    try:
        a, b = eng.dfms
        assert a.blocks.data_ptr() != b.blocks.data_ptr()
        assert torch.equal(a.blocks, b.blocks)
        assert eng.streams == [None, None]
    finally:
        eng.close()
    assert engine.devices_of("cpu, cpu") == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.devices_of("cuda")
    with pytest.raises(ValueError, match="groups of n_idx"):
        engine.TorchAlnEngine(fms, "cpu,cpu,cpu", n_idx=2)


def test_aln_device_list_sai_equal(aln_inputs, tmp_path, monkeypatch):
    """`aln --device cpu,cpu` (two entries, 96 reads in chunks of 32
    split 16 / 16) and `--device cpu,cpu --idx 2` (one entry, its table
    split in two) write the .sai of `--device cpu` and of ibwa_tpu."""
    fa, fq, want = aln_inputs
    monkeypatch.setattr(engine, "DEV_BATCH", 16)
    monkeypatch.setattr(engine, "PERSIST_N", 16)
    outs = []
    for args in (["--device", "cpu"], ["--device", "cpu,cpu"],
                 ["--device", "cpu,cpu", "--idx", "2"]):
        out = tmp_path / f"{len(outs)}.sai"
        assert cli.main(["aln", *args, str(fa), str(fq), "-f",
                         str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2] == want


def test_dryrun_multichip(capsys):
    mesh.dryrun_multichip(4, device="cpu")
    assert "[dryrun] 4 entries" in capsys.readouterr().out


def test_peer_access_refused_without_fallback(monkeypatch):
    """A range on a card the launching card cannot reach: shard_pair
    raises before anything is copied or launched."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    with pytest.raises(ValueError, match="no peer access"):
        tdev.enable_peer("cuda:0", "cuda:1")
    with pytest.raises(ValueError, match="not cards"):
        tdev.enable_peer("cuda:0", "cpu")
    tdev.enable_peer("cuda:1", "cuda:1")   # the same card: nothing to do
    fm = tdev.build_device_pair(*mesh.tiny_problem(1, glen=2048)[0], "cpu")
    with pytest.raises(ValueError, match="devices of one kind"):
        tdev.shard_pair(fm, ["cpu", "cuda:0"])


MESH_ENTRIES = {"search_chunk": "ibwa_search_chunk",
                "width_pass": "ibwa_width_pass"}


@pytest.fixture(scope="module")
def mesh_standin(tmp_path_factory):
    """`csrc/search_chunk.cu` and `csrc/width_pass.cu` built with g++
    over the stand-in header, loaded as `kernels.lib()` loads the nvcc
    build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' sources with")
    out = tmp_path_factory.mktemp("mesh_standin")
    cpps = []
    for name in MESH_ENTRIES:
        cpp = out / f"{name}.cpp"
        cpp.write_text(standin_source((CSRC / f"{name}.cu").read_text()))
        cpps.append(str(cpp))
    so = out / "libibwa_mesh_standin.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(STANDIN), "-I", str(CSRC), "-o", str(so),
                    *cpps], check=True)
    handle = ctypes.CDLL(str(so))
    for entry in (*MESH_ENTRIES.values(), "ibwa_width_pass_sharded"):
        fn = getattr(handle, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return handle


@pytest.mark.parametrize("n_idx", [2, 4])
def test_sharded_sources_equal_flat_and_plain(chunk, mesh_standin,
                                              monkeypatch, n_idx):
    """The sharded instantiations of the width pass and of the chunk
    search, through the stand-in, on test_torch_chunk's chunk (96 reads,
    32 lanes, reads that overflow the step budget) with its table split in
    n_idx ranges: bitwise the flat instantiations' and the plain
    versions' (flat and split) planes, counts, flags, steps and hits."""
    cfg, fm, args = chunk
    seqs, lens, md, hs, ssq, bad = args
    sp = tdev.shard_pair(fm, ["cpu"] * n_idx)
    plain_big = engine.big_planes_plain(cfg, fm, seqs, lens, hs, ssq)
    plain_split = engine.big_planes_plain(cfg, sp, seqs, lens, hs, ssq)
    want_h, want_nh, want_fb, want_steps, want_cause = \
        engine.run_search_phased(cfg, fm, *args, n_lanes=N_LANES)
    split = engine.run_search_phased(cfg, sp, *args, n_lanes=N_LANES)
    assert split[3] == want_steps and torch.equal(split[4], want_cause)
    assert torch.equal(split[1], want_nh) and torch.equal(split[2], want_fb)

    monkeypatch.setattr(kernels, "lib", lambda: mesh_standin)
    kernels.reset_launches()
    flat_big = engine._launch_width_pass(cfg, fm, seqs, lens, hs, ssq, 0)
    shard_big = engine._launch_width_pass(cfg, sp, seqs, lens, hs, ssq, 0)
    for a, b, c, d in zip(plain_big, plain_split, flat_big, shard_big):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    runs = [engine._launch_search_chunk(cfg, f, seqs, big, lens, md, hs, bad,
                                        0)
            for f, big in ((fm, flat_big), (sp, shard_big))]
    assert dict(kernels.launches) == {
        "width_pass": 1, "width_pass_sharded": 1, "search_chunk": 1,
        "search_chunk_sharded": 1}
    for f, s in zip(*runs):   # every output and every counter
        assert torch.equal(s, f)
    assert torch.equal(shard_big[0], flat_big[0])   # gap_shadow, in place
    sh, snh, sfb, sit, scause, sc = runs[1]
    hits, nh, fb, steps, cause = engine.finish_chunk(
        sh.permute(1, 2, 0), snh, sfb, sit, scause, N_LANES)
    assert steps == want_steps and sc.tolist()[1] == len(sfb)   # flushed
    assert torch.equal(nh, want_nh) and torch.equal(fb, want_fb)
    assert torch.equal(cause, want_cause)
    assert torch.equal(engine.masked_hits(hits, nh, fb),
                       engine.masked_hits(want_h, want_nh, want_fb))
    assert 0 < int(snh.sum()) and 0 < int(sfb.sum()) < len(sfb)
