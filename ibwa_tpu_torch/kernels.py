"""Build, load and count the hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled with nvcc at first use (one nvcc per source, all
started together) and linked into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: that keeps a cold
build to seconds).  The library is keyed by a hash of the
sources, so an edited kernel is rebuilt and a stale one never loads.
Nothing is built or loaded at import time: the CPU-only test machine has
no nvcc and never calls `lib()`.

`launches` counts, per kernel, the launches the wrappers made; a run
resets it with `reset_launches()` and reads it after, to show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "ibwa_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()
build_info: dict = {}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # blocks, primary, l2diff, strand, k, l, out, m, seq_len, n_blk,
    # intv, stream
    "ibwa_occ4_pair": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    # ... the same with the base code c before out
    "ibwa_occ1_pair": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    # slot0, act, cv, ofs, kv, ck, cl, cm1, cm2, key, sk, sl, sm1, sm2,
    # ovf, npush, pslot, pkey, pk, pl, pm1, pm2, B, acap, stream
    "ibwa_stack_update": [_P] * 22 + [_I, _I, _P],
    # table, idx0, out_idx, out_acc, lanes, lanes_per_block, roww, steps,
    # n_rows, stream
    "ibwa_chase": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    # ... the same with the wave count before the stream
    "ibwa_chase_mw": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _P],
    # blocks, primary, L2, strand, k0, add, kfin, n, seq_len, n_blk, intv,
    # intv_mask, stream
    "ibwa_lf_walk": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _P],
    # blocks, primary, L2, sampled, n_samp, ss, ks, off, n_iv, row_begin,
    # row_end, out, stats, seq_len, n_blk, intv, sa_intv_mask, max_blocks,
    # stream
    "ibwa_lf_resolve": [_P, _P, _P, _P, _L, _P, _P, _P, _L, _L, _L, _P, _P,
                        _L, _L, _I, _L, _I, _P],
    # the argument struct (align/engine.py::_StepArgs), stream
    "ibwa_search_steps": [_P, _P],
    # blocks, primary, L2, l2diff, seqs, seed_seqs, lens, has_seed, w, bid,
    # meta, n_reads, L, SL, seq_len, n_blk, intv, stream
    "ibwa_width_pass": [_P] * 11 + [_I, _I, _I, _L, _L, _I, _P],
    # ... the same with the shard table (fm/device.py::Shards) in place of
    # blocks (B8)
    "ibwa_width_pass_sharded": [_P] * 11 + [_I, _I, _I, _L, _L, _I, _P],
    # device, peer
    "ibwa_enable_peer": [_I, _I],
    # the argument struct (align/engine.py::_SwitchArgs), stream
    "ibwa_lane_switch": [_P, _P],
    # the argument struct (align/engine.py::_ChunkArgs), mode, stream
    "ibwa_search_chunk": [_P, _I, _P],
    # ... with out int32[4] (the launch's shape) in place of the stream
    "ibwa_search_chunk_shape": [_P, _I, _P],
    # K8's first version: the struct (engine.py::_ChunkFirstArgs), prefetch,
    # stream
    "ibwa_search_chunk_first": [_P, _I, _P],
    # tgt, tgt_off, qry, qry_off, g0, band, ids, n_ids, matrix (host),
    # gap_open, gap_ext, eh, out, stats, max_blocks, stream
    "ibwa_extend_dp": [_P] * 7 + [_I, _P, _I, _I, _P, _P, _P, _I, _P],
    # ... K9's first version, the same arguments
    "ibwa_extend_dp_first": [_P] * 7 + [_I, _P, _I, _I, _P, _P, _P, _I, _P],
    # n_ids, out int32[7]
    "ibwa_extend_dp_info": [_L, _P],
}


def reset_launches() -> None:
    launches.clear()


def _sources() -> list[pathlib.Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build() -> pathlib.Path:
    srcs = _sources()
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    so = BUILD_DIR / f"libibwa_kernels_{key}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True, log="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all started together; then one link
    objs, procs = [], []
    for s in srcs:
        if s.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{s.stem}_{key}.tmp{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(s)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    log, failed = "", None
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0 and failed is None:
                failed = cmd
        if failed is None:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *[str(o) for o in objs]]
            r = subprocess.run(cmd, capture_output=True, text=True)
            log += r.stdout + r.stderr
            if r.returncode != 0:
                failed = cmd
        if failed is not None:
            raise RuntimeError(f"kernel build failed ({' '.join(failed)}):\n"
                               f"{log}")
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return so


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call.  Raises if the build
    fails; there is no fallback."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
