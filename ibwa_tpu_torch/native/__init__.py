"""ctypes loader for the port's native host library.

The library is built on demand with g++ (no pip/pybind dependency). All
entry points use plain C ABI + NumPy buffers.

Copy of `ibwa_tpu/native/__init__.py`, with every source it builds
(`src/core.cpp`, `src/sais_frugal.cpp`, `src/lf_step.h`,
`src/sam_text.cpp`, `src/pe_stage.cpp`, and `src/bsw2.cpp`, `bwasw`'s
driver, whose copy returns its extension callback's status and takes its
switches as arguments: see its header).  The `sampe` stage's
own symbols (`ibwa_pe_*`, `ibwa_se_stage`, `ibwa_sai_scan`,
`ibwa_interleave_blobs`) are bound where they are called, in
`sam/pe_native.py`, as in `ibwa_tpu`.  The library
is built into `build/ibwa_tpu_torch/` beside the CUDA kernels, never into
the package directory, under a name keyed by a hash of the sources and
the host stamp.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC_DIR = pathlib.Path(__file__).resolve().parent / "src"
_SRCS = [_SRC_DIR / "bsw2.cpp", _SRC_DIR / "core.cpp",
         _SRC_DIR / "pe_stage.cpp", _SRC_DIR / "sais_frugal.cpp",
         _SRC_DIR / "sam_text.cpp"]
_HDRS = [_SRC_DIR / "lf_step.h"]
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / \
    "build" / "ibwa_tpu_torch"
_FLAGS = [
    # initial-exec TLS: thread_local scratch in the hot DP loops would
    # otherwise go through __tls_get_addr on every access; glibc reserves
    # static TLS headroom for dlopen'd libs and ours is a handful of
    # pointers
    "-O3", "-g", "-march=native", "-shared", "-fPIC", "-std=c++17",
    "-fopenmp", "-ftls-model=initial-exec",
]

_lock = threading.Lock()
_lib = None


def _build_stamp() -> str:
    """Host/compiler fingerprint: -march=native output is CPU-specific, so a
    prebuilt .so carried to another host (or a toolchain change) must not be
    reused — it can SIGILL at load."""
    import platform
    try:
        ver = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    except Exception:
        ver = "g++-unknown"
    return f"{platform.machine()}|{platform.node()}|{ver}"


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _SRCS + _HDRS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_build_stamp().encode())
    return BUILD_DIR / f"libibwa_native_{h.hexdigest()[:16]}.so"


def _build(lib_path: pathlib.Path) -> None:
    # link to a temp path + atomic rename: ld truncates its output file in
    # place, which would corrupt the mapped pages of any process that
    # already dlopened the previous build
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    cmd = ["g++", *_FLAGS, *[str(s) for s in _SRCS], "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{e.stderr}") from e
    os.replace(tmp, lib_path)


def load() -> ctypes.CDLL:
    """The native library, built on first call.  Raises if the build
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = _lib_path()
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f64p = ctypes.POINTER(ctypes.c_double)

        lib.ibwa_sais.argtypes = [u8p, i32p, ctypes.c_int32, ctypes.c_int32]
        lib.ibwa_sais.restype = ctypes.c_int32
        lib.ibwa_bwt_inplace.argtypes = [u8p, ctypes.c_int32]
        lib.ibwa_bwt_inplace.restype = ctypes.c_int32
        lib.ibwa_bwt_sa_inplace.argtypes = [u8p, ctypes.c_int32,
                                            ctypes.c_uint32, u32p,
                                            ctypes.c_uint32]
        lib.ibwa_bwt_sa_inplace.restype = ctypes.c_int32
        lib.ibwa_bwt_inplace64.argtypes = [u8p, ctypes.c_int64]
        lib.ibwa_bwt_inplace64.restype = ctypes.c_int64
        lib.ibwa_cal_sa.argtypes = [u32p, ctypes.c_uint32, u32p,
                                    ctypes.c_uint32, ctypes.c_uint32, u32p,
                                    ctypes.c_uint32]
        lib.ibwa_sa_lookup.argtypes = [u32p, ctypes.c_uint32, u32p,
                                       ctypes.c_uint32, ctypes.c_uint32, u32p,
                                       u32p, ctypes.c_uint32, u32p]
        lib.ibwa_occ.argtypes = [u32p, ctypes.c_uint32, u32p, ctypes.c_uint32,
                                 ctypes.c_uint32, ctypes.c_int32]
        lib.ibwa_occ.restype = ctypes.c_uint32
        lib.ibwa_lrand48.argtypes = [u64p, ctypes.c_uint64, u32p]
        lib.ibwa_drand48.argtypes = [u64p, ctypes.c_uint64, f64p]
        lib.ibwa_global_aln.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
            ctypes.c_int32, u32p, ctypes.c_int32, i32p]
        lib.ibwa_global_aln.restype = ctypes.c_int32
        lib.ibwa_local_aln.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
            ctypes.c_int32, u32p, ctypes.c_int32, i32p]
        lib.ibwa_local_aln.restype = ctypes.c_int32
        lib.ibwa_extend_aln.argtypes = [
            u8p, ctypes.c_int32, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
            ctypes.c_int32, i32p]
        lib.ibwa_occ4.argtypes = [u32p, ctypes.c_uint32, u32p,
                                  ctypes.c_uint32, ctypes.c_uint32, u32p]
        lib.ibwa_bsw2_core.argtypes = [
            u32p, ctypes.c_uint32, u32p, ctypes.c_uint32, ctypes.c_uint32,
            u32p, u8p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i32p, i64p, i32p, ctypes.c_int32]
        lib.ibwa_bsw2_core.restype = ctypes.c_int32
        lib.ibwa_bwt_packed32.argtypes = [u8p, ctypes.c_uint32, u32p, u8p,
                                          ctypes.c_int32]
        lib.ibwa_bwt_packed32.restype = ctypes.c_int64
        lib.ibwa_cal_md.argtypes = [
            u32p, ctypes.c_int32, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, u8p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int64, i32p]
        lib.ibwa_cal_md.restype = ctypes.c_int64
        lib.ibwa_bsw2_new_ctx.argtypes = [
            u32p, ctypes.c_uint32, u32p, ctypes.c_uint32, u32p,
            ctypes.c_uint32, ctypes.c_uint32, u32p, u32p,
            u8p, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
            u8p, i64p, ctypes.c_int64, i64p, i64p]
        lib.ibwa_bsw2_new_ctx.restype = ctypes.c_void_p
        lib.ibwa_bsw2_free_ctx.argtypes = [ctypes.c_void_p]
        lib.ibwa_bsw2_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, u8p, i64p, u8p, i64p, u8p,
            i64p, u64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f64p]
        lib.ibwa_bsw2_run.restype = ctypes.c_int64
        lib.ibwa_bsw2_text.argtypes = [ctypes.c_void_p]
        lib.ibwa_bsw2_text.restype = ctypes.c_void_p
        lib.ibwa_bsw2_set_extend_fn.argtypes = [ctypes.c_void_p]
        lib.ibwa_bsw2_set_extend_fn.restype = None
        lib.ibwa_fastq_scan.argtypes = [
            u8p, ctypes.c_int64, i64p, u8p, i64p, u8p, i64p, u8p, i64p]
        lib.ibwa_fastq_scan.restype = ctypes.c_int64
        lib.ibwa_match_gap_batch.argtypes = [
            u32p, ctypes.c_uint32, u32p, ctypes.c_uint32, u32p,
            ctypes.c_uint32, u8p, u8p, i64p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, u32p, ctypes.c_int32, i32p]
        _lib = lib
        return lib


def _u32(a: np.ndarray) -> ctypes.POINTER:
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def sais(text: np.ndarray, alphabet: int = 4) -> np.ndarray:
    """Suffix array of a uint8 text."""
    lib = load()
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(text), dtype=np.int32)
    rc = lib.ibwa_sais(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(text), alphabet)
    if rc != 0:
        raise RuntimeError("ibwa_sais failed")
    return sa


def bwt_inplace(text: np.ndarray) -> tuple[np.ndarray, int]:
    """Sentinel-removed BWT of a 2-bit uint8 text; returns (bwt, primary).

    Texts beyond int32 positions (>2GB genomes, the reference's
    `index -a bwtsw` territory) take the 64-bit SA-IS path."""
    lib = load()
    buf = np.ascontiguousarray(text, dtype=np.uint8).copy()
    if len(buf) >= (1 << 31) - 2:
        primary = lib.ibwa_bwt_inplace64(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf))
    else:
        primary = lib.ibwa_bwt_inplace(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf))
    if primary < 0:
        raise RuntimeError("ibwa_bwt_inplace failed")
    return buf, int(primary)


def bwt_packed(pac_bytes: np.ndarray, seq_len: int, reverse: bool = False,
               sa_intv: int = 0):
    """Bounded-memory BWT of a 2-bit PACKED text (sais_frugal.cpp).

    Peak footprint ~ 4 bytes/base (the u32 suffix array) + n/8 type bits
    + the packed in/out buffers — ~13.5 GB for 3.2 Gbp, the reference's
    `index -a bwtsw` territory (bwa.1:450).  Returns (packed_bwt,
    primary), plus the sampled .sa when sa_intv > 0 (the suffix array is
    in memory anyway: full-matrix row k has SA_full[k] = sa[k-1], file
    stores rows k % intv == 0 with slot 0 = 0xFFFFFFFF, bwt.c:66 quirk —
    skips the reference's whole-genome isa walk).  Output byte-identical
    to the SA-IS path (the BWT is unique)."""
    lib = load()
    pac_bytes = np.ascontiguousarray(pac_bytes, dtype=np.uint8)
    sa = np.empty(seq_len, dtype=np.uint32)
    out = np.zeros((seq_len + 3) // 4, dtype=np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    primary = lib.ibwa_bwt_packed32(
        pac_bytes.ctypes.data_as(u8), seq_len, _u32(sa),
        out.ctypes.data_as(u8), 1 if reverse else 0)
    if primary < 0:
        raise RuntimeError("ibwa_bwt_packed32 failed")
    if sa_intv:
        n_sa = (seq_len + sa_intv) // sa_intv
        sampled = np.zeros(n_sa, dtype=np.uint32)
        ks = np.arange(sa_intv, seq_len + 1, sa_intv, dtype=np.int64)
        sampled[ks // sa_intv] = sa[ks - 1]
        sampled[0] = 0xFFFFFFFF
        del sa
        return out, int(primary), sampled
    del sa
    return out, int(primary)


def bwt_with_sa(text: np.ndarray, sa_intv: int
                ) -> tuple[np.ndarray, int, np.ndarray]:
    """BWT + sampled .sa in ONE SA-IS pass (<2 Gbp texts): the full
    suffix array is in memory anyway, so the reference's whole-genome
    isa walk (bwt_cal_sa) is skipped.  Returns (bwt, primary, sa)."""
    lib = load()
    buf = np.ascontiguousarray(text, dtype=np.uint8).copy()
    n = len(buf)
    n_sa = (n + sa_intv) // sa_intv
    out_sa = np.empty(n_sa, dtype=np.uint32)
    primary = lib.ibwa_bwt_sa_inplace(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, sa_intv,
        _u32(out_sa), n_sa)
    if primary < 0:
        raise RuntimeError("ibwa_bwt_sa_inplace failed")
    return buf, int(primary), out_sa


def cal_sa(interleaved: np.ndarray, primary: int, l2: np.ndarray,
           seq_len: int, intv: int) -> np.ndarray:
    lib = load()
    interleaved = np.ascontiguousarray(interleaved, dtype=np.uint32)
    l2 = np.ascontiguousarray(l2, dtype=np.uint32)
    n_sa = (seq_len + intv) // intv
    out = np.empty(n_sa, dtype=np.uint32)
    lib.ibwa_cal_sa(_u32(interleaved), primary, _u32(l2), seq_len, intv,
                    _u32(out), n_sa)
    return out


def sa_lookup(interleaved: np.ndarray, primary: int, l2: np.ndarray,
              seq_len: int, sa_intv: int, sampled_sa: np.ndarray,
              ks: np.ndarray) -> np.ndarray:
    lib = load()
    interleaved = np.ascontiguousarray(interleaved, dtype=np.uint32)
    l2 = np.ascontiguousarray(l2, dtype=np.uint32)
    sampled_sa = np.ascontiguousarray(sampled_sa, dtype=np.uint32)
    ks = np.ascontiguousarray(ks, dtype=np.uint32)
    out = np.empty(len(ks), dtype=np.uint32)
    lib.ibwa_sa_lookup(_u32(interleaved), primary, _u32(l2), seq_len, sa_intv,
                       _u32(sampled_sa), _u32(ks), len(ks), _u32(out))
    return out


class SaHandle:
    """Prepared SA-walk state: the contiguous casts + ctypes pointers are
    built once, so per-call cost is one ks/out pair (the naive path paid
    5 array copies + casts per lookup — the sampe hot spot)."""

    __slots__ = ("_lib", "_keep", "_itl", "_l2", "_sa", "primary",
                 "seq_len", "sa_intv")

    def __init__(self, interleaved, primary, l2, seq_len, sa_intv,
                 sampled_sa):
        self._lib = load()
        itl = np.ascontiguousarray(interleaved, dtype=np.uint32)
        l2c = np.ascontiguousarray(l2, dtype=np.uint32)
        sac = np.ascontiguousarray(sampled_sa, dtype=np.uint32)
        self._keep = (itl, l2c, sac)
        self._itl, self._l2, self._sa = _u32(itl), _u32(l2c), _u32(sac)
        self.primary = int(primary)
        self.seq_len = int(seq_len)
        self.sa_intv = int(sa_intv)

    def lookup(self, ks: np.ndarray) -> np.ndarray:
        ks = np.ascontiguousarray(ks, dtype=np.uint32)
        out = np.empty(len(ks), dtype=np.uint32)
        self._lib.ibwa_sa_lookup(self._itl, self.primary, self._l2,
                                 self.seq_len, self.sa_intv, self._sa,
                                 _u32(ks), len(ks), _u32(out))
        return out


def occ(interleaved: np.ndarray, primary: int, l2: np.ndarray, seq_len: int,
        k: int, c: int) -> int:
    lib = load()
    interleaved = np.ascontiguousarray(interleaved, dtype=np.uint32)
    l2 = np.ascontiguousarray(l2, dtype=np.uint32)
    return int(lib.ibwa_occ(_u32(interleaved), primary, _u32(l2), seq_len,
                            k & 0xFFFFFFFF, c))


# aln_sm_maq scoring matrix + aln_param_bwa (stdaln.c:212-227)
SM_MAQ = np.array([11, -19, -19, -19, -13,
                   -19, 11, -19, -19, -13,
                   -19, -19, 11, -19, -13,
                   -19, -19, -19, 11, -13,
                   -13, -13, -13, -13, -13], dtype=np.int32)
BWA_GAP_OPEN, BWA_GAP_EXT, BWA_GAP_END, BWA_BAND = 26, 9, 5, 50


def global_aln(ref: np.ndarray, read: np.ndarray,
               gap_open: int = BWA_GAP_OPEN, gap_ext: int = BWA_GAP_EXT,
               gap_end: int = BWA_GAP_END, band: int = BWA_BAND,
               matrix: np.ndarray = SM_MAQ, row: int = 5
               ) -> tuple[list[int], int]:
    """Banded global affine-gap alignment (aln_global_core semantics).

    ref/read: uint8 2-bit codes (4 = N).  Returns (cigar, score) with
    cigar entries packed op<<29|len (bwa_cigar_t, bwtaln.h:44-49)."""
    lib = load()
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    read = np.ascontiguousarray(read, dtype=np.uint8)
    cap = len(ref) + len(read) + 2
    out = np.empty(cap, dtype=np.uint32)
    score = np.zeros(1, dtype=np.int32)
    n = lib.ibwa_global_aln(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ref),
        read.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(read),
        gap_open, gap_ext, gap_end, band,
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), row,
        _u32(out), cap,
        score.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise RuntimeError("ibwa_global_aln: cigar buffer overflow")
    return [int(x) for x in out[:n]], int(score[0])


def local_aln(ref: np.ndarray, read: np.ndarray, thres: int = 1,
              gap_open: int = BWA_GAP_OPEN, gap_ext: int = BWA_GAP_EXT,
              band: int = BWA_BAND, matrix: np.ndarray = SM_MAQ,
              row: int = 5) -> tuple[list[int], int, int, int, int, int]:
    """Banded local SW (aln_local_core semantics, path fill included).

    Returns (cigar, score, first_i, first_j, end_i, end_j, subo); empty
    cigar means no acceptable local alignment."""
    lib = load()
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    read = np.ascontiguousarray(read, dtype=np.uint8)
    cap = len(ref) + len(read) + 2
    out = np.empty(cap, dtype=np.uint32)
    meta = np.zeros(6, dtype=np.int32)
    n = lib.ibwa_local_aln(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ref),
        read.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(read),
        gap_open, gap_ext, band,
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), row, thres,
        _u32(out), cap,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise RuntimeError("ibwa_local_aln: cigar buffer overflow")
    return ([int(x) for x in out[:n]], int(meta[0]), int(meta[1]),
            int(meta[2]), int(meta[3]), int(meta[4]), int(meta[5]))


def extend_aln(ref: np.ndarray, read: np.ndarray, gap_open: int,
               gap_ext: int, band: int, matrix: np.ndarray, G0: int
               ) -> tuple[int, int, int]:
    """One-sided extension (aln_extend_core): (score, end_i, end_j)."""
    lib = load()
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    read = np.ascontiguousarray(read, dtype=np.uint8)
    meta = np.zeros(3, dtype=np.int32)
    lib.ibwa_extend_aln(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ref),
        read.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(read),
        gap_open, gap_ext, band,
        np.ascontiguousarray(matrix, dtype=np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), 5, G0,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return int(meta[0]), int(meta[1]), int(meta[2])


def occ4(interleaved: np.ndarray, primary: int, l2: np.ndarray,
         seq_len: int, k: int) -> np.ndarray:
    """bwt_occ4 on the interleaved layout (single query)."""
    lib = load()
    out = np.zeros(4, dtype=np.uint32)
    lib.ibwa_occ4(_u32(interleaved), primary, _u32(l2), seq_len,
                  k & 0xFFFFFFFF, _u32(out))
    return out


def lrand48_stream(state_x: int, n: int) -> tuple[np.ndarray, int]:
    """n lrand48 draws starting from raw 48-bit state; returns (vals, state)."""
    lib = load()
    st = np.array([state_x], dtype=np.uint64)
    out = np.empty(n, dtype=np.uint32)
    lib.ibwa_lrand48(st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
                     _u32(out))
    return out, int(st[0])


def drand48_stream(state_x: int, n: int) -> tuple[np.ndarray, int]:
    lib = load()
    st = np.array([state_x], dtype=np.uint64)
    out = np.empty(n, dtype=np.float64)
    lib.ibwa_drand48(st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out, int(st[0])


def bsw2_core(fm, seq: np.ndarray, a: int, b: int, q: int, r: int,
              t: int, bw: int, z: int, is_: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Native BWA-SW core for one read strand (bsw2.cpp).

    fm: FmIndex of the genome; seq: 2-bit codes (no N).  Returns two
    int64 hit arrays [n, 9]: (k, l, flag, n_seeds, len, G, G2, beg, end)
    — the duplicate-resolved wide and narrow lists."""
    lib = load()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    itl = np.ascontiguousarray(fm._interleaved, dtype=np.uint32)
    l2 = np.ascontiguousarray(fm.L2, dtype=np.uint32)
    sa = np.ascontiguousarray(fm.sa, dtype=np.uint32)
    cap = 6 * max(len(seq), 8) + 64
    out_b = np.empty((cap, 9), dtype=np.int64)
    out_b1 = np.empty((cap, 9), dtype=np.int64)
    n_b = np.zeros(1, dtype=np.int32)
    n_b1 = np.zeros(1, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ibwa_bsw2_core(
        _u32(itl), fm.primary, _u32(l2), fm.seq_len, fm.sa_intv, _u32(sa),
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(seq),
        a, b, q, r, t, bw, z, is_,
        out_b.ctypes.data_as(i64p), n_b.ctypes.data_as(i32p),
        out_b1.ctypes.data_as(i64p), n_b1.ctypes.data_as(i32p), cap)
    if rc != 0:
        raise RuntimeError("ibwa_bsw2_core: hit capacity overflow")
    return out_b[:int(n_b[0])].copy(), out_b1[:int(n_b1[0])].copy()


def match_gap_batch(fm_fwd, fm_rev, seqs: list[np.ndarray],
                    rseqs: list[np.ndarray], max_diffs: np.ndarray,
                    seed_lens: np.ndarray, opt, cap: int = 250
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Batched host gapped search (bwt_match_gap semantics) over the
    interleaved FM layouts; OpenMP-parallel over reads.

    Returns (hits uint32[n, cap, 4], counts int32[n]); count -1 means the
    per-read hit capacity overflowed (caller retries via the emulator)."""
    lib = load()
    n = len(seqs)
    offsets = np.zeros(n, dtype=np.int64)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    offsets[1:] = np.cumsum(lens[:-1])
    cat_s = np.concatenate(seqs).astype(np.uint8) if n else \
        np.empty(0, np.uint8)
    cat_r = np.concatenate(rseqs).astype(np.uint8) if n else \
        np.empty(0, np.uint8)
    optv = np.array([opt.s_mm, opt.s_gapo, opt.s_gape, opt.max_gapo,
                     opt.max_gape, opt.max_seed_diff, opt.indel_end_skip,
                     opt.max_del_occ, opt.max_entries, opt.max_top2,
                     opt.mode], dtype=np.int32)
    out = np.zeros((n, cap, 4), dtype=np.uint32)
    out_n = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ibwa_match_gap_batch(
        _u32(fm_fwd._interleaved), fm_fwd.primary,
        _u32(fm_rev._interleaved), fm_rev.primary,
        _u32(np.ascontiguousarray(fm_fwd.L2, dtype=np.uint32)),
        fm_fwd.seq_len,
        cat_s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cat_r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(i32p),
        np.ascontiguousarray(max_diffs, dtype=np.int32).ctypes.data_as(i32p),
        np.ascontiguousarray(seed_lens, dtype=np.int32).ctypes.data_as(i32p),
        optv.ctypes.data_as(i32p), n, _u32(out), cap,
        out_n.ctypes.data_as(i32p))
    return out, out_n
