"""The seed extensions of the native `bwasw` driver on a torch device.

`install(device, min_jobs)` registers a ctypes callback with `bsw2.cpp`'s
staged extension hook (`ibwa_bsw2_set_extend_fn`): each batch of at least
`min_jobs` seed-extension jobs the driver collects (one left and one right
batch a segment of up to 1,024 reads; the driver's runs take the minimum
as their `ext_min`) goes to `ops/dp.py::extend_jobs` on `device`: K9 on a CUDA device, its plain version on the CPU; the jobs the
gate refuses run the host kernel, empty jobs give (-1, 0, 0).  Results are
value-identical to the host loop's (`tests/test_torch_dp.py`,
`tests/test_torch_bwasw.py`).

The hook is one global of the native library, so `install` and
`uninstall` always come in pairs around one run (`try` / `finally`):
otherwise a later run with `--engine native` in the same process would
still hand its batches to the device.

A callback that raises cannot stop its C caller, so it catches
everything, keeps the first exception in `Extensions.error` and returns
1; `bsw2.cpp` then fails the run (`ibwa_bsw2_run` returns -2) and
`bwasw/aux.py` raises the exception kept here.  Nothing falls back.

The port's counterpart of `ibwa_tpu/bwasw/dp_glue.py`; no environment
variable selects it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import kernels, native
from ..ops import dp

EXT_FN_T = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32))

EXT_DEV_MIN = 64   # bsw2.cpp's default: smaller batches stay on the host


@dataclasses.dataclass
class Extensions:
    """The installed route (device, the least jobs of a batch it takes)
    and what it did: batches handed over, jobs run on the device, jobs the
    gate sent to the host, kernel launches, and the first exception a
    batch raised."""

    device: torch.device
    min_jobs: int
    batches: int = 0
    jobs: int = 0
    gate: int = 0
    launches: int = 0
    error: BaseException | None = None

    def run(self, n, tgt_blob, tgt_off, qry_blob, qry_off, g0, band,
            gap_open, gap_ext, mat, out) -> None:
        arr = np.ctypeslib.as_array
        toff = arr(tgt_off, (n + 1,))
        qoff = arr(qry_off, (n + 1,))
        tb = arr(tgt_blob, (int(toff[-1]),)) if toff[-1] else \
            np.zeros(0, np.uint8)
        qb = arr(qry_blob, (int(qoff[-1]),)) if qoff[-1] else \
            np.zeros(0, np.uint8)
        before = kernels.launches["extend_dp"]
        res, counts = dp.extend_jobs(
            tb, toff, qb, qoff, arr(g0, (n,)), arr(band, (n,)),
            arr(mat, (25,)), int(gap_open), int(gap_ext), self.device)
        arr(out, (n, 3))[:] = res
        self.batches += 1
        self.jobs += counts["device"]
        self.gate += counts["gate"]
        self.launches += kernels.launches["extend_dp"] - before


_active: Extensions | None = None
_cb = None   # the CFUNCTYPE object, alive while installed


def _callback(*args) -> int:
    ext = _active
    try:
        ext.run(*args)
        return 0
    except BaseException as e:   # the C caller cannot see an exception
        if ext is not None and ext.error is None:
            ext.error = e
        return 1


def install(device, min_jobs: int = EXT_DEV_MIN) -> Extensions:
    """Hand the native driver's extension batches of `min_jobs` or more
    jobs to `device` until `uninstall()`.  A CUDA device needs a card:
    without one this raises, it never runs on the CPU."""
    global _active, _cb
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"bwasw --device {device}: no CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if min_jobs < 1:
        raise ValueError(f"min_jobs must be positive: {min_jobs}")
    if _active is not None:
        raise RuntimeError("a device extension route is installed already")
    lib = native.load()
    _active = Extensions(dev, int(min_jobs))
    _cb = EXT_FN_T(_callback)
    lib.ibwa_bsw2_set_extend_fn(ctypes.cast(_cb, ctypes.c_void_p))
    return _active


def error() -> BaseException | None:
    """The first exception of the installed route's batches, if any."""
    return _active.error if _active is not None else None


def uninstall() -> None:
    """Back to the host loop for every batch."""
    global _active, _cb
    native.load().ibwa_bsw2_set_extend_fn(None)
    _active = _cb = None
