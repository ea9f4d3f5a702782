"""ibwa_tpu_torch — the ibwa_tpu aligner on PyTorch + hand-written CUDA kernels.

A port of `ibwa_tpu` (JAX/XLA/Pallas) to PyTorch on NVIDIA Hopper, slice by
slice: so far `index`, `aln`, the SA walker and the dependent-gather probe.
The package stands alone: every module imports `torch`, never `jax`, and
nothing of `ibwa_tpu`.  The host code it needs (index build and load, read
and .sai I/O, the native C++ search, the host emulator, the libc RNG) is
its own copy, under the same sub-package and file names as the original.

Kernels (CUDA C++ for sm_90a, built at first use by `kernels.py`):

* `csrc/stack_update.cu` — K1, the fused arena stack update (replaces the
  Pallas kernel `ibwa_tpu/align/stack_kernel.py::stack_update`)
* `csrc/occ.cu` — K2, the paired occ4/occ1 row gather + popcount (replaces
  the XLA hot op `ibwa_tpu/fm/device.py::occ4`/`occ1`)
* `csrc/chase.cu` — K3 `chase` and K4 `chase_mw`, the dependent row-fetch
  probe (replaces the Pallas kernels `scripts/bench_chase.py::chase_pallas`
  and `chase_pallas_mw`)
* `csrc/lf_walk.cu` — K5, the LF walk to the nearest sampled SA row
  (replaces the XLA loop `ibwa_tpu/fm/walk.py::_lf_walk`)

Each kernel has a plain PyTorch version in the module of its wrapper; a
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors, or raises.
"""

__version__ = "0.1.0"
