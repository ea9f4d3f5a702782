"""ibwa_tpu_torch — the ibwa_tpu aligner on PyTorch + hand-written CUDA kernels.

A port of the `aln` search engine of `ibwa_tpu` (JAX/XLA/Pallas) to
PyTorch on NVIDIA Hopper.  The host code that never touched JAX (index
build and load, read and .sai I/O, the native C++ search, the host
emulator) is imported from `ibwa_tpu` as it is; every module of this
package imports `torch` and never `jax`.

Kernels (CUDA C++ for sm_90a, built at first use by `kernels.py`):

* `csrc/stack_update.cu` — the fused arena stack update (replaces the
  Pallas kernel `ibwa_tpu/align/stack_kernel.py::stack_update`)
* `csrc/occ.cu` — the paired occ4/occ1 row gather + popcount (replaces
  the XLA hot op `ibwa_tpu/fm/device.py::occ4`/`occ1`)

Each kernel has a plain PyTorch twin in the same module; a wrapper runs
the twin for CPU tensors and the kernel for CUDA tensors.
"""

__version__ = "0.1.0"
