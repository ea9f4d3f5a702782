"""ibwa_tpu_torch — the ibwa_tpu aligner on PyTorch + hand-written CUDA kernels.

A port of `ibwa_tpu` (JAX/XLA/Pallas) to PyTorch on NVIDIA Hopper, slice by
slice: so far `index`, `aln`, `samse`, `sampe` (whose SA walks the SA
walker prefills on the device) and the dependent-gather probe.  The
package stands alone: every module imports `torch`, never `jax`, and
nothing of `ibwa_tpu`.  The host code it needs (index build and load, read
and .sai I/O, the native C++ search and SAM stages, the host emulator, the
SAM modules, the libc RNG) is its own copy, under the same sub-package and
file names as the original.

Kernels (CUDA C++ for sm_90a, built at first use by `kernels.py`):

* `csrc/stack_update.cu` — K1, the fused arena stack update (replaces the
  Pallas kernel `ibwa_tpu/align/stack_kernel.py::stack_update`); its body
  (`csrc/stack_commit.cuh`) is stage 7 of the search step
* `csrc/occ.cu` — K2, the paired occ4/occ1 row gather + popcount (replaces
  the XLA hot op `ibwa_tpu/fm/device.py::occ4`/`occ1`); its query
  (`csrc/fm_row.cuh`) is a stage of the search step and of the width pass
* `csrc/search_step.cu` — SWITCH_K pop-expand-push steps of every search
  lane in one launch (replaces the XLA `engine_jax._search_step` loop)
* `csrc/chase.cu` — K3 `chase` and K4 `chase_mw`, the dependent row-fetch
  probe (replaces the Pallas kernels `scripts/bench_chase.py::chase_pallas`
  and `chase_pallas_mw`)
* `csrc/lf_walk.cu` — K5, the LF walk to the nearest sampled SA row
  (replaces the XLA loop `ibwa_tpu/fm/walk.py::_lf_walk`); on `sampe`'s
  path it prefills every batch's SA walks
* `csrc/width_pass.cu` — K6, the width / bid / meta planes of a chunk of
  reads (replaces the XLA `engine_jax._compute_widths` + `_pack_meta`)
* `csrc/lane_switch.cu` — K7, the switch phase of the persistent lanes:
  flush, load, park (replaces the `switch` closure of
  `engine_jax._run_search_persistent`)
* `csrc/search_chunk.cu` — K8, a chunk's whole persistent search in one
  launch (replaces the `while_loop` of `engine_jax._run_search_persistent`)

Each kernel has a plain PyTorch version in the module of its wrapper; a
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors, or raises.  On the `aln` main path a chunk is two launches, K6
and `csrc/search_chunk.cu` (K8, whose stages are the search step and K7's
read start), and every chunk of a batch is launched before the first is
read back (`_decode` is numpy on the host).
"""

__version__ = "0.1.0"
