// The phased entry of the aln search step: n_steps pop-expand-push steps of
// every search lane in one launch, the lane state in global memory between
// launches.  The step itself is search_step.cuh, which says what it
// replaces, what bounds it on an H100 and what its design does about that.
//
// Replaces: ibwa_tpu/align/engine_jax.py::_search_step inside the fori_loop
// of _run_search_persistent (XLA).  It leaves every field of the search
// state bitwise equal to n_steps calls of the plain step
// (align/engine.py::_search_step).  On the main path a chunk runs in
// search_chunk.cu instead; this entry stays for the phased loop (the plain
// version of that kernel's loop, driven with kernels on the card) and for
// the check of the step on single states.
//
// Design: one warp per lane, 4 lanes per block, the loop over n_steps inside
// the kernel.  A lane that is done or routed to the host on entry returns at
// once and touches nothing.  Any other lane copies its five arena rows into
// shared memory (coalesced, each thread the slots it owns), runs its steps
// there with its scalars in registers, and copies the rows and the scalars
// back at the end; the width rows and the hit rows stay where they are and
// are updated in place.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "search_step.cuh"

// The launch arguments: align/engine.py::_StepArgs mirrors this layout
// field for field.  The first 30 pointers are the fields of SearchState in
// its order.
struct IbwaStepArgs {
  const int64_t* rid;
  const int64_t* lens;
  const bool* has_seed;
  int64_t* lane_it;
  int32_t* sk;
  int32_t* sl;
  int32_t* sm1;
  int32_t* sm2;
  int32_t* key;
  int64_t* seqc;
  int64_t* stack_n;
  int64_t* w;
  int64_t* bid;
  int64_t* meta;
  int64_t* hk;
  int64_t* hl;
  int64_t* hm;
  int64_t* n_hits;
  int64_t* best_score;
  int64_t* best_cnt;
  int64_t* max_diff;
  bool* done;
  bool* fb;
  int64_t* it;
  int64_t* pslot;
  int64_t* pkey;
  int64_t* pk;
  int64_t* pl;
  int64_t* pm1;
  int64_t* pm2;
  IbwaSearchCfg c;
  int B, n_steps;
};

namespace {

using namespace ibwa_step;

template <int WPB>
// (two blocks an SM: 1,024 lanes are 256 blocks on 132 SMs, and a bound of
// three would cap the step at 168 registers, which spills)
__global__ void __launch_bounds__(kWarps * 32, 2)
    search_steps_kernel(const IbwaStepArgs a) {
  extern __shared__ int32_t arena[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= a.B) return;  // uniform across the warp
  if (row == 0 && lane == 0) a.it[0] += a.n_steps;

  LaneState s;
  s.done = a.done[row];
  s.fb = a.fb[row];
  if (s.done || s.fb) return;  // an inactive lane changes nothing

  const IbwaSearchCfg& c = a.c;
  const int acap = c.acap, P = c.L + c.SL + 2;
  const Index ix = load_index(c);
  LaneRows p;
  arena_rows(arena, warp, acap, p);
  int32_t* const planes_g[5] = {a.key + row * acap, a.sk + row * acap,
                                a.sl + row * acap, a.sm1 + row * acap,
                                a.sm2 + row * acap};
  // each thread copies, and later touches, only the slots it owns
  for (int t = lane; t < acap; t += 32) {
#pragma unroll
    for (int q = 0; q < 5; ++q) p.key[q * acap + t] = planes_g[q][t];
  }
  p.hk = a.hk + row * c.hcap;
  p.hl = a.hl + row * c.hcap;
  p.hm = a.hm + row * c.hcap;
  p.w = a.w + row * 2 * P;
  p.bid = a.bid + row * 2 * P;
  p.meta = a.meta + row * 2 * P;
  const int64_t rid = a.rid[row];
  const int64_t crid = rid < 0 ? 0 : rid >= c.n_reads ? c.n_reads - 1 : rid;
  p.seq2 = c.seqs + crid * 2 * c.L;

  s.lens = (int)a.lens[row];
  s.has_seed = a.has_seed[row];
  s.lane_it = (int)a.lane_it[row];
  s.seqc = (int)a.seqc[row];
  s.stack_n = (int)a.stack_n[row];
  s.n_hits = (int)a.n_hits[row];
  s.best_score = (int)a.best_score[row];
  s.best_cnt = (int32_t)a.best_cnt[row];
  s.max_diff = (int)a.max_diff[row];
  s.rows = 0;
  s.used = acap;  // unknown until the first step's pass: the whole row
  s.pop.slot = (int)a.pslot[row];
  s.pop.key = (int32_t)a.pkey[row];
  s.pop.k = (uint32_t)a.pk[row];
  s.pop.l = (uint32_t)a.pl[row];
  s.pop.m1 = (uint32_t)a.pm1[row];
  s.pop.m2 = (uint32_t)a.pm2[row];

  NextRows<WPB> next;
  next.valid = false;
  for (int step = 0; step < a.n_steps && !(s.done || s.fb); ++step)
    search_step<WPB, true>(c, ix, p, s, next, lane);

  for (int t = lane; t < acap; t += 32) {
#pragma unroll
    for (int q = 0; q < 5; ++q) planes_g[q][t] = p.key[q * acap + t];
  }
  if (lane == 0) {
    a.lane_it[row] = s.lane_it;
    a.seqc[row] = s.seqc;
    a.stack_n[row] = s.stack_n;
    a.n_hits[row] = s.n_hits;
    a.best_score[row] = s.best_score;
    a.best_cnt[row] = s.best_cnt;
    a.max_diff[row] = s.max_diff;
    a.done[row] = s.done;
    a.fb[row] = s.fb;
    a.pslot[row] = s.pop.slot;
    a.pkey[row] = s.pop.key;
    a.pk[row] = (int64_t)s.pop.k;
    a.pl[row] = (int64_t)s.pop.l;
    a.pm1[row] = (int64_t)s.pop.m1;
    a.pm2[row] = (int64_t)s.pop.m2;
  }
}

template <int WPB>
int launch(const IbwaStepArgs& a, cudaStream_t st) {
  const size_t smem = arena_bytes(a.c.acap);
  const cudaError_t rc = cudaFuncSetAttribute(
      search_steps_kernel<WPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (a.B + kWarps - 1) / kWarps;
  search_steps_kernel<WPB><<<grid, kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ibwa_search_steps(const IbwaStepArgs* args, void* stream) {
  const IbwaStepArgs& a = *args;
  if (a.B <= 0 || a.n_steps <= 0) return 0;
  if (a.c.acap <= 0 || a.c.acap % 32 || arena_bytes(a.c.acap) > 227 * 1024 ||
      a.c.n_reads <= 0 || a.c.L <= 0 || a.c.hcap <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.c.intv) {
    case 32:
      return launch<2>(a, st);
    case 64:
      return launch<4>(a, st);
    case 128:
      return launch<8>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
