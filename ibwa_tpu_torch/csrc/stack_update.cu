// K1: the fused per-read arena stack update of one aln search step, as a
// kernel of its own.
//
// Replaces: ibwa_tpu/align/stack_kernel.py::stack_update (the Pallas
// kernel _kernel with _lane_cumsum).  The update itself (free the popped
// slot, rank the free slots, place <= 10 children, first-minimum argmin and
// the next pop's entry) is the __device__ function stack_commit of
// stack_commit.cuh, which says what it computes and how; stage 7 of the
// search step (search_step.cuh) calls the same function with the children
// staged in shared memory by the threads that built them, and that is where
// the aln path runs it.  This kernel is the thin wrapper that takes one
// step's children from tensors (RowChildren), one warp per lane row, and
// writes the pop back: it serves the plain search step's callers of
// `stack_update` and holds stack_commit against
// `stack_update_plain` on inputs a real search never produces (repeated
// offsets, full arenas).
//
// Bound on an H100: bytes and latency.  A step must read the whole
// B x ACAP x 4 B key plane (1 MB at ACAP 256, 4 MB at ACAP 1024 for
// B = 1024) for the rank and the argmin, but writes only the <= 11 slots
// that change per lane plus the pop words; the entry planes (sk, sl, sm1,
// sm2) are touched only at those slots.  At 1,024 lanes the launch itself
// is most of the time, which is why the step keeps this work inside its
// own launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "stack_commit.cuh"

namespace {

using namespace ibwa_stack;

// One row's children as K1's tensors hold them: child j at [row * 10 + j],
// any offsets, repeated ones included; where two valid children carry the
// offset of a free slot the later one wins, as in the Pallas kernel's
// sequential j loop.  Read through the cache by every thread that asks.
struct RowChildren {
  const bool* cv;
  const int64_t *ofs, *kv, *ck, *cl, *cm1, *cm2;
  int last_ofs;
  __device__ __forceinline__ int last() const { return last_ofs; }
  __device__ __forceinline__ bool take(int r, int32_t& key, uint32_t& k,
                                       uint32_t& l, uint32_t& m1,
                                       uint32_t& m2) const {
    bool placed = false;
    for (int j = 0; j < kNch; ++j)
      if (cv[j] && ofs[j] == r) {
        placed = true;
        key = (int32_t)kv[j];
        k = (uint32_t)ck[j];
        l = (uint32_t)cl[j];
        m1 = (uint32_t)cm1[j];
        m2 = (uint32_t)cm2[j];
      }
    return placed;
  }
};

__global__ void stack_update_kernel(
    const int64_t* __restrict__ slot0, const bool* __restrict__ act,
    const bool* __restrict__ cv, const int64_t* __restrict__ ofs,
    const int64_t* __restrict__ kv, const int64_t* __restrict__ ck,
    const int64_t* __restrict__ cl, const int64_t* __restrict__ cm1,
    const int64_t* __restrict__ cm2, int32_t* key, int32_t* sk, int32_t* sl,
    int32_t* sm1, int32_t* sm2, bool* __restrict__ ovf,
    int64_t* __restrict__ npush, int64_t* __restrict__ pslot,
    int64_t* __restrict__ pkey, int64_t* __restrict__ pk,
    int64_t* __restrict__ pl, int64_t* __restrict__ pm1,
    int64_t* __restrict__ pm2, int B, int acap) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // uniform across the warp

  const int64_t c0 = row * kNch;
  RowChildren ch = {cv + c0, ofs + c0, kv + c0, ck + c0, cl + c0, cm1 + c0,
                    cm2 + c0, -1};
  for (int j = 0; j < kNch; ++j)
    if (cv[c0 + j] && ofs[c0 + j] > ch.last_ofs)
      ch.last_ofs = (int)min(ofs[c0 + j], (int64_t)INT_MAX - 1);
  const int64_t base = row * (int64_t)acap;
  Pop pop;
  int used = acap;  // a row of unknown content: the whole of it
  const int n_free =
      stack_commit(lane, act[row], slot0[row], ch, key + base, sk + base,
                   sl + base, sm1 + base, sm2 + base, acap, used, pop);
  if (lane == 0) {
    bool over = false;
    int count = 0;
    for (int j = 0; j < kNch; ++j) {
      if (!cv[c0 + j]) continue;
      if (ofs[c0 + j] < n_free)
        ++count;
      else
        over = true;
    }
    pslot[row] = pop.slot;
    pkey[row] = pop.key;
    pk[row] = (int64_t)pop.k;
    pl[row] = (int64_t)pop.l;
    pm1[row] = (int64_t)pop.m1;
    pm2[row] = (int64_t)pop.m2;
    ovf[row] = over;
    npush[row] = count;
  }
}

}  // namespace

extern "C" int ibwa_stack_update(
    const void* slot0, const void* act, const void* cv, const void* ofs,
    const void* kv, const void* ck, const void* cl, const void* cm1,
    const void* cm2, void* key, void* sk, void* sl, void* sm1, void* sm2,
    void* ovf, void* npush, void* pslot, void* pkey, void* pk, void* pl,
    void* pm1, void* pm2, int B, int acap, void* stream) {
  if (B <= 0) return 0;
  if (acap <= 0 || acap % 32) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 lane rows per block
  const int grid = (int)(((int64_t)B * 32 + threads - 1) / threads);
  stack_update_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slot0), static_cast<const bool*>(act),
      static_cast<const bool*>(cv), static_cast<const int64_t*>(ofs),
      static_cast<const int64_t*>(kv), static_cast<const int64_t*>(ck),
      static_cast<const int64_t*>(cl), static_cast<const int64_t*>(cm1),
      static_cast<const int64_t*>(cm2), static_cast<int32_t*>(key),
      static_cast<int32_t*>(sk), static_cast<int32_t*>(sl),
      static_cast<int32_t*>(sm1), static_cast<int32_t*>(sm2),
      static_cast<bool*>(ovf), static_cast<int64_t*>(npush),
      static_cast<int64_t*>(pslot), static_cast<int64_t*>(pkey),
      static_cast<int64_t*>(pk), static_cast<int64_t*>(pl),
      static_cast<int64_t*>(pm1), static_cast<int64_t*>(pm2), B, acap);
  return (int)cudaGetLastError();
}
