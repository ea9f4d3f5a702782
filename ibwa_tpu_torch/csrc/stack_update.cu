// K1: the fused per-read arena stack update of one aln search step.
//
// Replaces: ibwa_tpu/align/stack_kernel.py::stack_update (the Pallas
// kernel _kernel with _lane_cumsum) and computes exactly what it and its
// XLA twin stack_update_xla compute, so the planes compare bitwise:
//   1. free the popped slot (key := INT32_MAX) of every active lane;
//   2. rank the free slots (key == INT32_MAX) in slot order;
//   3. write child j (of 10) into the free slot of rank ofs[j] (0-based),
//      when cv[j]; flag overflow when ofs[j] >= the free count, and count
//      the pushes that fit;
//   4. take the first-minimum argmin of the updated key row and return
//      that slot's key and 4 entry words as the next step's pop.
//
// Bound on an H100: bytes and latency.  A step must read the whole
// B x ACAP x 4 B key plane (1 MB at ACAP 256, 4 MB at ACAP 1024 for
// B = 1024) for the rank and the argmin, but writes only the <= 11 slots
// that change per lane plus the pop words; the entry planes (sk, sl, sm1,
// sm2) are touched only at those slots.
//
// Design: one warp per lane row, ACAP/32 slots per thread in 32-slot
// chunks (slot = chunk * 32 + lane, so every key load is coalesced).  The
// free-slot rank is a __ballot_sync + __popc prefix count per chunk plus
// the running count of earlier chunks, so the whole update is ONE pass
// over the key row; each thread keeps its own first minimum (its slots
// ascend) and a lexicographic (key, slot) shuffle reduction gives the
// row's first minimum.  The planes are updated in place: only the owner
// thread of a slot ever writes it, and the pop words are read by that same
// owner thread after its own writes, so no fence is needed beyond program
// order.  Where two valid children carry the same offset, the later child
// wins, as in the Pallas kernel's sequential j loop.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNch = 10;

__global__ void stack_update_kernel(
    const int64_t* __restrict__ slot0, const bool* __restrict__ act,
    const bool* __restrict__ cv, const int64_t* __restrict__ ofs,
    const int64_t* __restrict__ kv, const int64_t* __restrict__ ck,
    const int64_t* __restrict__ cl, const int64_t* __restrict__ cm1,
    const int64_t* __restrict__ cm2, int32_t* __restrict__ key,
    int32_t* __restrict__ sk, int32_t* __restrict__ sl,
    int32_t* __restrict__ sm1, int32_t* __restrict__ sm2,
    bool* __restrict__ ovf, int64_t* __restrict__ npush,
    int64_t* __restrict__ pslot, int64_t* __restrict__ pkey,
    int64_t* __restrict__ pk, int64_t* __restrict__ pl,
    int64_t* __restrict__ pm1, int64_t* __restrict__ pm2, int B, int acap) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // uniform across the warp

  const bool a = act[row];
  const int64_t s0 = slot0[row];
  unsigned valid = 0;
  int64_t cofs[kNch];
#pragma unroll
  for (int j = 0; j < kNch; ++j) {
    cofs[j] = ofs[row * kNch + j];
    if (cv[row * kNch + j]) valid |= 1u << j;
  }

  const int64_t base_idx = row * (int64_t)acap;
  int32_t* krow = key + base_idx;
  const unsigned lt = (1u << lane) - 1u;
  int64_t n_free = 0;      // free slots in earlier chunks
  int32_t best = INT_MAX;  // this thread's first minimum
  int best_i = lane;

  for (int c0 = 0; c0 < acap; c0 += 32) {
    const int s = c0 + lane;
    int32_t kk = krow[s];
    if (a && s == s0) {
      kk = INT_MAX;
      krow[s] = kk;
    }
    const bool fr = kk == INT_MAX;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, fr);
    if (fr && valid) {
      const int64_t r = n_free + __popc(m & lt);  // 0-based free rank
      int hit = -1;
#pragma unroll
      for (int j = 0; j < kNch; ++j)
        if (((valid >> j) & 1u) && cofs[j] == r) hit = j;
      if (hit >= 0) {
        const int64_t ci = row * kNch + hit;
        kk = (int32_t)kv[ci];
        krow[s] = kk;
        sk[base_idx + s] = (int32_t)(uint32_t)ck[ci];
        sl[base_idx + s] = (int32_t)(uint32_t)cl[ci];
        sm1[base_idx + s] = (int32_t)(uint32_t)cm1[ci];
        sm2[base_idx + s] = (int32_t)(uint32_t)cm2[ci];
      }
    }
    n_free += __popc(m);
    if (kk < best) {
      best = kk;
      best_i = s;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t ok = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, best_i, off);
    if (ok < best || (ok == best && oi < best_i)) {
      best = ok;
      best_i = oi;
    }
  }

  if (lane == (best_i & 31)) {  // the owner thread of the popped slot
    const int64_t p = base_idx + best_i;
    pslot[row] = best_i;
    pkey[row] = best;
    pk[row] = (int64_t)(uint32_t)sk[p];
    pl[row] = (int64_t)(uint32_t)sl[p];
    pm1[row] = (int64_t)(uint32_t)sm1[p];
    pm2[row] = (int64_t)(uint32_t)sm2[p];
  }
  if (lane == 0) {
    bool over = false;
    int64_t pushed = 0;
#pragma unroll
    for (int j = 0; j < kNch; ++j) {
      if (!((valid >> j) & 1u)) continue;
      if (cofs[j] < n_free)
        ++pushed;
      else
        over = true;
    }
    ovf[row] = over;
    npush[row] = pushed;
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
