// The per-read arena stack update of one aln search step, as __device__
// code for one warp: shared by the stand-alone kernel K1 (stack_update.cu)
// and by stage 7 of the search step (search_step.cu).
//
// It computes exactly what ibwa_tpu/align/stack_kernel.py::stack_update
// (the Pallas kernel _kernel with _lane_cumsum) and its XLA twin compute,
// so the planes compare bitwise:
//   1. free the popped slot (key := INT32_MAX) of an active lane;
//   2. rank the free slots (key == INT32_MAX) in slot order;
//   3. write child j (of 10) into the free slot of rank ofs[j] (0-based),
//      when valid; flag overflow when ofs[j] >= the free count, and count
//      the pushes that fit;
//   4. take the first-minimum argmin of the updated key row and return
//      that slot's key and 4 entry words as the next step's pop.
//
// One warp owns one lane row, ACAP/32 slots per thread in 32-slot chunks
// (slot = chunk * 32 + lane, so every key access is coalesced).  The
// free-slot rank is a __ballot_sync + __popc prefix count per chunk plus
// the running count of earlier chunks, so the whole update is ONE pass over
// the key row; each thread keeps its own first minimum (its slots ascend)
// and a lexicographic (key, slot) shuffle reduction gives the row's first
// minimum.  The planes are updated in place: only the owner thread of a
// slot ever reads or writes it, so no fence is needed beyond program order.
// Where two valid children carry the same offset the later child wins, as
// in the Pallas kernel's sequential j loop.
//
// The ten children come in registers, the same values in every thread of
// the warp.  `krow` is the key row the pass works on: the global row itself
// (K1), or a copy in shared memory that lives across the steps of a launch
// (search step), in which case every changed key also goes to `krow_g`, the
// global row.
#ifndef IBWA_STACK_COMMIT_CUH
#define IBWA_STACK_COMMIT_CUH

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace ibwa_stack {

constexpr int kNch = 10;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

struct Children {
  unsigned valid;  // bit j: child j is pushed
  int ofs[kNch];   // exclusive push rank
  int32_t key[kNch];
  uint32_t k[kNch], l[kNch], m1[kNch], m2[kNch];
};

struct Pop {  // the next step's pop; the same in every thread on return
  int slot;
  int32_t key;
  uint32_t k, l, m1, m2;
};

struct Pushed {
  bool ovf;   // a valid child found no free slot
  int count;  // valid children that fit
};

// All 32 threads of the warp call this together.  `slot0` is freed when
// `act`.  sk/sl/sm1/sm2 point at the lane's rows of the payload planes.
__device__ __forceinline__ Pushed stack_commit(
    int lane, bool act, int64_t slot0, const Children& ch, int32_t* krow,
    int32_t* krow_g, int32_t* sk, int32_t* sl, int32_t* sm1, int32_t* sm2,
    int acap, Pop& pop) {
  const unsigned lt = (1u << lane) - 1u;
  int last_ofs = -1;  // no free slot of a higher rank takes a child
#pragma unroll
  for (int j = 0; j < kNch; ++j)
    if ((ch.valid >> j) & 1u) last_ofs = max(last_ofs, ch.ofs[j]);
  int n_free = 0;          // free slots in earlier chunks
  int32_t best = INT_MAX;  // this thread's first minimum
  int best_i = lane;
  bool fresh = false;  // ... is a child placed just now, its entry here:
  uint32_t bk = 0, bl = 0, bm1 = 0, bm2 = 0;

  for (int c0 = 0; c0 < acap; c0 += 32) {
    const int s = c0 + lane;
    int32_t kk = krow[s];
    bool changed = false;
    if (act && s == slot0) {
      kk = INT_MAX;
      changed = true;
    }
    const bool fr = kk == INT_MAX;
    const unsigned m = __ballot_sync(kFullWarp, fr);
    const int r = n_free + __popc(m & lt);  // 0-based free rank
    bool placed = false;
    uint32_t vk = 0, vl = 0, vm1 = 0, vm2 = 0;
    if (fr && r <= last_ofs) {  // past the first chunks: no thread at all
#pragma unroll
      for (int j = 0; j < kNch; ++j)
        if (((ch.valid >> j) & 1u) && ch.ofs[j] == r) {
          placed = true;
          kk = ch.key[j];
          vk = ch.k[j];
          vl = ch.l[j];
          vm1 = ch.m1[j];
          vm2 = ch.m2[j];
        }
      if (placed) {
        changed = true;
        sk[s] = (int32_t)vk;
        sl[s] = (int32_t)vl;
        sm1[s] = (int32_t)vm1;
        sm2[s] = (int32_t)vm2;
      }
    }
    if (changed) {
      krow[s] = kk;
      if (krow_g != krow) krow_g[s] = kk;
    }
    n_free += __popc(m);
    if (kk < best) {
      best = kk;
      best_i = s;
      fresh = placed;
      bk = vk;
      bl = vl;
      bm1 = vm1;
      bm2 = vm2;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t ok = __shfl_xor_sync(kFullWarp, best, off);
    const int oi = __shfl_xor_sync(kFullWarp, best_i, off);
    if (ok < best || (ok == best && oi < best_i)) {
      best = ok;
      best_i = oi;
    }
  }

  // the owner thread of the popped slot hands its entry to the warp: from
  // its registers when the pop is a child of this step (the usual case,
  // the search being depth first), else read back from the planes, which
  // only this thread has written at that slot
  const int owner = best_i & 31;
  if (lane == owner && !fresh) {
    bk = (uint32_t)sk[best_i];
    bl = (uint32_t)sl[best_i];
    bm1 = (uint32_t)sm1[best_i];
    bm2 = (uint32_t)sm2[best_i];
  }
  pop.slot = best_i;
  pop.key = best;
  pop.k = __shfl_sync(kFullWarp, bk, owner);
  pop.l = __shfl_sync(kFullWarp, bl, owner);
  pop.m1 = __shfl_sync(kFullWarp, bm1, owner);
  pop.m2 = __shfl_sync(kFullWarp, bm2, owner);

  Pushed out = {false, 0};
#pragma unroll
  for (int j = 0; j < kNch; ++j) {
    if (!((ch.valid >> j) & 1u)) continue;
    if (ch.ofs[j] < n_free)
      ++out.count;
    else
      out.ovf = true;
  }
  return out;
}

}  // namespace ibwa_stack

#endif  // IBWA_STACK_COMMIT_CUH
