// The per-read arena stack update of one aln search step, as __device__
// code for one warp: shared by the stand-alone kernel K1 (stack_update.cu)
// and by stage 7 of the search step (search_step.cuh).
//
// It computes exactly what ibwa_tpu/align/stack_kernel.py::stack_update
// (the Pallas kernel _kernel with _lane_cumsum) and its XLA twin compute,
// so the planes compare bitwise:
//   1. free the popped slot (key := INT32_MAX) of an active lane;
//   2. rank the free slots (key == INT32_MAX) in slot order;
//   3. write the child of offset r (0-based) into the free slot of rank r,
//      when there is one; the caller flags overflow when a child's offset
//      is at or beyond the free count (stack_commit returns that count);
//   4. take the first-minimum argmin of the updated key row and return
//      that slot's key and 4 entry words as the next step's pop.
//
// One warp owns one lane row, ACAP/32 slots per thread (slot = chunk * 32 +
// lane, so every key access is coalesced, or conflict free in shared
// memory).  What bounds it is not bytes but the chain of one warp's own
// dependent operations, so the row is taken in groups of 8 chunks whose
// loads, ballots and prefix counts are independent of one another and
// overlap: the free-slot rank is a __ballot_sync + __popc per chunk on top
// of the running count of the chunks before; the placement runs only in
// chunks that still have a child to take, which is the first chunk or two;
// each thread keeps its own first minimum (its slots ascend) and two warp
// reductions (redux.sync: the least key, then the least slot that holds it)
// give the row's first minimum.  The planes are updated in place: only the
// owner thread of a slot writes it; after a warp barrier every thread reads
// the popped entry from the planes (one broadcast read each), so the pop
// needs no shuffle.
//
// Where the children come from is the caller's, a template parameter with
// two calls: `last()`, the highest offset that takes a child (-1: none; the
// same in every thread), and `take(r, ...)`, the child of offset r, if any,
// for the thread that owns the free slot of rank r.  The search step stages
// its children in shared memory by push rank, each written by the thread
// that built it (StagedChildren: ranks 0 .. n - 1, no gaps); K1 reads them
// from its tensors, where two valid children may carry the same offset and
// the later one wins, as in the Pallas kernel's sequential j loop.  `krow`
// is the key row the pass works on and sk .. sm2 the payload rows: global
// memory (K1) or shared memory that holds the lane's arena for as long as
// the lane lives (the search step).
#ifndef IBWA_STACK_COMMIT_CUH
#define IBWA_STACK_COMMIT_CUH

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace ibwa_stack {

constexpr int kNch = 10;     // children a step makes at most
constexpr int kStage = 16;   // staged children a lane has room for
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

struct Pop {  // the next step's pop; the same in every thread on return
  int slot;
  int32_t key;
  uint32_t k, l, m1, m2;
};

// The search step's children, staged by push rank in five rows of kStage
// words (key, k, l, m1, m2) of shared memory: ranks 0 .. n - 1 hold one.
struct StagedChildren {
  const int32_t* stage;
  int n;
  __device__ __forceinline__ int last() const { return n - 1; }
  __device__ __forceinline__ bool take(int r, int32_t& key, uint32_t& k,
                                       uint32_t& l, uint32_t& m1,
                                       uint32_t& m2) const {
    key = stage[r];
    k = (uint32_t)stage[kStage + r];
    l = (uint32_t)stage[2 * kStage + r];
    m1 = (uint32_t)stage[3 * kStage + r];
    m2 = (uint32_t)stage[4 * kStage + r];
    return r < n;
  }
};

constexpr int kGroup = 8;  // chunks of 32 slots taken together

// All 32 threads of the warp call this together.  `slot0` is freed when
// `act`.  sk/sl/sm1/sm2 point at the lane's rows of the payload planes.
// `used` is the number of leading groups of the row that may hold entries
// (every slot from used * 256 on is free): children fill the lowest free
// slots, so a search keeps its entries at the low end of the row, and a
// row of several groups (ACAP 1,024) is passed over only as far as its
// entries and the children reach.  Pass the row's group count for a row of
// unknown content; on return it is the count for the updated row.  Returns
// the free slots of the row after the pop was freed, before the children
// were placed: a child of offset r fits when r < that count.
template <class Src>
__device__ __forceinline__ int stack_commit(
    int lane, bool act, int64_t slot0, const Src& ch, int32_t* krow,
    int32_t* sk, int32_t* sl, int32_t* sm1, int32_t* sm2, int acap,
    int& used, Pop& pop) {
  const unsigned lt = (1u << lane) - 1u;
  __syncwarp();  // the pop every thread read from the planes at the end of
                 // the last pass, and the staged children, are in place
  const int last_ofs = ch.last();  // no free slot of a higher rank takes one
  int n_free = 0;          // free slots in earlier chunks
  int32_t best = INT_MAX;  // this thread's first minimum
  int best_i = lane;
  int used_now = 1;

  int g0 = 0;
  for (int g = 0; g0 < acap && (g < used || n_free <= last_ofs);
       ++g, g0 += 32 * kGroup) {
    int32_t kk[kGroup];
    unsigned m[kGroup];
    bool changed[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int s = g0 + 32 * u + lane;
      kk[u] = s < acap ? krow[s] : INT_MAX;
      changed[u] = act && s == slot0;
      if (changed[u]) kk[u] = INT_MAX;
    }
    unsigned all_free = kFullWarp;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      m[u] = __ballot_sync(kFullWarp, kk[u] == INT_MAX);
      all_free &= m[u];
    }
    // entries in this group after the step: some before it, or a child now
    if (n_free <= last_ofs || all_free != kFullWarp) used_now = g + 1;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int s = g0 + 32 * u + lane;
      if (s - lane >= acap) m[u] = 0u;   // past the row: no slot at all
      if (n_free <= last_ofs) {  // uniform: a child is still to be placed
        const int r = n_free + __popc(m[u] & lt);  // 0-based free rank
        if (((m[u] >> lane) & 1u) && r <= last_ofs) {
          int32_t vkey;
          uint32_t vk, vl, vm1, vm2;
          if (ch.take(r, vkey, vk, vl, vm1, vm2)) {
            kk[u] = vkey;
            changed[u] = true;
            sk[s] = (int32_t)vk;
            sl[s] = (int32_t)vl;
            sm1[s] = (int32_t)vm1;
            sm2[s] = (int32_t)vm2;
          }
        }
      }
      n_free += __popc(m[u]);
      if (changed[u]) krow[s] = kk[u];
      if (kk[u] < best) {
        best = kk[u];
        best_i = s;
      }
    }
  }
  if (g0 < acap) n_free += acap - g0;  // the rest of the row is free
  used = used_now;

  // the row's first minimum: the least key, then the least slot holding it
  const int32_t kmin = __reduce_min_sync(kFullWarp, best);
  const int slot = __reduce_min_sync(kFullWarp, best == kmin ? best_i
                                                             : INT_MAX);
  __syncwarp();  // the owner's writes of this step are seen by every thread
  pop.slot = slot;
  pop.key = kmin;
  pop.k = (uint32_t)sk[slot];
  pop.l = (uint32_t)sl[slot];
  pop.m1 = (uint32_t)sm1[slot];
  pop.m2 = (uint32_t)sm2[slot];
  return n_free;
}

}  // namespace ibwa_stack

#endif  // IBWA_STACK_COMMIT_CUH
