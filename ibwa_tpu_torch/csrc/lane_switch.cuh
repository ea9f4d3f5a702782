// The start of a read on a search lane, as __device__ code for one warp:
// shared by K7 (lane_switch.cu, the switch phase of the phased loop, lane
// state in global memory) and by the switch stage of the resident chunk
// kernel (search_chunk.cu, lane state in registers and shared memory).
//
// Replaces: the load half of the `switch` closure of
// ibwa_tpu/align/engine_jax.py::_run_search_persistent (XLA, :800-844); in
// this package align/engine.py::_load_lanes.  A read starts with an arena
// that is empty but for the two strand roots in slots 0 and 1 (pushed with
// seqno 0 and 1), the a = 1 root of slot 1 popped first, and with the best
// score no hit can reach.
#ifndef IBWA_LANE_SWITCH_CUH
#define IBWA_LANE_SWITCH_CUH

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace ibwa_switch {

// Warp-wide copy of n words, thread t on word t of each 32-word stretch.
// Four stretches are loaded before the first is stored, so a row costs a
// quarter of its stretches in dependent round trips to memory.
__device__ __forceinline__ void copy_row(int64_t* __restrict__ dst,
                                         const int64_t* __restrict__ src,
                                         int n, int lane) {
  int i = lane;
  for (; i + 96 < n; i += 128) {
    const int64_t v0 = src[i], v1 = src[i + 32], v2 = src[i + 64],
                  v3 = src[i + 96];
    dst[i] = v0;
    dst[i + 32] = v1;
    dst[i + 64] = v2;
    dst[i + 96] = v3;
  }
  for (; i < n; i += 32) dst[i] = src[i];
}

// The m1 word of the root entry of strand a: state M, i = the read's length.
__device__ __forceinline__ uint32_t root_m1(int state_m, uint32_t a,
                                            int64_t len) {
  return (uint32_t)state_m | (a << 2) | ((uint32_t)len << 3);
}

// The arena of a read about to start: every thread writes the slots it owns
// (slot & 31 == lane) of the five rows, wherever they are.
__device__ __forceinline__ void root_arena(int lane, int32_t* key,
                                           int32_t* sk, int32_t* sl,
                                           int32_t* sm1, int32_t* sm2,
                                           int acap, int64_t len,
                                           int64_t seq_len, int max_seq,
                                           int state_m) {
  for (int s = lane; s < acap; s += 32)
    key[s] = s < 2 ? max_seq - s : INT_MAX;
  if (lane < 2) {
    sk[lane] = 0;
    sl[lane] = (int32_t)(uint32_t)seq_len;
    sm1[lane] = (int32_t)root_m1(state_m, (uint32_t)lane, len);
    sm2[lane] = 0;
  }
}

// The best score before the first hit: above every score the budget allows.
__device__ __forceinline__ int64_t start_best_score(int64_t max_diff,
                                                    int s_mm, int s_gapo,
                                                    int s_gape, int max_gapo,
                                                    int max_gape) {
  return (max_diff + 1) * s_mm + (int64_t)(max_gapo + 1) * s_gapo +
         (int64_t)(max_gape + 1) * s_gape;
}

}  // namespace ibwa_switch

#endif  // IBWA_LANE_SWITCH_CUH
