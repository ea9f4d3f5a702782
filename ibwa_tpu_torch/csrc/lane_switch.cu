// K7: the switch phase of the persistent search lanes: every lane that has
// finished its read (done, or routed to the host search) flushes its hits to
// the read's output rows and loads its next read, or parks.
//
// Replaces: the `switch` closure of ibwa_tpu/align/engine_jax.py::
// _run_search_persistent (XLA: five dropped scatters, then a where() over
// every plane of every lane); in this package align/engine.py::
// _Chunk.switch_plain with _load_lanes, ~190 torch launches that rewrite
// every plane of every lane each phase.  It leaves the 30 fields of the lane
// state, the five output arrays and the count of reads left bitwise equal to
// the plain switch: a lane that has not finished is not touched, a loaded
// lane gets its width rows, a whole key row, arena slots 0 and 1 and its
// scalars (slots >= 2 of the payload planes and the hit rows keep their stale
// words, as the plain switch leaves them), a parked lane only its flags and
// its read index.  On the main path a chunk runs in search_chunk.cu, whose
// switch stage copies nothing (a lane works on its read's rows of the chunk's
// planes and outputs where they are); this entry stays for the phased loop,
// the plain version of that kernel's loop driven with kernels on the card.
// What a read starts with is lane_switch.cuh, shared by both.
//
// Bound on an H100: bytes, and at the usual ~40 finishing lanes of 1,024 a
// launch is launch-latency sized.  Per loaded lane 3 x 2 x P words in and
// out, the key row out, and per flushed lane three hit rows in and out; the
// case to time is the first switch of a chunk, where every lane loads.  In a
// usual phase a finishing lane's copies are a chain of round trips that ~40
// busy warps cannot hide: the reason the chunk kernel does without them.
//
// Design: one warp per lane, 4 lanes per block, the layout of
// search_step.cu.  A lane's flags are the same in all 32 threads, so an
// unfinished lane's warp returns at once and every branch is uniform.  The
// row copies are warp-wide, thread t on word t of each 32-word stretch
// (coalesced 256 B), four stretches in flight at a time.  Scalars are
// written by thread 0; the flags and the read index, which every thread read
// at the top, only after a warp barrier.  The count of reads left goes down
// by one atomic per flushed lane.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_switch.cuh"

namespace {

constexpr int kWarps = 4;  // lanes per block

}  // namespace

// The launch arguments: align/engine.py::_SwitchArgs mirrors this layout
// field for field.  The first 30 pointers are the fields of SearchState in
// its order (as in IbwaStepArgs), then the chunk's outputs and per-read
// arrays.
struct IbwaSwitchArgs {
  int64_t* rid;
  int64_t* lens;
  bool* has_seed;
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
  const int64_t* hk;
  const int64_t* hl;
  const int64_t* hm;
  int64_t* n_hits;
  int64_t* best_score;
  int64_t* best_cnt;
  int64_t* max_diff;
  bool* done;
  bool* fb;
  const int64_t* it;
  int64_t* pslot;
  int64_t* pkey;
  int64_t* pk;
  int64_t* pl;
  int64_t* pm1;
  int64_t* pm2;
  // the chunk's outputs, one row per read, and the reads not yet flushed
  int64_t* out_hm;
  int64_t* out_hk;
  int64_t* out_hl;
  int64_t* out_nh;
  bool* out_fb;
  unsigned long long* remaining;
  // per read: length, diff budget, flags, and the width pass's planes
  const int64_t* read_lens;
  const int64_t* read_max_diff;
  const bool* read_has_seed;
  const bool* read_bad;
  const int64_t* big_w;
  const int64_t* big_bid;
  const int64_t* big_meta;
  int64_t seq_len;
  int B, N, P, acap, hcap;
  int s_mm, s_gapo, s_gape, max_gapo, max_gape;
  int max_seq, state_m;
};

namespace {

using namespace ibwa_switch;

__global__ void __launch_bounds__(kWarps * 32)
    lane_switch_kernel(const IbwaSwitchArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= a.B) return;  // uniform across the warp
  const bool fb = a.fb[row];
  if (!(a.done[row] || fb)) return;  // mid-search: nothing of it changes
  int64_t rid = a.rid[row];
  __syncwarp();  // all 32 have read the flags and rid that thread 0 rewrites

  // ---- flush the finished read's hits to its output rows
  if (rid >= 0 && rid < a.N) {
    copy_row(a.out_hm + rid * a.hcap, a.hm + row * a.hcap, a.hcap, lane);
    copy_row(a.out_hk + rid * a.hcap, a.hk + row * a.hcap, a.hcap, lane);
    copy_row(a.out_hl + rid * a.hcap, a.hl + row * a.hcap, a.hcap, lane);
    if (lane == 0) {
      a.out_nh[rid] = a.n_hits[row];
      a.out_fb[rid] = fb;
      atomicAdd(a.remaining, ~0ull);  // one read less
    }
  }

  // ---- the lane's next read: rid + B, or none left
  rid += a.B;
  const bool load = rid < a.N;
  if (load) {
    const int64_t crid = rid < 0 ? 0 : rid;
    const int64_t n2p = 2 * (int64_t)a.P;
    copy_row(a.w + row * n2p, a.big_w + crid * n2p, (int)n2p, lane);
    copy_row(a.bid + row * n2p, a.big_bid + crid * n2p, (int)n2p, lane);
    copy_row(a.meta + row * n2p, a.big_meta + crid * n2p, (int)n2p, lane);
    const int64_t len = a.read_lens[crid];
    const int64_t at = row * a.acap;
    root_arena(lane, a.key + at, a.sk + at, a.sl + at, a.sm1 + at, a.sm2 + at,
               a.acap, len, a.seq_len, a.max_seq, a.state_m);
    if (lane == 0) {
      const int64_t md = a.read_max_diff[crid];
      a.lens[row] = len;
      a.has_seed[row] = a.read_has_seed[crid];
      a.max_diff[row] = md;
      a.seqc[row] = 2;
      a.stack_n[row] = 2;
      a.pslot[row] = 1;
      a.pkey[row] = a.max_seq - 1;
      a.pk[row] = 0;
      a.pl[row] = a.seq_len;
      a.pm1[row] = (int64_t)root_m1(a.state_m, 1u, len);
      a.pm2[row] = 0;
      a.lane_it[row] = 0;
      a.n_hits[row] = 0;
      a.best_score[row] = start_best_score(md, a.s_mm, a.s_gapo, a.s_gape,
                                           a.max_gapo, a.max_gape);
      a.best_cnt[row] = 0;
      a.done[row] = a.read_bad[crid];  // too many Ns: nothing to search
    }
  } else if (lane == 0) {
    a.done[row] = true;  // parked
  }
  if (lane == 0) {
    a.rid[row] = rid;
    a.fb[row] = false;
  }
}

}  // namespace

extern "C" int ibwa_lane_switch(const IbwaSwitchArgs* args, void* stream) {
  const IbwaSwitchArgs& a = *args;
  if (a.B <= 0) return 0;
  if (a.N <= 0 || a.P <= 0 || a.acap < 2 || a.hcap <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (a.B + kWarps - 1) / kWarps;
  lane_switch_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
