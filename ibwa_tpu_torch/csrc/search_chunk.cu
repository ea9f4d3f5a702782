// K8: a whole chunk of the persistent aln search in ONE launch.  Every warp
// is a search lane that takes reads from a queue: start a read, step until
// it is done or routed to the host search, flush it, take the next, stop
// when the queue is empty.
//
// Replaces: the while_loop of ibwa_tpu/align/engine_jax.py::
// _run_search_persistent (XLA, :888) with its `switch` closure (:775) and
// the fori_loop over _search_step (:885); in this package the phased loop of
// align/engine.py::run_search_phased, which on a card is one lane_switch
// launch, one search_steps launch and one copy to the host per SWITCH_K
// steps.  It computes what that loop computes: n_hits, fb and hits[r,
// :n_hits[r]] of every read that is not fb, bitwise (the phased loop copies
// a lane's whole hit rows out, stale words beyond n_hits included, which no
// caller reads; here those words stay zero), and the step count through the
// host (below).
//
// Why one launch can, and why a queue: lanes never talk to each other.  A
// read's search reads and writes its own rows and its lane's arena only; the
// shared words are counters.  On the TPU a lane was a row of a lockstep
// vector, so lane b took reads b, b + B, ...; on the card the warps are
// independent, and with that static split a launch was as long as its
// slowest lane (on the smoke chunk two reads, 740 iterations against a
// mean of 508).
// Here a warp that flushes a read takes the next from one atomic counter,
// and there are as many warps as the card holds at once, so a chunk's
// launch is about as long as its longest read.
//
// Bound on an H100: latency, the chain of the longest read (its iterations
// x the chain of one step, search_step.cuh), and behind it the warp
// instructions of all reads' steps at four a clock an SM; the bytes (FM
// rows, the reads' planes and outputs touched once) are two orders below.
//
// Design:
//   * the grid is the blocks the card holds at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, no more warps
//     than reads), four lanes a block; the step keeps no ten-wide arrays
//     (one thread a child, search_step.cuh), so __launch_bounds__(128, 4)
//     holds it at 128 registers with no spill and four blocks an SM fit at
//     ACAP 256 (4 x 20.5 KB of arena).  At ACAP 1,024 a block's arena is
//     81 KB and shared memory allows two blocks an SM; the occupancy call
//     says so and the grid follows;
//   * the step stage is search_step.cuh: the lane's five arena rows live in
//     shared memory for the lane's whole life and are never written back,
//     its scalars in registers across reads, the next pop's rows asked for
//     before the key pass (template PF);
//   * the switch stage copies nothing.  A read's rows of the chunk's big_w /
//     big_bid / big_meta planes are read by exactly one lane, once: the lane
//     works on them where they are, so THE THREE PLANES ARE UPDATED IN PLACE
//     (gap_shadow) and a caller that wants them again recomputes them.  Hits
//     go straight into the read's rows of out_hm / out_hk / out_hl (which
//     the duplicate test reads back); a flush is the read's words of out_nh,
//     out_fb, out_it and out_cause; a start is lane_switch.cuh's root arena
//     and a dozen registers;
//   * the phased loop's clock left the kernel: each read's own iteration
//     count goes out (out_it: the iteration that set its done / fb flag, 0
//     for a bad read, at most it_cap, the loop's bound, where a read that
//     has not ended stops), and align/engine.py::chunk_schedule computes the
//     phased loop's step count from those counts and its lane count, and
//     which reads the loop would have flushed before its bound;
//   * out_cause is why a read fell back (search_step.cuh's kCause*);
//   * counters = {reads taken from the queue, reads flushed, the longest
//     lane's iterations, all iterations, the FM rows their steps needed,
//     then reads routed to the host by iter_cap, arena, hit capacity,
//     seqno, and the E-chain's fetches among the rows}: an atomic a read
//     for the queue and a fallback's cause, the rest one atomic each per
//     lane at its end.
//
// Mode 2 is the profiling instantiation (template PROF): the same step with
// clock64 marks between its stages, each lane's sums written to `prof`
// (ibwa_tpu_torch/profile_step.py --mode stages); the engine never picks it.
//
// Two instantiations of the same body, by row source (fm_row.cuh): the flat
// table (search_chunk_kernel), and the table split by rows into ranges
// (search_chunk_sharded_kernel, B8: replaces the masked gather + psum of
// ibwa_tpu/fm/device.py::_gather_block's sharded branch, :309-319, that
// ibwa_tpu/parallel/mesh.py::run_sharded_index_search runs).  The sharded
// one takes its arguments as a __grid_constant__, so the ranges' base
// pointers are read from the parameter space at each fetch; the launch picks
// it when the arguments' shard table is in use.  Ranges on other cards are
// read through peer pointers (fm_row.cuh, peer.cu).  The first version of
// this kernel (static lanes, every thread all ten children) is
// search_chunk_first.cu, kept to be timed beside this one.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_switch.cuh"
#include "search_step.cuh"

// The launch arguments: align/engine.py::_ChunkArgs mirrors this layout
// field for field.
struct IbwaChunkArgs {
  // outputs, one row per read, zero on entry
  int64_t* out_hm;
  int64_t* out_hk;
  int64_t* out_hl;
  int64_t* out_nh;
  bool* out_fb;
  int32_t* out_it;
  int32_t* out_cause;
  unsigned long long* counters;  // [10], zero on entry
  long long* prof;  // mode 2: [lanes, kStages] clocks, zero on entry
  // per read: length, diff budget, flags, and the width pass's planes
  const int64_t* read_lens;
  const int64_t* read_max_diff;
  const bool* read_has_seed;
  const bool* read_bad;
  int64_t* big_w;
  int64_t* big_bid;
  int64_t* big_meta;
  IbwaSearchCfg c;
  int64_t it_cap;  // iterations a read runs at most: the loop's bound
  int N;
  int max_blocks;  // > 0: at most this many blocks (tests, profiles)
};

namespace {

using namespace ibwa_step;

constexpr int kBlocksPerSm = 4;  // the residency the launch bounds ask for

template <int WPB, bool PF, bool PROF, class Rows>
__device__ __forceinline__ void search_chunk_body(const IbwaChunkArgs& a) {
  extern __shared__ __align__(16) int32_t arena[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const IbwaSearchCfg& c = a.c;
  const int64_t n2p = 2 * (int64_t)(c.L + c.SL + 2);
  const Index<Rows> ix = load_index<Rows>(c);
  LaneRows p;
  arena_rows(arena, warp, c.acap, p);
  LaneState s;
  NextPop next;
  StageClock<PROF> clk;
  if constexpr (PROF) {
    for (int i = 0; i < kStages; ++i) clk.t[i] = 0;
  }

  s.rows = 0;
  s.efetch = 0;
  unsigned flushed = 0;  // reads this lane flushed
  unsigned iters = 0;    // iterations this lane ran
  for (;;) {
    // ---- the queue: lane 0 takes the next read, the warp follows
    unsigned long long taken = 0;
    if (lane == 0) taken = atomicAdd(a.counters, 1ull);
    const int64_t rid = (int64_t)__shfl_sync(kFullWarp, taken, 0);
    if (rid >= a.N) break;  // uniform

    // ---- switch stage, start: the read's rows where they are, a root
    // arena, the scalars of a fresh read
    p.w = a.big_w + rid * n2p;
    p.bid = a.big_bid + rid * n2p;
    p.meta = a.big_meta + rid * n2p;
    p.hm = a.out_hm + rid * c.hcap;
    p.hk = a.out_hk + rid * c.hcap;
    p.hl = a.out_hl + rid * c.hcap;
    p.seq2 = c.seqs + rid * 2 * c.L;
    const int64_t len = a.read_lens[rid];
    const int64_t md = a.read_max_diff[rid];
    __syncwarp();  // every thread has read the last read's last pop
    ibwa_switch::root_arena(lane, p.key, p.sk, p.sl, p.sm1, p.sm2, c.acap, len,
                            c.seq_len, c.max_seq, c.state_m);
    s.lens = (int)len;
    s.has_seed = a.read_has_seed[rid];
    s.max_diff = (int)md;
    s.lane_it = 0;
    s.seqc = 2;
    s.stack_n = 2;
    s.n_hits = 0;
    s.best_score = (int)ibwa_switch::start_best_score(
        md, c.s_mm, c.s_gapo, c.s_gape, c.max_gapo, c.max_gape);
    s.best_cnt = 0;
    s.done = a.read_bad[rid];  // too many Ns: nothing to search
    s.fb = false;
    s.cause = kCauseNone;
    s.used = 1;  // the two roots
    s.pop.slot = 1;
    s.pop.key = c.max_seq - 1;
    s.pop.k = 0;
    s.pop.l = (uint32_t)c.seq_len;
    s.pop.m1 = ibwa_switch::root_m1(c.state_m, 1u, len);
    s.pop.m2 = 0;
    if (PF) copy_async_wait();  // the last read's rows asked ahead
    next.valid = false;

    // ---- step stage: j counts to the iteration that sets a flag, or to
    // the loop's bound, past which no switch of the phased loop would see it
    int j = 0;
    while (!(s.done || s.fb) && j < a.it_cap) {
      ++j;
      clk.start();
      search_step<WPB, PF>(c, ix, p, s, next, lane, clk);
    }
    iters += j;

    // ---- switch stage, flush
    ++flushed;
    if (lane == 0) {
      a.out_nh[rid] = s.n_hits;
      a.out_fb[rid] = s.fb;
      a.out_it[rid] = (int32_t)j;
      a.out_cause[rid] = s.cause;
      if (s.fb) atomicAdd(a.counters + 4 + s.cause, 1ull);
    }
  }

  if (PF) copy_async_wait();  // no copy into shared memory outlives it
  if (lane == 0) {
    atomicAdd(a.counters + 1, (unsigned long long)flushed);
    atomicMax(a.counters + 2, (unsigned long long)iters);
    atomicAdd(a.counters + 3, (unsigned long long)iters);
    atomicAdd(a.counters + 4, (unsigned long long)s.rows);
    atomicAdd(a.counters + 9, (unsigned long long)s.efetch);
    if constexpr (PROF) {
      long long* out = a.prof + ((int64_t)blockIdx.x * kWarps + warp) *
                                    kStages;
      for (int i = 0; i < kStages; ++i) out[i] = clk.t[i];
    }
  }
}

template <int WPB, bool PF, bool PROF>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
    search_chunk_kernel(const IbwaChunkArgs a) {
  search_chunk_body<WPB, PF, PROF, FlatRows>(a);
}

template <int WPB, bool PF, bool PROF>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
    search_chunk_sharded_kernel(const __grid_constant__ IbwaChunkArgs a) {
  search_chunk_body<WPB, PF, PROF, ShardRows>(a);
}

// The grid of a launch: the blocks an SM the card holds of the kernel at
// this arena size, times its SMs; no more lanes than reads, and at most
// max_blocks when that is set.
template <class K>
cudaError_t launch_shape(K kernel, const IbwaChunkArgs& a, size_t smem,
                         int& per_sm, int& sms, int& grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kWarps * 32, smem);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int64_t need = ((int64_t)a.N + kWarps - 1) / kWarps;
  int64_t g = (int64_t)per_sm * sms;
  if (g > need) g = need;
  if (a.max_blocks > 0 && g > a.max_blocks) g = a.max_blocks;
  grid = (int)g;
  return cudaSuccess;
}

template <int WPB, bool PF, bool PROF>
int launch(const IbwaChunkArgs& a, cudaStream_t st, int* shape) {
  const size_t smem = arena_bytes(a.c.acap);
  const bool sharded = a.c.shards.n > 0;
  int per_sm = 0, sms = 0, grid = 0;
  const cudaError_t e =
      sharded ? launch_shape(search_chunk_sharded_kernel<WPB, PF, PROF>, a,
                             smem, per_sm, sms, grid)
              : launch_shape(search_chunk_kernel<WPB, PF, PROF>, a, smem,
                             per_sm, sms, grid);
  if (e != cudaSuccess) return (int)e;
  if (shape) {
    shape[0] = per_sm;
    shape[1] = sms;
    shape[2] = grid;
    shape[3] = (int)smem;
    return 0;
  }
  if (sharded)
    search_chunk_sharded_kernel<WPB, PF, PROF>
        <<<grid, kWarps * 32, smem, st>>>(a);
  else
    search_chunk_kernel<WPB, PF, PROF><<<grid, kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int WPB>
int launch_mode(const IbwaChunkArgs& a, int mode, cudaStream_t st,
                int* shape) {
  switch (mode) {
    case 0:
      return launch<WPB, false, false>(a, st, shape);
    case 1:
      return launch<WPB, true, false>(a, st, shape);
    default:
      return launch<WPB, true, true>(a, st, shape);
  }
}

int dispatch(const IbwaChunkArgs& a, int mode, cudaStream_t st, int* shape) {
  if (a.N <= 0 || mode < 0 || mode > 2 || a.it_cap <= 0 || a.c.acap < 32 || a.c.acap % 32 ||
      arena_bytes(a.c.acap) > 227 * 1024 || a.c.n_reads != a.N ||
      a.c.L <= 0 || a.c.hcap <= 0 ||
      !ibwa_fm::shards_ok(a.c.shards, 2 * a.c.n_blk))
    return (int)cudaErrorInvalidValue;
  switch (a.c.intv) {
    case 32:
      return launch_mode<2>(a, mode, st, shape);
    case 64:
      return launch_mode<4>(a, mode, st, shape);
    case 128:
      return launch_mode<8>(a, mode, st, shape);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `mode` picks the step: 1 the one the engine runs; 0 the same without the
// rows of the next pop asked for ahead, to be timed beside it; 2 mode 1
// with the stages' clocks written to `prof`.  All compute the same.  A
// shard table in use (0 < c.shards.n <= kMaxShards, rows a multiple of its
// range size) picks the sharded instantiation.
extern "C" int ibwa_search_chunk(const IbwaChunkArgs* args, int mode,
                                 void* stream) {
  if (args->N <= 0) return 0;
  if (mode == 2 && !args->prof) return (int)cudaErrorInvalidValue;
  return dispatch(*args, mode, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch `ibwa_search_chunk` would make with these arguments, launching
// nothing: out = {blocks an SM, SMs, blocks, shared bytes a block}.
extern "C" int ibwa_search_chunk_shape(const IbwaChunkArgs* args, int mode,
                                       int* out) {
  return dispatch(*args, mode, nullptr, out);
}
