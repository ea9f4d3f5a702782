// K8: a whole chunk of the persistent aln search in ONE launch.  Every warp
// takes its lane through all of the lane's reads: start a read, step until
// it is done or routed to the host search, flush it, start the next, stop
// when none is left.
//
// Replaces: the while_loop of ibwa_tpu/align/engine_jax.py::
// _run_search_persistent (XLA, :888) with its `switch` closure (:775) and
// the fori_loop over _search_step (:885); in this package the phased loop of
// align/engine.py::run_search_phased, which on a card is one lane_switch
// launch, one search_steps launch and one copy to the host per SWITCH_K
// steps.  It computes what that loop computes: n_hits, fb and the step count
// bitwise, and hits[r, :n_hits[r]] of every read that is not fb (the phased
// loop copies a lane's whole hit rows out, stale words beyond n_hits
// included, which no caller reads; here those words stay zero).
//
// Why one launch can: lanes never talk to each other.  Lane b takes reads
// b, b + B, b + 2B, ...; a switch reads and writes that lane's state and
// that read's rows only; the one shared word is a counter.  The phase
// existed because XLA needed a while_loop over a fori_loop and a host in the
// loop; a warp needs neither, so there is no grid barrier and no
// cooperative launch here, and a lane that finishes a read starts its next
// at once.
//
// Bound on an H100: latency, the chain of the slowest lane (its reads'
// iterations x the chain of one step, search_step.cuh); the bytes (FM rows,
// the reads' planes and outputs touched once) are two orders below.
//
// Design:
//   * the step stage is search_step.cuh: the lane's five arena rows live in
//     shared memory for the lane's whole life and are never written back
//     (4 lanes a block: 20 KB at ACAP 256, 80 KB at ACAP 1,024, so dynamic
//     shared memory above 48 KB), its scalars in registers across reads, the
//     next pop's rows asked for before the key pass (template PF);
//   * the switch stage copies nothing.  A read's rows of the chunk's big_w /
//     big_bid / big_meta planes are read by exactly one lane, once: the lane
//     works on them where they are, so THE THREE PLANES ARE UPDATED IN PLACE
//     (gap_shadow) and a caller that wants them again recomputes them.  Hits
//     go straight into the read's rows of out_hm / out_hk / out_hl (which
//     the duplicate test reads back); a flush is out_nh[rid], out_fb[rid]
//     and the counter; a start is lane_switch.cuh's root arena and a dozen
//     registers;
//   * the step count of the phased loop is reproduced, not redefined: each
//     lane keeps `t`, its position on that loop's clock.  A read started at t
//     whose done / fb flag is set in its j-th iteration (j = 0: a bad read,
//     done at its start) is flushed by the switch at
//     t + switch_k * max(1, ceil(j / switch_k)), where the lane's next read
//     starts.  A flush at or after t_end (the loop's iteration bound, rounded
//     up to a phase) never happens: the lane stops and leaves the count of
//     reads left above zero.  counters[1] is the largest flush clock plus
//     switch_k (the phased loop runs the steps of the phase whose switch
//     flushed the last read), or t_end.  align/engine.py::chunk_steps is the
//     same arithmetic in numpy;
//   * counters = {reads left, steps, the longest lane's iterations, all
//     lanes' iterations, the FM rows their steps needed}, one atomic each per
//     lane at its end.
//
// Two instantiations of the same body, by row source (fm_row.cuh): the flat
// table (search_chunk_kernel), and the table split by rows into ranges
// (search_chunk_sharded_kernel, B8: replaces the masked gather + psum of
// ibwa_tpu/fm/device.py::_gather_block's sharded branch, :309-319, that
// ibwa_tpu/parallel/mesh.py::run_sharded_index_search runs).  The sharded
// one takes its arguments as a __grid_constant__, so the ranges' base
// pointers are read from the parameter space at each fetch; the launch picks
// it when the arguments' shard table is in use.  Ranges on other cards are
// read through peer pointers (fm_row.cuh, peer.cu).

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
  unsigned long long* counters;  // [5]: {N, 0, 0, 0, 0} on entry
  // per read: length, diff budget, flags, and the width pass's planes
  const int64_t* read_lens;
  const int64_t* read_max_diff;
  const bool* read_has_seed;
  const bool* read_bad;
  int64_t* big_w;
  int64_t* big_bid;
  int64_t* big_meta;
  IbwaSearchCfg c;
  int64_t t_end;
  int B, N, switch_k;
};

namespace {

using namespace ibwa_step;

template <int WPB, bool PF, class Rows>
__device__ __forceinline__ void search_chunk_body(const IbwaChunkArgs& a) {
  extern __shared__ int32_t arena[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= a.B) return;  // uniform across the warp

  const IbwaSearchCfg& c = a.c;
  const int64_t n2p = 2 * (int64_t)(c.L + c.SL + 2);
  const Index<Rows> ix = load_index<Rows>(c);
  LaneRows p;
  arena_rows(arena, warp, c.acap, p);
  LaneState s;
  NextRows<WPB> next;

  s.rows = 0;
  int64_t t = 0;        // the lane's position on the phased loop's clock
  int64_t flushed = 0;  // reads this lane flushed
  int64_t iters = 0;    // iterations this lane ran
  bool stopped = false;
  for (int64_t rid = row; rid < a.N; rid += a.B) {
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
    s.used = 1;  // the two roots
    s.pop.slot = 1;
    s.pop.key = c.max_seq - 1;
    s.pop.k = 0;
    s.pop.l = (uint32_t)c.seq_len;
    s.pop.m1 = ibwa_switch::root_m1(c.state_m, 1u, len);
    s.pop.m2 = 0;
    next.valid = false;

    // ---- step stage: j counts to the iteration that sets a flag; past the
    // loop's bound no switch would see it
    int64_t j = 0;
    while (!(s.done || s.fb) && t + j < a.t_end) {
      ++j;
      search_step<WPB, PF>(c, ix, p, s, next, lane);
    }
    iters += j;

    // ---- switch stage, flush: at the first switch of the phased loop that
    // sees the flag
    const int64_t phases = j <= a.switch_k ? 1 : (j + a.switch_k - 1) /
                                                     a.switch_k;
    const int64_t at = t + phases * a.switch_k;
    if (at >= a.t_end) {  // the loop's bound: this read stays unflushed
      stopped = true;
      break;
    }
    t = at;
    ++flushed;
    if (lane == 0) {
      a.out_nh[rid] = s.n_hits;
      a.out_fb[rid] = s.fb;
    }
  }

  if (lane == 0) {
    if (flushed) atomicAdd(a.counters, 0ull - (unsigned long long)flushed);
    if (stopped)
      atomicMax(a.counters + 1, (unsigned long long)a.t_end);
    else if (flushed)
      atomicMax(a.counters + 1, (unsigned long long)(t + a.switch_k));
    atomicMax(a.counters + 2, (unsigned long long)iters);
    atomicAdd(a.counters + 3, (unsigned long long)iters);
    atomicAdd(a.counters + 4, (unsigned long long)s.rows);
  }
}

// (two blocks an SM: 1,024 lanes are 256 blocks on 132 SMs, and a bound of
// three would cap the step at 168 registers, which spills)
template <int WPB, bool PF>
__global__ void __launch_bounds__(kWarps * 32, 2)
    search_chunk_kernel(const IbwaChunkArgs a) {
  search_chunk_body<WPB, PF, FlatRows>(a);
}

template <int WPB, bool PF>
__global__ void __launch_bounds__(kWarps * 32, 2)
    search_chunk_sharded_kernel(const __grid_constant__ IbwaChunkArgs a) {
  search_chunk_body<WPB, PF, ShardRows>(a);
}

template <int WPB, bool PF>
int launch(const IbwaChunkArgs& a, cudaStream_t st) {
  const size_t smem = arena_bytes(a.c.acap);
  const bool sharded = a.c.shards.n > 0;
  const cudaError_t rc =
      sharded ? cudaFuncSetAttribute(
                    search_chunk_sharded_kernel<WPB, PF>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
              : cudaFuncSetAttribute(
                    search_chunk_kernel<WPB, PF>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (a.B + kWarps - 1) / kWarps;
  if (sharded)
    search_chunk_sharded_kernel<WPB, PF><<<grid, kWarps * 32, smem, st>>>(a);
  else
    search_chunk_kernel<WPB, PF><<<grid, kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int WPB>
int launch_mode(const IbwaChunkArgs& a, int mode, cudaStream_t st) {
  return mode ? launch<WPB, true>(a, st) : launch<WPB, false>(a, st);
}

}  // namespace

// `mode` picks the step: 1 the one the engine runs; 0 the same without the
// rows of the next pop asked for ahead, to be timed beside it.  Both compute
// the same.  A shard table in use (0 < c.shards.n <= kMaxShards, rows a
// multiple of its range size) picks the sharded instantiation.
extern "C" int ibwa_search_chunk(const IbwaChunkArgs* args, int mode,
                                 void* stream) {
  const IbwaChunkArgs& a = *args;
  if (a.B <= 0) return 0;
  if (mode < 0 || mode > 1 || a.N <= 0 || a.switch_k <= 0 || a.t_end <= 0 ||
      a.c.acap < 32 ||
      a.c.acap % 32 || arena_bytes(a.c.acap) > 227 * 1024 ||
      a.c.n_reads != a.N || a.c.L <= 0 || a.c.hcap <= 0 ||
      !ibwa_fm::shards_ok(a.c.shards, 2 * a.c.n_blk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.c.intv) {
    case 32:
      return launch_mode<2>(a, mode, st);
    case 64:
      return launch_mode<4>(a, mode, st);
    case 128:
      return launch_mode<8>(a, mode, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
