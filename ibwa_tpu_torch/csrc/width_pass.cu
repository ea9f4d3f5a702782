// K6: the width pass of a chunk of reads: bwt_cal_width (bwtaln.c:54-78)
// over every read, strand and segment (the whole read, then its seed
// suffix), and the packed pop-time summary of the two planes it fills.
//
// Replaces: ibwa_tpu/align/engine_jax.py::_compute_widths (the fori_loop
// over the bases), ::_pack_meta and their assembly at the head of
// _run_search_persistent (XLA); in this package align/engine.py::
// big_planes_plain, which runs one occ1_pair launch and a dozen torch ops
// per base.  The occ query of a base is K2's device code (fm_row.cuh), here
// a stage of the chain.  It writes w / bid / meta, int64[N, 2, P] with
// P = L + SL + 2, bitwise equal to big_planes_plain: columns 0..L the main
// segment, L+1..L+SL+1 the seed segment.
//
// Bound on an H100: latency.  A chain is serial: base t needs the interval
// (k, l) base t-1 left, and each base is two dependent FM row fetches met in
// HBM.  The bytes (three planes written once, two 32 B rows per base) would
// take a fifth of the time the longest chain's fetches do.
//
// Design: one thread per chain, k, l, the reset count b and the previous
// column in registers, all arithmetic in native u32.  The two rows of a
// base (k - 1 and l) are fetched before either is counted, so both loads
// are in flight together, and the read's next base is loaded beside them; a
// base that is no base (N, padding) or lies beyond the read resets or skips
// without a fetch.  The main and the seed chain of a (read, strand) pair run
// in two threads of one block, in different warps (warp 0 walks 32 main
// chains, warp 1 their seed chains), so the pass takes the main chain's
// length, not the sum.  meta is packed over the concatenated row, so the
// seed segment's first column looks back at the main segment's last: the
// main thread leaves that column's bid in shared memory and the seed thread
// packs its first word after the block's barrier.  A thread stores along its
// own row, 8 bytes at a time, rows 16 * P bytes apart: uncoalesced, and
// beside the fetch latency it does not show.
//
// Two instantiations of the same body, by row source (fm_row.cuh): the flat
// table (ibwa_width_pass) and the table split by rows into ranges
// (ibwa_width_pass_sharded, B8: the occ1 rows of ibwa_tpu/fm/device.py::
// _gather_block's sharded branch, :309-319, read where they lie; the shard
// table is a __grid_constant__ argument, its ranges maybe on other cards
// through peer pointers).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "fm_row.cuh"

namespace {

using namespace ibwa_fm;

constexpr int kChains = 32;  // (read, strand) pairs per block, one warp wide

// bid[i-1] | bid[i] << 14 | (w[i-1] == w[i]) << 28 (engine.py::_pack_meta)
__device__ __forceinline__ int64_t pack_meta(uint32_t pw, int pb, uint32_t w,
                                             int b) {
  return (int64_t)(((uint64_t)pb | ((uint64_t)b << 14) |
                    ((uint64_t)(pw == w ? 1 : 0) << 28)) &
                   0xFFFFFFFFull);
}

template <int WPB, class Rows>
__device__ __forceinline__ void width_pass_body(
    const Rows& src, const int64_t* __restrict__ primary,
    const int64_t* __restrict__ L2, const int64_t* __restrict__ l2diff,
    const uint8_t* __restrict__ seqs, const uint8_t* __restrict__ seed_seqs,
    const int64_t* __restrict__ lens, const bool* __restrict__ has_seed,
    int64_t* __restrict__ w, int64_t* __restrict__ bid,
    int64_t* __restrict__ meta, int n_reads, int L, int SL, uint32_t seq_len,
    uint32_t n_blk) {
  __shared__ int main_end[kChains];  // bid of the main segment's column L
  const int seg = threadIdx.x / kChains;  // 0 main, 1 seed: one warp each
  const int slot = threadIdx.x % kChains;
  const int64_t chain = (int64_t)blockIdx.x * kChains + slot;  // read*2+strand
  const bool live = chain < 2 * (int64_t)n_reads;
  const int P = L + SL + 2;
  int64_t first = 0;   // the seed segment's first column in the planes
  uint32_t first_w = 0;
  int first_b = 0;

  if (live) {
    const int64_t read = chain >> 1;
    const uint32_t strand = (uint32_t)(chain & 1);
    const int Lw = seg ? SL : L;
    const int64_t len = seg ? (has_seed[read] ? SL : 0) : lens[read];
    const int n = (int)(len < Lw ? len : Lw);  // the terminator's column
    const uint8_t* sq = seg ? seed_seqs + chain * SL : seqs + chain * L;
    const int64_t at = chain * P + (seg ? L + 1 : 0);
    first = at;
    const uint32_t l2[4] = {(uint32_t)L2[0], (uint32_t)L2[1], (uint32_t)L2[2],
                            (uint32_t)L2[3]};
    const uint32_t l2d[4] = {(uint32_t)l2diff[0], (uint32_t)l2diff[1],
                             (uint32_t)l2diff[2], (uint32_t)l2diff[3]};
    const uint32_t prim = (uint32_t)primary[strand];

    uint32_t k = 0, l = seq_len, pw = 0;
    int b = 0, pb = 0;
    uint32_t c_next = n > 0 ? __ldg(sq) : 4u;
    for (int t = 0; t <= Lw; ++t) {
      uint32_t wv = 0;
      int bv = 0;
      if (t < n) {
        // the next base is asked for now, so that its load is over when
        // this base's rows are: only the row fetches are on the chain
        const uint32_t c = c_next;
        if (t + 1 < n) c_next = __ldg(sq + t + 1);
        bool reset = true;  // no base: the interval starts over
        if (c < 4) {
          OccRow<WPB> r0, r1;
          fetch_occ_row<WPB>(src, k - 1u, prim, seq_len, n_blk, strand, r0);
          fetch_occ_row<WPB>(src, l, prim, seq_len, n_blk, strand, r1);
          const uint32_t k2 = pick4(l2, c) + occ_count<WPB>(r0, c, l2d) + 1u;
          const uint32_t l2v = pick4(l2, c) + occ_count<WPB>(r1, c, l2d);
          reset = k2 > l2v;
          if (!reset) {
            k = k2;
            l = l2v;
          }
        }
        if (reset) {
          k = 0;
          l = seq_len;
          ++b;
        }
        wv = l - k + 1u;
        bv = b;
      } else if (t == n) {
        bv = b + 1;  // the terminator: w = 0, bid = b + 1; zeros beyond it
      }
      w[at + t] = (int64_t)wv;
      bid[at + t] = (int64_t)bv;
      if (t > 0) {
        meta[at + t] = pack_meta(pw, pb, wv, bv);
      } else if (seg == 0) {  // position 0 clamps i - 1 to 0
        meta[at] = pack_meta(wv, bv, wv, bv);
      } else {  // looks back at the main segment: packed after the barrier
        first_w = wv;
        first_b = bv;
      }
      pw = wv;
      pb = bv;
    }
    if (seg == 0) main_end[slot] = pb;  // column L (its w is always 0)
  }
  __syncthreads();
  if (live && seg == 1)
    meta[first] = pack_meta(0u, main_end[slot], first_w, first_b);
}

#define IBWA_WIDTH_PARAMS                                                   \
  const int64_t *__restrict__ primary, const int64_t *__restrict__ L2,      \
      const int64_t *__restrict__ l2diff, const uint8_t *__restrict__ seqs, \
      const uint8_t *__restrict__ seed_seqs,                                \
      const int64_t *__restrict__ lens, const bool *__restrict__ has_seed,  \
      int64_t *__restrict__ w, int64_t *__restrict__ bid,                   \
      int64_t *__restrict__ meta, int n_reads, int L, int SL,               \
      uint32_t seq_len, uint32_t n_blk
#define IBWA_WIDTH_ARGS                                                   \
  primary, L2, l2diff, seqs, seed_seqs, lens, has_seed, w, bid, meta, \
      n_reads, L, SL, seq_len, n_blk

template <int WPB>
__global__ void __launch_bounds__(2 * kChains)
    width_pass_kernel(const uint32_t* __restrict__ blocks,
                      IBWA_WIDTH_PARAMS) {
  width_pass_body<WPB>(FlatRows{blocks}, IBWA_WIDTH_ARGS);
}

template <int WPB>
__global__ void __launch_bounds__(2 * kChains)
    width_pass_sharded_kernel(const __grid_constant__ IbwaShards shards,
                              IBWA_WIDTH_PARAMS) {
  width_pass_body<WPB>(ShardRows::of(nullptr, shards), IBWA_WIDTH_ARGS);
}

template <int WPB>
void launch_kernel(const uint32_t* blocks, const IbwaShards* shards, int grid,
                   cudaStream_t st, IBWA_WIDTH_PARAMS) {
  if (shards)
    width_pass_sharded_kernel<WPB><<<grid, 2 * kChains, 0, st>>>(
        *shards, IBWA_WIDTH_ARGS);
  else
    width_pass_kernel<WPB><<<grid, 2 * kChains, 0, st>>>(blocks,
                                                          IBWA_WIDTH_ARGS);
}

// One launch over the chunk on `stream`, of the flat kernel (shards null)
// or the sharded one.
int launch_width_pass(const void* blocks, const IbwaShards* shards,
                      const void* primary, const void* L2, const void* l2diff,
                      const void* seqs, const void* seed_seqs,
                      const void* lens, const void* has_seed, void* w,
                      void* bid, void* meta, int n_reads, int L, int SL,
                      int64_t seq_len, int64_t n_blk, int intv,
                      void* stream) {
  if (n_reads <= 0) return 0;
  if (L <= 0 || SL < 0) return (int)cudaErrorInvalidValue;
  if (shards && (shards->n <= 0 || !shards_ok(*shards, 2 * n_blk)))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)((2 * (int64_t)n_reads + kChains - 1) / kChains);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* bl = static_cast<const uint32_t*>(blocks);
  const auto launch = [&](auto wpb) {
    launch_kernel<decltype(wpb)::value>(
        bl, shards, grid, st, static_cast<const int64_t*>(primary),
        static_cast<const int64_t*>(L2), static_cast<const int64_t*>(l2diff),
        static_cast<const uint8_t*>(seqs),
        static_cast<const uint8_t*>(seed_seqs),
        static_cast<const int64_t*>(lens), static_cast<const bool*>(has_seed),
        static_cast<int64_t*>(w), static_cast<int64_t*>(bid),
        static_cast<int64_t*>(meta), n_reads, L, SL, (uint32_t)seq_len,
        (uint32_t)n_blk);
  };
  switch (intv) {
    case 32:
      launch(std::integral_constant<int, 2>());
      break;
    case 64:
      launch(std::integral_constant<int, 4>());
      break;
    case 128:
      launch(std::integral_constant<int, 8>());
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ibwa_width_pass(const void* blocks, const void* primary,
                               const void* L2, const void* l2diff,
                               const void* seqs, const void* seed_seqs,
                               const void* lens, const void* has_seed, void* w,
                               void* bid, void* meta, int n_reads, int L,
                               int SL, int64_t seq_len, int64_t n_blk,
                               int intv, void* stream) {
  return launch_width_pass(blocks, nullptr, primary, L2, l2diff, seqs,
                           seed_seqs, lens, has_seed, w, bid, meta, n_reads,
                           L, SL, seq_len, n_blk, intv, stream);
}

// The same over a table split by rows (B8): `shards` (fm/device.py::Shards)
// in place of the flat table.
extern "C" int ibwa_width_pass_sharded(
    const void* shards, const void* primary, const void* L2,
    const void* l2diff, const void* seqs, const void* seed_seqs,
    const void* lens, const void* has_seed, void* w, void* bid, void* meta,
    int n_reads, int L, int SL, int64_t seq_len, int64_t n_blk, int intv,
    void* stream) {
  if (shards == nullptr) return (int)cudaErrorInvalidValue;
  return launch_width_pass(nullptr, static_cast<const IbwaShards*>(shards),
                           primary, L2, l2diff, seqs, seed_seqs, lens,
                           has_seed, w, bid, meta, n_reads, L, SL, seq_len,
                           n_blk, intv, stream);
}
