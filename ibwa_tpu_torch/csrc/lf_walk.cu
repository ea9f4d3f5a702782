// K5 `lf_walk`: the SA values of a batch's SA intervals, by LF walks to
// the nearest sampled row and a lookup of the sampled array.
//
// Replaces: ibwa_tpu/fm/walk.py::_lf_walk with ::_lf_step, the XLA
// while_loop that resolves SA rows for the SAM stages (reference bwt_sa,
// bwt.c:61-79): `while (k & (sa_intv - 1)) { k = LF(k); ++add; }`, and the
// caller's `add + sampled_sa[k >> log2(sa_intv)]` (u32 wrap), which the
// JAX package and the first version of this kernel left to numpy.
//
// One LF step is one row of the device FM block table (see occ.cu for the
// layout): the 2-bit code c at row k and the inclusive count of c up to k
// both come from that row, and k' = L2[c] + count; k == primary gives 0.
// Unlike the occ queries the sentinel skip is `k > primary` (the row AT
// primary is the special case, not skipped over).
//
// Contract of `ibwa_lf_resolve`: n_iv non-empty intervals, interval i being
// rows ks[i] .. ks[i] + (off[i+1] - off[i]) - 1 of device strand ss[i]
// (0 = forward index; its last row l is implied by off), and the int64
// exclusive prefix `off` of their widths (off[0] = 0).  A launch resolves
// the rows [row_begin, row_end) of that row space (a wave) and writes one
// u32 SA value per row to out[row - row_begin]: interval by interval, k to
// l within each.  stats[0] is the work queue, stats[1] gets the LF steps
// taken, stats[2] the longest walk.
//
// Design, persistent: the grid is as many blocks as the card holds
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), capped
// only where the wave has fewer rows than resident lanes.  A warp takes the
// next 32 rows of the wave from stats[0] with one atomicAdd and keeps them
// as pending rows, one a lane; every lane whose walk has ended takes the
// next pending row (a ballot of the idle lanes, shuffles), and the warp
// takes the next 32 rows when its pending rows are gone.  So a launch pays
// the longest single walk once, not once a dispatch of fixed lanes, and a
// warp's lanes stay busy until the queue runs dry.  Once it is dry, each
// lane ends its walk alone, as the first version's threads do: the vote a
// step is paid only while there are rows to hand out.
//
// Rows are built on the card.  The 32 rows a warp takes are consecutive, so
// the warp finds the interval of the first with one 32-ary search of `off`
// (a probe a lane, a ballot a level: 4 levels for a million intervals,
// shared by the 32 rows) and the others from the next 32 entries of `off`,
// read by the 32 lanes in one coalesced load: the interval starts that fall
// inside the 32 rows are bits of one mask (__reduce_or_sync), and a lane's
// interval is the first one's plus the set bits at or below its row.  That
// holds because no interval is empty: 32 rows then meet at most 32
// intervals.  No owner map is written and no row pays a search of its own.
//
// The last stage is the lookup: out = add + sampled[strand][k >> shift],
// the sampled arrays (u32[n_samp] a strand, strand 0 first) resident on the
// card since the walker was made.  One u32 a row comes back; nothing else.
// Output stores are 4 B each, to the row a lane has just finished: rows of
// a warp's batch are consecutive, so the stores of a batch fall in one or
// two 128 B lines, merged in L2; a staging buffer would buy nothing for 4 B
// a row against ~30 row fetches a row.
//
// Bound on an H100.  Bytes: 8 B an interval in (strand, k) and 8 B of
// `off`, 4 B a row out, each distinct table row once, each sampled word
// touched once.  Operations: ~(6 * wpb + 20) integer operations a step.
// Latency: the longest single walk x one dependent row fetch of one warp
// (the probe's step).  Rows that many walks share stay in L2, so neither
// the table bytes nor the latency bound is a floor in practice; the
// operations are.
//
// Every edge of the first version stays: k == primary -> 0, the sentinel
// skip k > primary, the clamp to the last base and the last block, and the
// cut at seq_len + 1 steps (a walk visits a row at most once, so only a
// corrupt table reaches it; the lookup slot is clamped for the same
// reason).  add + sampled wraps mod 2^32 (sampled[0] is 0xFFFFFFFF).
//
// `ibwa_lf_walk` is the first version (PR 2): one thread a row, (add, kfin)
// out as int64, dispatched by the caller in slices of fixed size, lookup on
// the host.  No path runs it; it stays so that the two can be timed on the
// same rows in one process.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_row.cuh"

namespace {

using namespace ibwa_fm;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One LF step from row k (k != prim) on the strand whose rows start at
// `rows`.
template <int WPB>
__device__ __forceinline__ uint32_t lf_step(const uint32_t* __restrict__ rows,
                                            uint32_t k, uint32_t prim,
                                            const uint32_t (&l2)[4],
                                            uint32_t last, uint32_t n_blk,
                                            int shift) {
  constexpr int ROWW = 4 + WPB;
  uint32_t ka = k - (k > prim ? 1u : 0u);
  ka = min(ka, last);
  const uint32_t blk = min(ka >> shift, n_blk - 1u);
  const uint32_t off = ka & ((1u << shift) - 1u);
  uint32_t r[ROWW];
  load_row<ROWW>(rows + (uint64_t)blk * ROWW, r);
  // the code at the row: word off / 16, 2-bit field off % 16 from the top
  const uint32_t nw = off >> 4;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < WPB; ++j)
    if ((uint32_t)j == nw) word = r[4 + j];
  const uint32_t c = (word >> (((~off) & 0xFu) << 1)) & 3u;
  return pick4(l2, c) + count_base<WPB>(r, c, off);
}

template <int WPB>
__global__ void lf_walk_kernel(const uint32_t* __restrict__ blocks,
                               const int64_t* __restrict__ primary,
                               const int64_t* __restrict__ L2,
                               const int64_t* __restrict__ strand,
                               const int64_t* __restrict__ k0,
                               int64_t* __restrict__ add_out,
                               int64_t* __restrict__ kfin_out, int64_t n,
                               uint32_t seq_len, uint32_t n_blk, int shift,
                               uint32_t mask) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = (uint32_t)strand[i];
  const uint32_t prim = (uint32_t)primary[s];
  const uint32_t l2[4] = {(uint32_t)L2[0], (uint32_t)L2[1], (uint32_t)L2[2],
                          (uint32_t)L2[3]};
  const uint32_t* __restrict__ rows = blocks + (uint64_t)s * n_blk * (4 + WPB);
  const uint32_t last = seq_len > 0 ? seq_len - 1u : 0u;
  uint32_t k = (uint32_t)k0[i];
  uint32_t add = 0;
  while ((k & mask) != 0 && add <= seq_len) {
    k = k == prim ? 0u : lf_step<WPB>(rows, k, prim, l2, last, n_blk, shift);
    ++add;
  }
  add_out[i] = (int64_t)add;
  kfin_out[i] = (int64_t)k;
}

struct ResolveArgs {
  const uint32_t* blocks;
  const int64_t* primary;   // [2]
  const int64_t* L2;        // [5]
  const uint32_t* sampled;  // [2 * n_samp], strand 0 first
  const uint32_t* ss;       // [n_iv] device strand of each interval
  const uint32_t* ks;       // [n_iv] first row of each interval
  const int64_t* off;       // [n_iv + 1]
  uint32_t* out;            // [row_end - row_begin]
  unsigned long long* stats;  // [3]: queue, steps, longest walk
  int64_t n_iv, row_begin;
  uint32_t n_rows;          // row_end - row_begin
  uint32_t seq_len, n_blk, n_samp, mask;
  int shift, sa_shift;
};

template <int WPB>
__global__ void __launch_bounds__(kThreads)
    lf_resolve_kernel(const ResolveArgs a) {
  const int lane = threadIdx.x & 31;
  const uint32_t prim[2] = {(uint32_t)a.primary[0], (uint32_t)a.primary[1]};
  const uint32_t l2[4] = {(uint32_t)a.L2[0], (uint32_t)a.L2[1],
                          (uint32_t)a.L2[2], (uint32_t)a.L2[3]};
  const uint32_t last = a.seq_len > 0 ? a.seq_len - 1u : 0u;
  const uint64_t strand_words = (uint64_t)a.n_blk * (4 + WPB);

  // the lane's walk
  bool act = false;
  uint32_t r = 0, k = 0, s = 0, add = 0;
  // the warp's pending rows: entries pp .. pn - 1, entry j held by lane j
  uint32_t pr = 0, pk = 0, ps = 0;
  int pp = 0, pn = 0;
  unsigned long long steps = 0;
  uint32_t longest = 0;

  // the lookup and the store at the end of the lane's walk
  auto finish = [&]() {
    const uint32_t slot = min(k >> a.sa_shift, a.n_samp - 1u);
    a.out[r] = add + __ldg(a.sampled + (uint64_t)s * a.n_samp + slot);
    steps += add;
    longest = max(longest, add);
    act = false;
  };
  auto walking = [&]() { return (k & a.mask) != 0 && add <= a.seq_len; };

  for (;;) {
    const unsigned idle = __ballot_sync(kFull, !act);
    if (idle) {
      if (pp == pn) {  // the next 32 rows of the queue, or none left
        unsigned long long b = 0;
        if (lane == 0) b = atomicAdd(&a.stats[0], 32ull);
        b = __shfl_sync(kFull, b, 0);
        if (b >= a.n_rows) break;
        const uint32_t base = (uint32_t)b;
        pn = (int)min(32u, a.n_rows - base);
        pp = 0;
        // the interval of the batch's first row: off[lo] <= g < off[hi]
        const int64_t g = a.row_begin + base;
        int64_t lo = 0, hi = a.n_iv;
        while (hi - lo > 1) {
          const int64_t step = (hi - lo + 31) >> 5;
          const int64_t idx = lo + lane * step;
          const bool ok = idx < hi && a.off[idx] <= g;
          const int j = 31 - __clz((int)__ballot_sync(kFull, ok));
          const int64_t top = lo + (j + 1) * step;
          hi = top < hi ? top : hi;
          lo += j * step;
        }
        // the intervals that start inside the batch's 32 rows
        const int64_t nxt = lo + 1 + lane;
        const int64_t at = nxt <= a.n_iv ? a.off[nxt] - g : 32;
        const unsigned starts =
            __reduce_or_sync(kFull, at > 0 && at < 32 ? 1u << at : 0u);
        const int64_t own = lo + __popc(starts & (kFull >> (31 - lane)));
        pr = base + (uint32_t)lane;
        if (lane < pn) {
          pk = __ldg(a.ks + own) + (uint32_t)(g + lane - a.off[own]);
          ps = __ldg(a.ss + own);
        }
      }
      // idle lanes take pending rows in lane order
      const int src = pp + __popc(idle & ((1u << lane) - 1u));
      const uint32_t nr = __shfl_sync(kFull, pr, src & 31);
      const uint32_t nk = __shfl_sync(kFull, pk, src & 31);
      const uint32_t ns = __shfl_sync(kFull, ps, src & 31);
      if (!act && src < pn) {
        act = true;
        r = nr;
        k = nk;
        s = ns;
        add = 0;
      }
      pp = min(pn, pp + __popc(idle));
    }
    if (act) {
      if (walking()) {
        const uint32_t p = s ? prim[1] : prim[0];
        k = k == p ? 0u
                   : lf_step<WPB>(a.blocks + s * strand_words, k, p, l2, last,
                                  a.n_blk, a.shift);
        ++add;
      }
      if (!walking()) finish();
    }
  }
  // the queue is dry: each lane ends its own walk alone, as the first
  // version's threads do, with no warp vote a step
  if (act) {
    const uint32_t p = s ? prim[1] : prim[0];
    const uint32_t* rows = a.blocks + s * strand_words;
    while (walking()) {
      k = k == p ? 0u
                 : lf_step<WPB>(rows, k, p, l2, last, a.n_blk, a.shift);
      ++add;
    }
    finish();
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    steps += __shfl_xor_sync(kFull, steps, d);
    longest = max(longest, __shfl_xor_sync(kFull, longest, d));
  }
  if (lane == 0) {
    atomicAdd(&a.stats[1], steps);
    atomicMax(&a.stats[2], (unsigned long long)longest);
  }
}

template <int WPB>
int launch_resolve(const ResolveArgs& a, int max_blocks, cudaStream_t st) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lf_resolve_kernel<WPB>, kThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int64_t grid = (int64_t)per_sm * sms;
  // no more warps than the wave has batches of 32 rows
  const int64_t need = ((int64_t)a.n_rows + kThreads - 1) / kThreads;
  if (grid > need) grid = need;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  lf_resolve_kernel<WPB><<<(int)grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ibwa_lf_walk(const void* blocks, const void* primary,
                            const void* L2, const void* strand,
                            const void* k0, void* add, void* kfin, int64_t n,
                            int64_t seq_len, int64_t n_blk, int intv,
                            int64_t intv_mask, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t grid = (n + threads - 1) / threads;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* bl = static_cast<const uint32_t*>(blocks);
  const int64_t* pr = static_cast<const int64_t*>(primary);
  const int64_t* l2 = static_cast<const int64_t*>(L2);
  const int64_t* sp = static_cast<const int64_t*>(strand);
  const int64_t* kp = static_cast<const int64_t*>(k0);
  int64_t* ap = static_cast<int64_t*>(add);
  int64_t* fp = static_cast<int64_t*>(kfin);
  const uint32_t sl = (uint32_t)seq_len, nb = (uint32_t)n_blk;
  const uint32_t mask = (uint32_t)intv_mask;
  switch (intv) {
    case 32:
      lf_walk_kernel<2><<<(int)grid, threads, 0, st>>>(bl, pr, l2, sp, kp, ap,
                                                       fp, n, sl, nb, 5, mask);
      break;
    case 64:
      lf_walk_kernel<4><<<(int)grid, threads, 0, st>>>(bl, pr, l2, sp, kp, ap,
                                                       fp, n, sl, nb, 6, mask);
      break;
    case 128:
      lf_walk_kernel<8><<<(int)grid, threads, 0, st>>>(bl, pr, l2, sp, kp, ap,
                                                       fp, n, sl, nb, 7, mask);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// blocks, primary, L2: the walker's table; sampled u32[2 * n_samp]; ss, ks
// u32[n_iv], off int64[n_iv + 1] (intervals non-empty); rows [row_begin,
// row_end) of the row space, fewer than 2^31; out u32[row_end - row_begin];
// stats u64[3], zeroed by the caller; sa_intv_mask = sa_intv - 1 (a power of
// two less one); max_blocks > 0 caps the grid below the card's resident
// blocks (the tests' small grids), 0 leaves it to the card.
extern "C" int ibwa_lf_resolve(const void* blocks, const void* primary,
                               const void* L2, const void* sampled,
                               int64_t n_samp, const void* ss, const void* ks,
                               const void* off, int64_t n_iv,
                               int64_t row_begin, int64_t row_end, void* out,
                               void* stats, int64_t seq_len, int64_t n_blk,
                               int intv, int64_t sa_intv_mask, int max_blocks,
                               void* stream) {
  const int64_t n = row_end - row_begin;
  if (n <= 0) return 0;
  if (n >= (int64_t)1 << 31 || n_iv <= 0 || n_samp <= 0 ||
      (sa_intv_mask & (sa_intv_mask + 1)))
    return (int)cudaErrorInvalidValue;
  ResolveArgs a;
  a.blocks = static_cast<const uint32_t*>(blocks);
  a.primary = static_cast<const int64_t*>(primary);
  a.L2 = static_cast<const int64_t*>(L2);
  a.sampled = static_cast<const uint32_t*>(sampled);
  a.ss = static_cast<const uint32_t*>(ss);
  a.ks = static_cast<const uint32_t*>(ks);
  a.off = static_cast<const int64_t*>(off);
  a.out = static_cast<uint32_t*>(out);
  a.stats = static_cast<unsigned long long*>(stats);
  a.n_iv = n_iv;
  a.row_begin = row_begin;
  a.n_rows = (uint32_t)n;
  a.seq_len = (uint32_t)seq_len;
  a.n_blk = (uint32_t)n_blk;
  a.n_samp = (uint32_t)n_samp;
  a.mask = (uint32_t)sa_intv_mask;
  a.sa_shift = __builtin_popcountll((unsigned long long)sa_intv_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (intv) {
    case 32:
      a.shift = 5;
      return launch_resolve<2>(a, max_blocks, st);
    case 64:
      a.shift = 6;
      return launch_resolve<4>(a, max_blocks, st);
    case 128:
      a.shift = 7;
      return launch_resolve<8>(a, max_blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
