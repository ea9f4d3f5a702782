// K2: paired occ4 / occ1 queries (bwt_occ4 / bwt_occ, bwt.c:90-214) over
// the device FM block table.
//
// Replaces: ibwa_tpu/fm/device.py::occ4 and ::occ1 (with _gather_block and
// _partial_mask), the XLA row gather + masked 2-bit popcount that every
// width step and every search step of the aln engine runs.
//
// Layout: blocks is uint32[2 * n_blk, 4 + intv/16] (fwd strand rows, then
// rev strand rows): 4 occ checkpoint words, then the 2-bit packed BWT text
// of the intv bases after the checkpoint.  One query is one row.
//
// Bound on an H100: dependent row fetches.  A thread issues one 24/32/48 B
// row load whose address depends on the query, then does ~10 integer ops
// per word; the arithmetic is negligible and the time is the latency of
// scattered loads.  At intv 64 a row is 32 B per 64 bases, 1 B/base for
// both strands; a randomly read table above ~8-16 MB is met in HBM, not in
// the L2 (the chase probe), so every query is an HBM round trip already on
// a chr20-scale genome.
//
// Design: one thread per (query, bound).  The two bounds of one SA interval
// (k-1 and l, the pair every caller asks for) sit in neighbouring threads,
// so a warp covers 16 intervals with 32 independent loads in flight.  The
// query itself (sentinel adjust, clamp, the NEG1 / seq_len edges, 16-byte
// vector row loads, __popc over the masked match words) is the __device__
// code of fm_row.cuh, which the search step (search_step.cu, whose stage 3
// is this kernel's work inside a lane's step) calls too.  Many warps per SM
// keep enough loads in flight to hide the latency.  On the aln path these
// entries serve the width pass; the step's occ queries run inside
// search_step.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_row.cuh"

namespace {

using namespace ibwa_fm;

// One thread per (query q, bound b): b = 0 asks occ at k[q] - 1 (u32 wrap,
// so k == 0 gives NEG1), b = 1 at l[q].  C4 = true writes all four counts
// (occ4), else only base c[q] (occ1).
template <int WPB, bool C4>
__global__ void occ_pair_kernel(const uint32_t* __restrict__ blocks,
                                const int64_t* __restrict__ primary,
                                const int64_t* __restrict__ l2diff,
                                const int64_t* __restrict__ strand,
                                const int64_t* __restrict__ kq,
                                const int64_t* __restrict__ lq,
                                const int64_t* __restrict__ cq,
                                int64_t* __restrict__ out, int m,
                                uint32_t seq_len, uint32_t n_blk) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * (int64_t)m) return;
  const int64_t q = t >> 1;
  const int b = (int)(t & 1);
  const uint32_t k = b ? (uint32_t)lq[q] : (uint32_t)kq[q] - 1u;
  const uint32_t s = (uint32_t)strand[q];
  OccRow<WPB> row;
  fetch_occ_row<WPB>(blocks, k, (uint32_t)primary[s], seq_len, n_blk, s, row);
  const uint32_t l2d[4] = {(uint32_t)l2diff[0], (uint32_t)l2diff[1],
                           (uint32_t)l2diff[2], (uint32_t)l2diff[3]};
  if (C4) {
#pragma unroll
    for (uint32_t c = 0; c < 4; ++c)
      out[t * 4 + c] = (int64_t)occ_count<WPB>(row, c, l2d);
  } else {
    out[t] = (int64_t)occ_count<WPB>(row, (uint32_t)cq[q], l2d);
  }
}

template <bool C4>
int launch(const void* blocks, const void* primary, const void* l2diff,
           const void* strand, const void* k, const void* l, const void* c,
           void* out, int m, int64_t seq_len, int64_t n_blk, int intv,
           void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  const int grid = (int)((2 * (int64_t)m + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* bl = static_cast<const uint32_t*>(blocks);
  const int64_t* pr = static_cast<const int64_t*>(primary);
  const int64_t* ld = static_cast<const int64_t*>(l2diff);
  const int64_t* sp = static_cast<const int64_t*>(strand);
  const int64_t* kp = static_cast<const int64_t*>(k);
  const int64_t* lp = static_cast<const int64_t*>(l);
  const int64_t* cp = static_cast<const int64_t*>(c);
  int64_t* op = static_cast<int64_t*>(out);
  const uint32_t sl = (uint32_t)seq_len, nb = (uint32_t)n_blk;
  switch (intv) {
    case 32:
      occ_pair_kernel<2, C4><<<grid, threads, 0, st>>>(
          bl, pr, ld, sp, kp, lp, cp, op, m, sl, nb);
      break;
    case 64:
      occ_pair_kernel<4, C4><<<grid, threads, 0, st>>>(
          bl, pr, ld, sp, kp, lp, cp, op, m, sl, nb);
      break;
    case 128:
      occ_pair_kernel<8, C4><<<grid, threads, 0, st>>>(
          bl, pr, ld, sp, kp, lp, cp, op, m, sl, nb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ibwa_occ4_pair(const void* blocks, const void* primary,
                              const void* l2diff, const void* strand,
                              const void* k, const void* l, void* out, int m,
                              int64_t seq_len, int64_t n_blk, int intv,
                              void* stream) {
  return launch<true>(blocks, primary, l2diff, strand, k, l, nullptr, out, m,
                      seq_len, n_blk, intv, stream);
}

extern "C" int ibwa_occ1_pair(const void* blocks, const void* primary,
                              const void* l2diff, const void* strand,
                              const void* k, const void* l, const void* c,
                              void* out, int m, int64_t seq_len,
                              int64_t n_blk, int intv, void* stream) {
  return launch<false>(blocks, primary, l2diff, strand, k, l, c, out, m,
                       seq_len, n_blk, intv, stream);
}
