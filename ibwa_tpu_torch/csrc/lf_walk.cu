// K5 `lf_walk`: LF walks from SA rows to the nearest sampled row.
//
// Replaces: ibwa_tpu/fm/walk.py::_lf_walk with ::_lf_step, the XLA
// while_loop that resolves SA rows for the SAM stages (reference bwt_sa,
// bwt.c:61-79): `while (k & (sa_intv - 1)) { k = LF(k); ++add; }`, and the
// caller finishes with `add + sampled_sa[k / sa_intv]` on the host.
//
// One LF step is one row of the device FM block table (see occ.cu for the
// layout): the 2-bit code c at row k and the inclusive count of c up to k
// both come from that row, and k' = L2[c] + count; k == primary gives 0.
// Unlike the occ queries the sentinel skip is `k > primary` (the row AT
// primary is the special case, not skipped over).
//
// Bound on an H100: like K2, the latency of dependent row fetches, here
// in a chain: a lane's next row address is this row's result, so a launch
// takes at least (the longest walk of the batch) x (one row's round trip
// from L2 or HBM); with the 131,072 lanes of a dispatch the byte rate of
// scattered 32 B rows comes into play as well.
//
// Design: one thread per lane keeps k and add in registers and loops until
// its row is sampled; one vector row load per step (fm_row.cuh), __popc for
// the count.  No padding to a fixed lane count: the grid covers n.  Lanes
// of a warp retire at different steps, so a warp runs as long as its
// longest walk with the retired lanes idle; this first version accepts
// that divergence.  A walk visits each row at most once, so it ends within
// seq_len + 1 steps; the loop is cut there so that a corrupt table cannot
// hang the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_row.cuh"

namespace {

using namespace ibwa_fm;

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
  constexpr int ROWW = 4 + WPB;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t s = (uint32_t)strand[i];
  const uint32_t prim = (uint32_t)primary[s];
  const uint32_t l2[4] = {(uint32_t)L2[0], (uint32_t)L2[1], (uint32_t)L2[2],
                          (uint32_t)L2[3]};
  const uint32_t* __restrict__ rows = blocks + (uint64_t)s * n_blk * ROWW;
  const uint32_t last = seq_len > 0 ? seq_len - 1u : 0u;
  uint32_t k = (uint32_t)k0[i];
  uint32_t add = 0;
  while ((k & mask) != 0 && add <= seq_len) {
    if (k == prim) {
      k = 0;
    } else {
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
      k = pick4(l2, c) + count_base<WPB>(r, c, off);
    }
    ++add;
  }
  add_out[i] = (int64_t)add;
  kfin_out[i] = (int64_t)k;
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
