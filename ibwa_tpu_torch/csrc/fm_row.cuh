// Row load and masked 2-bit popcount over one row of the device FM block
// table, shared by the occ queries (occ.cu), the LF walker (lf_walk.cu) and
// the search step (search_step.cu); and the occ query itself (locate the
// row of a bound, fetch it, count a base with the sentinel / clamp / NEG1 /
// seq_len edges of bwt_occ), shared by occ.cu and search_step.cu.
//
// A row is uint32[4 + WPB]: 4 occ checkpoint words, then the 2-bit packed
// BWT text of the intv = 16 * WPB bases after the checkpoint.
#ifndef IBWA_FM_ROW_CUH
#define IBWA_FM_ROW_CUH

#include <cstdint>
#include <cuda_runtime.h>

namespace ibwa_fm {

// 16-byte vector loads; 8-byte at intv 32, whose 24 B rows are only
// 8-byte aligned.  Through the read-only path.
template <int ROWW>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p,
                                         uint32_t (&r)[ROWW]) {
  if constexpr (ROWW % 4 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < ROWW / 4; ++i) {
      uint4 v = __ldg(q + i);
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < ROWW / 2; ++i) {
      uint2 v = __ldg(q + i);
      r[2 * i] = v.x;
      r[2 * i + 1] = v.y;
    }
  }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t* v, uint32_t c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : c == 3 ? v[3] : 0u;
}

// Count of base c in the row's text words before-and-including `off`,
// plus the row's checkpoint for c.
template <int WPB>
__device__ __forceinline__ uint32_t count_base(const uint32_t (&r)[4 + WPB],
                                               uint32_t c, uint32_t off) {
  const uint32_t nw = off >> 4;              // fully counted words
  const uint32_t nb = (off & 15u) + 1u;      // bases counted in word nw
  const uint32_t pm = ~((1u << ((16u - nb) * 2u)) - 1u);
  const uint32_t pat = 0x55555555u * c;
  uint32_t cnt = pick4(r, c);
#pragma unroll
  for (int j = 0; j < WPB; ++j) {
    const uint32_t x = ~(r[4 + j] ^ pat);
    const uint32_t t = x & (x >> 1) & 0x55555555u;
    if ((uint32_t)j < nw)
      cnt += __popc(t);
    else if ((uint32_t)j == nw)
      cnt += __popc(t & pm);
  }
  return cnt;
}

constexpr uint32_t kNeg1 = 0xFFFFFFFFu;

// The row that answers occ(k) on one strand, and how to read it.
template <int WPB>
struct OccRow {
  uint32_t r[4 + WPB];
  uint32_t off;  // k's offset inside the row's block
  bool neg;      // k == (bwtint_t)(-1): every count is 0
  bool full;     // k == seq_len: every count is L2[c + 1] - L2[c]
};

// Locate and fetch the row of bound k on `strand` (rows of strand 1 follow
// the n_blk rows of strand 0): skip the sentinel row at `prim`, clamp to the
// last base and the last block.  The load starts here and is not waited for,
// so a caller that fetches the two bounds of an interval before it counts
// either has both loads in flight.
template <int WPB>
__device__ __forceinline__ void fetch_occ_row(
    const uint32_t* __restrict__ blocks, uint32_t k, uint32_t prim,
    uint32_t seq_len, uint32_t n_blk, uint32_t strand, OccRow<WPB>& o) {
  constexpr int shift = WPB == 2 ? 5 : WPB == 4 ? 6 : 7;  // log2(intv)
  uint32_t kk = k - (k >= prim ? 1u : 0u);
  kk = min(kk, seq_len > 0 ? seq_len - 1u : 0u);
  const uint32_t blk = min(kk >> shift, n_blk - 1u);
  o.off = kk & ((1u << shift) - 1u);
  o.neg = k == kNeg1;
  o.full = k == seq_len;
  load_row<4 + WPB>(blocks + ((uint64_t)strand * n_blk + blk) * (4 + WPB),
                    o.r);
}

// occ(k, c) from k's fetched row; l2d[c] = L2[c + 1] - L2[c].  c >= 4 (no
// base) counts 0 at k == seq_len.
template <int WPB>
__device__ __forceinline__ uint32_t occ_count(const OccRow<WPB>& o,
                                              uint32_t c,
                                              const uint32_t (&l2d)[4]) {
  uint32_t v = count_base<WPB>(o.r, c, o.off);
  if (o.neg) v = 0;
  if (o.full) v = pick4(l2d, c);
  return v;
}

// occ(k, c) for all four bases c from k's fetched row, in one pass over its
// text words: three popcounts a word (low bits, high bits, both set) instead
// of one per base, the fourth count from the number of positions.  The same
// values as four occ_count calls.
template <int WPB>
__device__ __forceinline__ void occ_count4(const OccRow<WPB>& o,
                                           const uint32_t (&l2d)[4],
                                           uint32_t (&cnt)[4]) {
  const uint32_t nw = o.off >> 4;          // fully counted words
  const uint32_t nb = (o.off & 15u) + 1u;  // bases counted in word nw
  const uint32_t pm = ~((1u << ((16u - nb) * 2u)) - 1u) & 0x55555555u;
  uint32_t n_lo = 0, n_hi = 0, n_both = 0;
#pragma unroll
  for (int j = 0; j < WPB; ++j) {
    const uint32_t m = (uint32_t)j < nw    ? 0x55555555u
                       : (uint32_t)j == nw ? pm
                                           : 0u;
    const uint32_t lo = o.r[4 + j] & m, hi = (o.r[4 + j] >> 1) & m;
    n_lo += __popc(lo);
    n_hi += __popc(hi);
    n_both += __popc(lo & hi);
  }
  cnt[0] = o.r[0] + (o.off + 1u) - n_lo - n_hi + n_both;
  cnt[1] = o.r[1] + n_lo - n_both;
  cnt[2] = o.r[2] + n_hi - n_both;
  cnt[3] = o.r[3] + n_both;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (o.neg) cnt[c] = 0;
    if (o.full) cnt[c] = l2d[c];
  }
}

}  // namespace ibwa_fm

#endif  // IBWA_FM_ROW_CUH
