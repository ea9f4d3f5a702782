// Row load and masked 2-bit popcount over one row of the device FM block
// table, shared by the occ queries (occ.cu) and the LF walker (lf_walk.cu).
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

}  // namespace ibwa_fm

#endif  // IBWA_FM_ROW_CUH
