// Copy of ibwa_tpu/native/src/lf_step.h: the port keeps its own host code.
//
// Shared LF-mapping step over the interleaved occ layout (12 uint32 words
// per 128-base block: 4 checkpoint counts + 8 packed 2-bit words).
//
// Semantics mirror the reference's bwt_invPsi (bwt.h:66-70): one
// backward step k -> C[bwt[k]] + Occ(bwt[k], k) on a sentinel-removed
// BWT.  This fused version computes the code and its occ count with a
// single block-pointer computation, and when the in-block offset falls
// in the upper half it counts BACKWARD from the next block's checkpoint
// (adjacent in the interleaved layout), so the popcount scan never
// covers more than half a block.  Byte-for-byte equal to the separate
// code_at + occ pair for every k in [0, seq_len] except the never-
// occurring k == 0xFFFFFFFF (callers step valid SA row indices only).
#ifndef IBWA_LF_STEP_H
#define IBWA_LF_STEP_H

#include <cstdint>

namespace ibwa_lf {

static inline uint32_t cnt_prefix64(uint64_t dw, int c, int nbases) {
  uint64_t t = dw ^ (0x5555555555555555ULL * (uint64_t)c);
  t = ~t;
  t &= t >> 1;
  t &= 0x5555555555555555ULL;
  if (nbases < 32) t &= ~((1ULL << ((32 - nbases) * 2)) - 1ULL);
  return (uint32_t)__builtin_popcountll(t);
}

static inline uint32_t cnt_suffix64(uint64_t dw, int c, int nbases) {
  uint64_t t = dw ^ (0x5555555555555555ULL * (uint64_t)c);
  t = ~t;
  t &= t >> 1;
  t &= 0x5555555555555555ULL;
  if (nbases < 32) t &= (1ULL << (nbases * 2)) - 1ULL;
  return (uint32_t)__builtin_popcountll(t);
}

// One LF step; data/primary/l2/seq_len describe one strand's index.
static inline uint32_t lf_step(const uint32_t* data, uint32_t primary,
                               const uint32_t* l2, uint32_t seq_len,
                               uint32_t k) {
  if (k == primary) return 0;
  uint32_t ka = (k > primary) ? k - 1 : k;
  const uint32_t* blk = data + (ka / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t off = ka % 128;
  int c = (int)((w[off / 16] >> (((~off) & 0xF) << 1)) & 3u);
  uint32_t nb = off + 1;  // prefix length to count
  uint32_t n;
  uint32_t nxt_base = (ka / 128) * 128 + 128;
  if (nb > 64 && nxt_base < seq_len) {
    n = blk[12 + c];        // next block's checkpoint
    uint32_t ns = 128 - nb;  // suffix length to subtract
    uint32_t j = 7;
    while (ns >= 32) {
      n -= cnt_suffix64(((uint64_t)w[j - 1] << 32) | w[j], c, 32);
      j -= 2;
      ns -= 32;
    }
    if (ns) n -= cnt_suffix64(((uint64_t)w[j - 1] << 32) | w[j], c, (int)ns);
  } else {
    n = blk[c];
    uint32_t j = 0;
    while (nb >= 32) {
      n += cnt_prefix64(((uint64_t)w[j] << 32) | w[j + 1], c, 32);
      j += 2;
      nb -= 32;
    }
    if (nb) n += cnt_prefix64(((uint64_t)w[j] << 32) | w[j + 1], c, (int)nb);
  }
  return l2[c] + n;
}

}  // namespace ibwa_lf

#endif  // IBWA_LF_STEP_H
