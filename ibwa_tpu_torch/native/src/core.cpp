// Copy of ibwa_tpu/native/src/core.cpp: the port keeps its own host code.
//
// ibwa_tpu native host library.
//
// Host-side heavy lifting that is inherently sequential or
// pointer-chasing and therefore stays off the TPU:
//   * SA-IS suffix-array construction (index build)
//   * BWT derivation + the sampled-SA inverse-Psi walk
//     (semantics of reference bwt.c:48-79, re-implemented)
//   * occ(k, c) queries on the interleaved checkpoint layout
//     (layout contract from reference bwt.h:56-63)
//   * exact rand48 stream generation (libc LCG) for output parity
//
// Everything is exposed with a C ABI and driven from Python via ctypes.

#include <omp.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#include "lf_step.h"

namespace {

// ---------------------------------------------------------------------------
// SA-IS: linear-time suffix array by induced sorting (Nong, Zhang & Chan).
// Original implementation; generic over the text accessor so the recursion
// can reuse the same code for the int32 reduced problem.
// ---------------------------------------------------------------------------

template <typename TextT, typename IdxT>
struct SaisProblem {
  const TextT* text;
  IdxT n;
  IdxT alphabet;
};

template <typename TextT, typename IdxT>
static void compute_buckets(const SaisProblem<TextT, IdxT>& p,
                            std::vector<IdxT>& bkt, bool tails) {
  std::fill(bkt.begin(), bkt.end(), 0);
  for (IdxT i = 0; i < p.n; ++i) bkt[p.text[i]] += 1;
  IdxT sum = 0;
  for (IdxT c = 0; c < p.alphabet; ++c) {
    sum += bkt[c];
    bkt[c] = tails ? sum : sum - bkt[c];
  }
}

// type array: true = S-type suffix, false = L-type
template <typename TextT, typename IdxT>
static void classify(const SaisProblem<TextT, IdxT>& p,
                     std::vector<bool>& stype) {
  stype.assign(p.n + 1, false);
  stype[p.n] = true;  // empty suffix is S by convention
  if (p.n == 0) return;
  stype[p.n - 1] = false;  // last char > empty suffix
  for (IdxT i = p.n - 2; i >= 0; --i) {
    if (p.text[i] < p.text[i + 1])
      stype[i] = true;
    else if (p.text[i] > p.text[i + 1])
      stype[i] = false;
    else
      stype[i] = stype[i + 1];
  }
}

template <typename IdxT>
static inline bool is_lms(const std::vector<bool>& stype, IdxT i) {
  return i > 0 && stype[i] && !stype[i - 1];
}

template <typename TextT, typename IdxT>
static void induce(const SaisProblem<TextT, IdxT>& p, IdxT* sa,
                   const std::vector<bool>& stype, std::vector<IdxT>& bkt) {
  // forward pass: place L-types after their successors
  compute_buckets(p, bkt, /*tails=*/false);
  // virtual sentinel: suffix n-1 precedes the (unstored) empty suffix
  if (p.n > 0 && !stype[p.n - 1]) sa[bkt[p.text[p.n - 1]]++] = p.n - 1;
  for (IdxT i = 0; i < p.n; ++i) {
    IdxT j = sa[i] - 1;
    if (sa[i] > 0 && !stype[j]) sa[bkt[p.text[j]]++] = j;
  }
  // backward pass: place S-types
  compute_buckets(p, bkt, /*tails=*/true);
  for (IdxT i = p.n - 1; i >= 0; --i) {
    IdxT j = sa[i] - 1;
    if (sa[i] > 0 && stype[j]) sa[--bkt[p.text[j]]] = j;
  }
}

template <typename TextT, typename IdxT>
static void sais_core(const TextT* text, IdxT* sa, IdxT n, IdxT alphabet) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  SaisProblem<TextT, IdxT> p{text, n, alphabet};
  std::vector<bool> stype;
  classify(p, stype);
  std::vector<IdxT> bkt(alphabet);

  // step 1: rough sort — drop LMS suffixes at bucket tails, induce
  std::fill(sa, sa + n, (IdxT)-1);
  compute_buckets(p, bkt, /*tails=*/true);
  for (IdxT i = n - 1; i >= 1; --i)
    if (is_lms(stype, i)) sa[--bkt[text[i]]] = i;
  induce(p, sa, stype, bkt);

  // step 2: name LMS substrings in their sorted order
  IdxT n_lms = 0;
  for (IdxT i = 0; i < n; ++i)
    if (is_lms(stype, sa[i])) sa[n_lms++] = sa[i];
  IdxT* lms_sorted = sa;            // first n_lms slots
  IdxT* names = sa + n_lms;         // rest reused as name buffer
  std::fill(names, sa + n, (IdxT)-1);
  IdxT n_names = 0;
  IdxT prev = -1;
  for (IdxT k = 0; k < n_lms; ++k) {
    IdxT cur = lms_sorted[k];
    bool differ = (prev < 0);
    if (!differ) {
      // compare LMS substrings at prev and cur
      for (IdxT d = 0;; ++d) {
        bool end_p = (prev + d == n) || (d > 0 && is_lms(stype, prev + d));
        bool end_c = (cur + d == n) || (d > 0 && is_lms(stype, cur + d));
        if (end_p && end_c) break;
        if (end_p != end_c || text[prev + d] != text[cur + d]) {
          differ = true;
          break;
        }
      }
    }
    if (differ) {
      ++n_names;
      prev = cur;
    }
    names[cur / 2] = n_names - 1;
  }
  // compact names into the reduced string
  std::vector<IdxT> reduced;
  std::vector<IdxT> lms_pos;
  reduced.reserve(n_lms);
  lms_pos.reserve(n_lms);
  for (IdxT i = 1; i < n; ++i)
    if (is_lms(stype, i)) lms_pos.push_back(i);
  for (IdxT i = 0; i < n - n_lms; ++i)
    if (names[i] >= 0) reduced.push_back(names[i]);
  // note: lms_pos is in text order and so is the compacted name sequence

  // step 3: order LMS suffixes
  std::vector<IdxT> lms_order(n_lms);
  if (n_names < n_lms) {
    std::vector<IdxT> sub_sa(n_lms);
    sais_core<IdxT, IdxT>(reduced.data(), sub_sa.data(), n_lms, n_names);
    for (IdxT k = 0; k < n_lms; ++k) lms_order[k] = lms_pos[sub_sa[k]];
  } else {
    for (IdxT k = 0; k < n_lms; ++k) lms_order[reduced[k]] = lms_pos[k];
  }

  // step 4: final induce from exactly-sorted LMS suffixes
  std::fill(sa, sa + n, (IdxT)-1);
  compute_buckets(p, bkt, /*tails=*/true);
  for (IdxT k = n_lms - 1; k >= 0; --k) {
    IdxT j = lms_order[k];
    sa[--bkt[text[j]]] = j;
  }
  induce(p, sa, stype, bkt);
}

// ---------------------------------------------------------------------------
// occ on the interleaved BWT layout (checkpoint every 128 bases, 12 words per
// block: 4 cumulative counts + 8 packed text words, base j of a word in bits
// [2*(15-j), 2*(15-j)+1]).
// ---------------------------------------------------------------------------

static inline uint32_t count_code_prefix(uint32_t word, int code, int nbases) {
  // number of occurrences of `code` among the first `nbases` bases of `word`
  if (nbases <= 0) return 0;
  // replicate the 2-bit code across all 16 lanes, then match via ~xor
  uint32_t pat = (uint32_t)code * 0x55555555u;
  uint32_t z = word ^ pat;
  uint32_t t = ~z;
  t &= t >> 1;
  t &= 0x55555555u;
  if (nbases < 16) t &= ~((1u << ((16 - nbases) * 2)) - 1u);
  return (uint32_t)__builtin_popcount(t);
}

// per-byte packed counts of all four channels (8 bits each) — the
// reference's bwt_gen_cnt_table / __occ_aux4 device (bwt.c:36-45,
// 153-155): one lookup counts 4 bases across all channels at once
static uint32_t kOccTbl[256];
static const bool kOccTblInit = [] {
  for (int b = 0; b < 256; ++b) {
    uint32_t x = 0;
    for (int j = 0; j < 4; ++j) x += 1u << (((b >> (2 * j)) & 3) * 8);
    kOccTbl[b] = x;
  }
  return true;
}();

static inline uint32_t occ_packed4(uint32_t w) {
  return kOccTbl[w & 0xff] + kOccTbl[(w >> 8) & 0xff] +
         kOccTbl[(w >> 16) & 0xff] + kOccTbl[w >> 24];
}

// packed counts of the first nb (1..16) bases of a word; the channel-0
// overcount from the masked-off tail is subtracted exactly as the
// reference does (bwt.c:188, "- (~k&15)")
static inline uint32_t occ_packed4_prefix(uint32_t w, uint32_t nb) {
  if (nb < 16) w &= ~((1u << ((16 - nb) * 2)) - 1u);
  return occ_packed4(w) - (16 - nb);
}

// packed counts of the LAST ns (1..15) bases of a word (zeroed prefix
// fields count as channel 0 and are subtracted)
static inline uint32_t occ_packed4_suffix(uint32_t w, uint32_t ns) {
  w &= (1u << (2 * ns)) - 1u;
  return occ_packed4(w) - (16 - ns);
}

struct InterleavedBwt {
  const uint32_t* data;
  uint32_t primary;
  uint32_t l2[5];
  uint32_t seq_len;
};

// counts code c among the TOP nbases (1..32) 2-bit fields of
// dw = (w_hi << 32) | w_lo (w_hi holds the earlier positions) — the
// reference processes 32 bases per popcount this way (bwt.c __occ_aux)
static inline uint32_t count_code_prefix64(uint64_t dw, int c, int nbases) {
  uint64_t t = dw ^ (0x5555555555555555ULL * (uint64_t)c);
  t = ~t;
  t &= t >> 1;
  t &= 0x5555555555555555ULL;
  if (nbases < 32) t &= ~((1ULL << ((32 - nbases) * 2)) - 1ULL);
  return (uint32_t)__builtin_popcountll(t);
}

// single-channel in-block scan: top `nb` (1..128) bases of the 8-word row
static inline uint32_t occ1_scan(const uint32_t* w, int c, uint32_t nb) {
  uint32_t n = 0, j = 0;
  while (nb >= 32) {
    n += count_code_prefix64(((uint64_t)w[j] << 32) | w[j + 1], c, 32);
    j += 2;
    nb -= 32;
  }
  if (nb > 16)
    n += count_code_prefix64(((uint64_t)w[j] << 32) | w[j + 1], c, (int)nb);
  else if (nb)
    n += count_code_prefix(w[j], c, (int)nb);
  return n;
}

// single-channel in-block scan of the LAST `ns` (1..127) bases — for
// backward counts from the next block's checkpoint
static inline uint32_t occ1_scan_suffix(const uint32_t* w, int c,
                                        uint32_t ns) {
  uint32_t n = 0, j = 7;
  while (ns >= 32) {
    n += ibwa_lf::cnt_suffix64(((uint64_t)w[j - 1] << 32) | w[j], c, 32);
    j -= 2;
    ns -= 32;
  }
  if (ns)
    n += ibwa_lf::cnt_suffix64(((uint64_t)w[j - 1] << 32) | w[j], c, (int)ns);
  return n;
}

static uint32_t occ1(const InterleavedBwt& b, uint32_t k, int c) {
  // #\{i <= k : B0[i] == c\}; k == 0xFFFFFFFF means "before the start"
  if (k == 0xFFFFFFFFu) return 0;
  if (k == b.seq_len) return b.l2[c + 1] - b.l2[c];
  if (k >= b.primary) --k;  // the sentinel is not stored
  const uint32_t* blk = b.data + (k / 128) * 12;
  uint32_t nb = (k % 128) + 1;
  if (nb > 64 && (k / 128) * 128 + 128 < b.seq_len)
    // upper half: count backward from the next block's checkpoint
    return blk[12 + c] - occ1_scan_suffix(blk + 4, c, 128 - nb);
  return blk[c] + occ1_scan(blk + 4, c, nb);
}

// paired occ1 at (k, l) sharing the block scan when both land in one
// 128-base block — the reference's bwt_2occ (bwt.c:116-137)
static inline void occ1_pair(const InterleavedBwt& b, uint32_t k, uint32_t l,
                             int c, uint32_t* ok, uint32_t* ol) {
  uint32_t k2 = k, l2 = l;
  if (k2 != 0xFFFFFFFFu && k2 != b.seq_len && k2 >= b.primary) --k2;
  if (l2 != 0xFFFFFFFFu && l2 != b.seq_len && l2 >= b.primary) --l2;
  if (k == 0xFFFFFFFFu || k == b.seq_len || l == 0xFFFFFFFFu ||
      l == b.seq_len || (k2 >> 7) != (l2 >> 7)) {
    *ok = occ1(b, k, c);
    *ol = occ1(b, l, c);
    return;
  }
  const uint32_t* blk = b.data + (k2 / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t nbk = (k2 % 128) + 1, nbl = (l2 % 128) + 1;
  if (nbk > 64 && (k2 / 128) * 128 + 128 < b.seq_len) {
    // both offsets in the upper half (l >= k): backward scans
    *ok = blk[12 + c] - occ1_scan_suffix(w, c, 128 - nbk);
    *ol = blk[12 + c] - occ1_scan_suffix(w, c, 128 - nbl);
    return;
  }
  // one row fetch, two 64-bit-chunk scans (the row stays in L1)
  *ok = blk[c] + occ1_scan(w, c, nbk);
  *ol = blk[c] + occ1_scan(w, c, nbl);
}

static inline int bwt_code_at(const InterleavedBwt& b, uint32_t k) {
  const uint32_t* blk = b.data + (k / 128) * 12 + 4;
  uint32_t word = blk[(k % 128) / 16];
  return (int)((word >> (((~k) & 0xF) << 1)) & 3u);
}

static inline uint32_t inv_psi(const InterleavedBwt& b, uint32_t k) {
  // LF-mapping step; mirrors the macro contract at reference bwt.h:66-70
  return ibwa_lf::lf_step(b.data, b.primary, b.l2, b.seq_len, k);
}

// ---------------------------------------------------------------------------
// rand48
// ---------------------------------------------------------------------------

static const uint64_t R48_A = 0x5DEECE66DULL;
static const uint64_t R48_C = 0xBULL;
static const uint64_t R48_MASK = (1ULL << 48) - 1;

}  // namespace

extern "C" {

// Suffix array of text[0..n-1] (values 0..alphabet-1). Returns 0 on success.
int32_t ibwa_sais(const uint8_t* text, int32_t* sa, int32_t n, int32_t alphabet) {
  if (!text || !sa || n < 0) return -1;
  sais_core<uint8_t, int32_t>(text, sa, n, alphabet);
  return 0;
}

// In-place BWT of text[0..n-1]; output is the sentinel-removed BWT string
// (length n) and the return value is the sentinel row index ("primary").
int32_t ibwa_bwt_inplace(uint8_t* text, int32_t n) {
  if (n <= 0) return n == 0 ? 0 : -1;
  std::vector<int32_t> sa(n);
  sais_core<uint8_t, int32_t>(text, sa.data(), n, 4);
  // full SA order: [empty suffix] + sa; BWT[i] = text[SA_full[i] - 1]
  std::vector<uint8_t> bwt(n);
  int32_t primary = 0;
  bwt[0] = text[n - 1];
  int32_t out = 1;
  for (int32_t i = 0; i < n; ++i) {
    if (sa[i] == 0) {
      primary = i + 1;  // row of the sentinel in the full matrix
      continue;
    }
    bwt[out++] = text[sa[i] - 1];
  }
  std::memcpy(text, bwt.data(), n);
  return primary;
}

// BWT (in place) + the sampled .sa in one SA-IS pass.  The reference
// derives .sa by walking isa over the whole genome (bwt_cal_sa,
// bwt.c:58-67) because it never holds a full suffix array; we do, so
// sample it directly: full-matrix row k has SA_full[0] = n (sentinel)
// and SA_full[k] = sa[k-1], and the file stores sa0[k/intv] = SA_full[k]
// for k % intv == 0 with sa0[0] = (bwtint_t)-1 (bwt.c:66 quirk).
// Byte-identical to the walk by construction.
int32_t ibwa_bwt_sa_inplace(uint8_t* text, int32_t n, uint32_t intv,
                            uint32_t* out_sa, uint32_t n_sa) {
  if (n <= 0 || intv == 0) return -1;
  std::vector<int32_t> sa(n);
  sais_core<uint8_t, int32_t>(text, sa.data(), n, 4);
  for (uint32_t i = 0; i < n_sa; ++i) out_sa[i] = 0;
  for (int64_t k = intv; k <= (int64_t)n; k += intv)
    out_sa[k / intv] = (uint32_t)sa[k - 1];
  out_sa[0] = 0xFFFFFFFFu;
  std::vector<uint8_t> bwt(n);
  int32_t primary = 0;
  bwt[0] = text[n - 1];
  int32_t out = 1;
  for (int32_t i = 0; i < n; ++i) {
    if (sa[i] == 0) {
      primary = i + 1;
      continue;
    }
    bwt[out++] = text[sa[i] - 1];
  }
  std::memcpy(text, bwt.data(), n);
  return primary;
}

// 64-bit in-place BWT for genomes whose suffix positions exceed int32
// (the reference reaches these sizes via `index -a bwtsw`; the BWT is
// unique so outputs agree byte-for-byte).
int64_t ibwa_bwt_inplace64(uint8_t* text, int64_t n) {
  if (n <= 0) return n == 0 ? 0 : -1;
  std::vector<int64_t> sa(n);
  sais_core<uint8_t, int64_t>(text, sa.data(), n, 4);
  std::vector<uint8_t> bwt(n);
  int64_t primary = 0;
  bwt[0] = text[n - 1];
  int64_t out = 1;
  for (int64_t i = 0; i < n; ++i) {
    if (sa[i] == 0) {
      primary = i + 1;
      continue;
    }
    bwt[out++] = text[sa[i] - 1];
  }
  std::memcpy(text, bwt.data(), n);
  return primary;
}

// Sampled suffix array from the interleaved bwt, matching reference
// bwt.c:48-67: walk isa via invPsi for seq_len steps, record every intv-th.
void ibwa_cal_sa(const uint32_t* interleaved, uint32_t primary,
                 const uint32_t* l2, uint32_t seq_len, uint32_t intv,
                 uint32_t* out_sa, uint32_t n_sa) {
  InterleavedBwt b{interleaved, primary, {l2[0], l2[1], l2[2], l2[3], l2[4]},
                   seq_len};
  for (uint32_t i = 0; i < n_sa; ++i) out_sa[i] = 0;
  uint32_t isa = 0, sa = seq_len;
  for (uint32_t i = 0; i < seq_len; ++i) {
    if (isa % intv == 0) out_sa[isa / intv] = sa;
    --sa;
    isa = inv_psi(b, isa);
  }
  if (isa % intv == 0) out_sa[isa / intv] = sa;
  out_sa[0] = 0xFFFFFFFFu;  // sentinel, reference bwt.c:66
}

// Batched SA lookup: for each sa index k, walk until a sampled slot.
void ibwa_sa_lookup(const uint32_t* interleaved, uint32_t primary,
                    const uint32_t* l2, uint32_t seq_len, uint32_t sa_intv,
                    const uint32_t* sampled_sa, const uint32_t* ks, uint32_t n,
                    uint32_t* out) {
  InterleavedBwt b{interleaved, primary, {l2[0], l2[1], l2[2], l2[3], l2[4]},
                   seq_len};
  if (sa_intv && (sa_intv & (sa_intv - 1)) == 0) {
    // power-of-two interval (bwa writes 32): mask instead of a div per step
    const uint32_t mask = sa_intv - 1;
    const uint32_t shift = (uint32_t)__builtin_ctz(sa_intv);
    for (uint32_t i = 0; i < n; ++i) {
      uint32_t k = ks[i], add = 0;
      while (k & mask) {
        ++add;
        k = inv_psi(b, k);
      }
      out[i] = add + sampled_sa[k >> shift];
    }
    return;
  }
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t k = ks[i], add = 0;
    while (k % sa_intv != 0) {
      ++add;
      k = inv_psi(b, k);
    }
    out[i] = add + sampled_sa[k / sa_intv];
  }
}

uint32_t ibwa_occ(const uint32_t* interleaved, uint32_t primary,
                  const uint32_t* l2, uint32_t seq_len, uint32_t k, int32_t c) {
  InterleavedBwt b{interleaved, primary, {l2[0], l2[1], l2[2], l2[3], l2[4]},
                   seq_len};
  return occ1(b, k, (int)c);
}

// n successive lrand48() draws; *state is the raw 48-bit X (advanced).
void ibwa_lrand48(uint64_t* state, uint64_t n, uint32_t* out) {
  uint64_t x = *state;
  for (uint64_t i = 0; i < n; ++i) {
    x = (R48_A * x + R48_C) & R48_MASK;
    out[i] = (uint32_t)(x >> 17);
  }
  *state = x;
}

void ibwa_drand48(uint64_t* state, uint64_t n, double* out) {
  uint64_t x = *state;
  const double scale = 1.0 / 281474976710656.0;  // 2^-48
  for (uint64_t i = 0; i < n; ++i) {
    x = (R48_A * x + R48_C) & R48_MASK;
    out[i] = (double)x * scale;
  }
  *state = x;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded global alignment with affine gaps (Needleman-Wunsch), matching the
// recurrence, banding and traceback tie-break semantics of the reference's
// aln_global_core (stdaln.c:345-525).  Used for gapped-hit CIGAR refinement
// (bwa_refine_gapped, bwase.c:333-449) and mate-rescue path fill.
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kMinorInf = -1073741823;
enum { TR_M = 0, TR_I = 1, TR_D = 2, TR_S = 3 };

struct DpScore {
  int32_t M, I, D;
};
struct DpCell {
  uint8_t Mt, It, Dt;
};

struct GlobalAlnCtx {
  int32_t gap_open, gap_ext, gap_end;
  const int32_t* matrix;
  int32_t row;

  // trace selection: M prefers M over D over I on ties exactly as the
  // reference macros do (M>=I, then M>=D; else I>D)
  inline void set_M(DpScore& s, DpCell& c, const DpScore& p, int32_t sc) const {
    if (p.M >= p.I) {
      if (p.M >= p.D) { s.M = p.M + sc; c.Mt = TR_M; }
      else            { s.M = p.D + sc; c.Mt = TR_D; }
    } else if (p.I > p.D) { s.M = p.I + sc; c.Mt = TR_I; }
    else                  { s.M = p.D + sc; c.Mt = TR_D; }
  }
  inline void set_I(DpScore& s, DpCell& c, const DpScore& p) const {
    if (p.M - gap_open > p.I) { c.It = TR_M; s.I = p.M - gap_open - gap_ext; }
    else                      { c.It = TR_I; s.I = p.I - gap_ext; }
  }
  inline void set_end_I(DpScore& s, DpCell& c, const DpScore& p) const {
    if (gap_end >= 0) {
      if (p.M - gap_open > p.I) { c.It = TR_M; s.I = p.M - gap_open - gap_end; }
      else                      { c.It = TR_I; s.I = p.I - gap_end; }
    } else set_I(s, c, p);
  }
  inline void set_D(DpScore& s, DpCell& c, const DpScore& p) const {
    if (p.M - gap_open > p.D) { c.Dt = TR_M; s.D = p.M - gap_open - gap_ext; }
    else                      { c.Dt = TR_D; s.D = p.D - gap_ext; }
  }
  inline void set_end_D(DpScore& s, DpCell& c, const DpScore& p) const {
    if (gap_end >= 0) {
      if (p.M - gap_open > p.D) { c.Dt = TR_M; s.D = p.M - gap_open - gap_end; }
      else                      { c.Dt = TR_D; s.D = p.D - gap_end; }
    } else set_D(s, c, p);
  }
};

}  // namespace

extern "C" {

// seq1 = reference segment (len1), seq2 = read (len2), 2-bit codes (values
// >=4 score as N via matrix row/col 4).  Writes the traceback as op codes
// (0=M,1=I,2=D) into out_ops end-to-start order reversed to start-to-end,
// run-length encoded as bwa_cigar_t (op<<29|len).  Returns n_cigar, or -1
// if out_cap is too small.  *score_out gets the alignment score.
int32_t ibwa_global_aln(const uint8_t* seq1, int32_t len1, const uint8_t* seq2,
                        int32_t len2, int32_t gap_open, int32_t gap_ext,
                        int32_t gap_end, int32_t band,
                        const int32_t* matrix, int32_t row,
                        uint32_t* out_cigar, int32_t out_cap,
                        int32_t* score_out) {
  *score_out = 0;
  if (len1 == 0 || len2 == 0) return 0;
  GlobalAlnCtx ctx{gap_open, gap_ext, gap_end, matrix, row};

  int32_t b1, b2;
  if (len1 > len2) { b1 = len1 - len2 + band; b2 = band; }
  else             { b1 = band; b2 = len2 - len1 + band; }
  if (b1 > len1) b1 = len1;
  if (b2 > len2) b2 = len2;

  static thread_local std::vector<DpScore> rowA, rowB;
  rowA.assign((size_t)len1 + 1, DpScore());
  rowB.assign((size_t)len1 + 1, DpScore());
  DpScore* curr = rowA.data();
  DpScore* last = rowB.data();
  // traceback matrix: grow-only uninitialized scratch — only band cells
  // are ever written or read back, so the value-initializing vector here
  // was pure memset cost (the reference's dpcell rows are plain malloc,
  // stdaln.c:361-366)
  static thread_local std::unique_ptr<DpCell[]> cells_buf;
  static thread_local size_t cells_cap = 0;
  size_t need = (size_t)(len2 + 1) * (len1 + 1);
  if (need > cells_cap) {
    cells_cap = need + need / 2;
    cells_buf.reset(new DpCell[cells_cap]);
  }
  DpCell* cells = cells_buf.get();
  auto cell = [&](int32_t j, int32_t i) -> DpCell& {
    return cells[(size_t)j * (len1 + 1) + i];
  };
  auto sc_at = [&](int32_t j, int32_t i) {
    // matrix[read_base][ref_base], 1-based i/j as in the reference
    return matrix[seq2[j - 1] * row + seq1[i - 1]];
  };
  const DpScore inf3{kMinorInf, kMinorInf, kMinorInf};

  // row 0
  curr[0] = {0, kMinorInf, kMinorInf};
  for (int32_t i = 1; i < b1; ++i) {
    curr[i] = inf3;
    ctx.set_end_D(curr[i], cell(0, i), curr[i - 1]);
  }
  std::swap(curr, last);

  int32_t j = 1;
  auto part1_row = [&](int32_t jj, bool end_d) {
    curr[0] = inf3;
    ctx.set_end_I(curr[0], cell(jj, 0), last[0]);
    int32_t end = (jj + b1 <= len1 + 1) ? (jj + b1 - 1) : len1;
    int32_t i = 1;
    for (; i != end; ++i) {
      curr[i] = inf3;
      ctx.set_M(curr[i], cell(jj, i), last[i - 1], sc_at(jj, i));
      ctx.set_I(curr[i], cell(jj, i), last[i]);
      if (end_d) ctx.set_end_D(curr[i], cell(jj, i), curr[i - 1]);
      else       ctx.set_D(curr[i], cell(jj, i), curr[i - 1]);
    }
    curr[i] = inf3;
    ctx.set_M(curr[i], cell(jj, i), last[i - 1], sc_at(jj, i));
    if (end_d) ctx.set_end_D(curr[i], cell(jj, i), curr[i - 1]);
    else       ctx.set_D(curr[i], cell(jj, i), curr[i - 1]);
    if (jj + b1 - 1 > len1) ctx.set_end_I(curr[i], cell(jj, i), last[i]);
    else curr[i].I = kMinorInf;
    std::swap(curr, last);
  };

  int32_t tmp_end = (b2 < len2) ? b2 : len2 - 1;
  for (; j <= tmp_end; ++j) part1_row(j, false);
  if (j == len2 && b2 != len2 - 1) { part1_row(j, true); ++j; }

  for (; j <= len2 - b2 + 1; ++j) {  // part 2
    curr[j - b2] = inf3;
    int32_t end = j + b1 - 1;
    int32_t i = j - b2 + 1;
    for (; i != end; ++i) {
      curr[i] = inf3;
      ctx.set_M(curr[i], cell(j, i), last[i - 1], sc_at(j, i));
      ctx.set_I(curr[i], cell(j, i), last[i]);
      ctx.set_D(curr[i], cell(j, i), curr[i - 1]);
    }
    curr[i] = inf3;
    ctx.set_M(curr[i], cell(j, i), last[i - 1], sc_at(j, i));
    ctx.set_D(curr[i], cell(j, i), curr[i - 1]);
    curr[i].I = kMinorInf;
    std::swap(curr, last);
  }

  for (; j < len2; ++j) {  // part 3
    curr[j - b2] = inf3;
    int32_t i = j - b2 + 1;
    for (; i < len1; ++i) {
      curr[i] = inf3;
      ctx.set_M(curr[i], cell(j, i), last[i - 1], sc_at(j, i));
      ctx.set_I(curr[i], cell(j, i), last[i]);
      ctx.set_D(curr[i], cell(j, i), curr[i - 1]);
    }
    curr[i] = inf3;
    ctx.set_M(curr[i], cell(j, i), last[len1 - 1], sc_at(j, i));
    ctx.set_end_I(curr[i], cell(j, i), last[i]);
    ctx.set_D(curr[i], cell(j, i), curr[i - 1]);
    std::swap(curr, last);
  }

  if (j == len2) {  // last row
    curr[j - b2] = inf3;
    int32_t i = j - b2 + 1;
    for (; i < len1; ++i) {
      curr[i] = inf3;
      ctx.set_M(curr[i], cell(j, i), last[i - 1], sc_at(j, i));
      ctx.set_I(curr[i], cell(j, i), last[i]);
      ctx.set_end_D(curr[i], cell(j, i), curr[i - 1]);
    }
    curr[i] = inf3;
    ctx.set_M(curr[i], cell(j, i), last[len1 - 1], sc_at(j, i));
    ctx.set_end_I(curr[i], cell(j, i), last[i]);
    ctx.set_end_D(curr[i], cell(j, i), curr[i - 1]);
    std::swap(curr, last);
  }

  // traceback from (len1, len2); M wins ties, D needs strict >
  int32_t i = len1;
  j = len2;
  const DpScore& fin = last[len1];
  int32_t max = fin.M;
  uint8_t ctype = TR_M, type = cell(j, i).Mt;
  if (fin.I > max) { max = fin.I; ctype = TR_I; type = cell(j, i).It; }
  if (fin.D > max) { max = fin.D; ctype = TR_D; type = cell(j, i).Dt; }

  std::vector<uint8_t> ops;  // end-to-start
  ops.push_back(ctype);
  for (;;) {
    switch (ctype) {
      case TR_M: --i; --j; break;
      case TR_I: --j; break;
      default: --i; break;
    }
    if (i == 0 && j == 0) break;
    ctype = type;
    const DpCell& q = cell(j, i);
    type = (ctype == TR_M) ? q.Mt : (ctype == TR_I) ? q.It : q.Dt;
    ops.push_back(ctype);
  }

  // run-length encode start-to-end (aln_path2cigar32 + bwa op<<29|len pack)
  int32_t n = 0;
  for (size_t t = ops.size(); t-- > 0;) {
    uint32_t op = ops[t];
    if (n > 0 && (out_cigar[n - 1] >> 29) == op) {
      out_cigar[n - 1] += 1;
    } else {
      if (n >= out_cap) return -1;
      out_cigar[n++] = (op << 29) | 1u;
    }
  }
  *score_out = max;
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded local alignment (Smith-Waterman) matching aln_local_core
// (stdaln.c:529-761): packed 16+16-bit h/e rows with overflow rescaling,
// forward pass for (score, end), banded reverse pass for start, then a
// global-DP path fill with doubling band.  Used by PE mate rescue
// (bwa_sw_core, bwasw.c:29-112).
// ---------------------------------------------------------------------------

namespace {
constexpr int kOverflowThreshold = 32000;
constexpr int kOverflowReduce = 16000;
}

extern "C" {

// Returns n_cigar (0 => no acceptable alignment).  out_meta receives
// [score, first_i, first_j, end_i, end_j] where first_i/first_j are the
// path cell adjacent to the alignment start (reference path_t
// path[path_len-1] coordinates, used by bwa_sw_core's clip math).
int32_t ibwa_local_aln(const uint8_t* seq1, int32_t len1, const uint8_t* seq2,
                       int32_t len2, int32_t gap_open, int32_t gap_ext,
                       int32_t band, const int32_t* matrix, int32_t row,
                       int32_t thres, uint32_t* out_cigar, int32_t out_cap,
                       int32_t* out_meta) {
  // out_meta: [score, first_i, first_j, end_i, end_j, subo]
  out_meta[0] = -1;
  out_meta[5] = 0;
  if (len1 == 0 || len2 == 0) return 0;
  std::vector<int> suba(len2 + 1, 0);
  const int q = gap_open, r = gap_ext, qr = q + r;
  const int64_t qr_shift = (int64_t)(qr + 1) << 16;

  int max_score = 0;
  for (int i = 0; i < row * row; ++i)
    if (matrix[i] > max_score) max_score = matrix[i];

  // score profile: s_array[c][i] = matrix[c][seq1[i]]  (1-based i)
  std::vector<int> prof(row * (len1 + 1));
  for (int c = 0; c < row; ++c)
    for (int i = 1; i <= len1; ++i)
      prof[c * (len1 + 1) + i] = matrix[c * row + seq1[i - 1]];

  std::vector<int32_t> eh(len1 + 2, 0);  // packed h<<16 | e
  int score_f = 0, end_i = 0, end_j = 0;
  int is_overflow = 0, of_base = 0;

  // forward pass
  for (int j = 1; j <= len2; ++j) {
    int last_h = 0, f = 0, subo_row = 0;
    const int* sa = &prof[seq2[j - 1] * (len1 + 1)];
    if (is_overflow) {
      score_f -= kOverflowReduce;
      of_base += kOverflowReduce;
      is_overflow = 0;
      for (int i = 0; i <= len1; ++i) {
        int h = eh[i] >> 16, e = eh[i] & 0xffff;
        e = e < kOverflowReduce ? 0 : e - kOverflowReduce;
        h = h < kOverflowReduce ? 0 : h - kOverflowReduce;
        eh[i] = (h << 16) | e;
      }
    }
    for (int i = 1; i <= len1; ++i) {
      int curr_h = (eh[i - 1] >> 16) + sa[i];
      if (curr_h < 0) curr_h = 0;
      if (last_h > 0) {
        f = (f > last_h - q) ? f - r : last_h - qr;
        if (curr_h < f) curr_h = f;
      }
      if (eh[i] >= qr_shift) {
        int curr_last_h = eh[i] >> 16;
        int e = ((eh[i - 1] & 0xffff) > curr_last_h - q)
                    ? (eh[i - 1] & 0xffff) - r : curr_last_h - qr;
        if (curr_h < e) curr_h = e;
        eh[i - 1] = (last_h << 16) | e;
      } else {
        eh[i - 1] = last_h << 16;
      }
      last_h = curr_h;
      if (subo_row < curr_h) subo_row = curr_h;
      if (score_f < curr_h) {
        score_f = curr_h; end_i = i; end_j = j;
        if (score_f > kOverflowThreshold) is_overflow = 1;
      }
    }
    eh[len1] = last_h << 16;
    suba[j] = subo_row + of_base;
  }
  score_f += of_base;
  out_meta[0] = score_f;
  if (score_f < thres) return 0;

  // reverse pass (banded): find the alignment start
  for (int i = 0; i <= end_i; ++i) eh[i] = 0;
  if (end_i == 0 || end_j == 0) return 0;
  int score_r = matrix[seq1[end_i - 1] * row + seq2[end_j - 1]];
  is_overflow = of_base = 0;
  int start_i = end_i, start_j = end_j;
  eh[end_i] = (int32_t)((qr + score_r)) << 16;
  int start = end_i - 1;
  int end = end_i - 3;
  if (end <= 0) end = 0;

  for (int j = end_j - 1; j != 0; --j) {
    int last_h = 0, f = 0;
    const int* sa = &prof[seq2[j - 1] * (len1 + 1)];
    if (is_overflow) {
      score_r -= kOverflowReduce;
      of_base += kOverflowReduce;
      is_overflow = 0;
      for (int i = start; i >= end; --i) {
        int h = eh[i + 1] >> 16, e = eh[i + 1] & 0xffff;
        e = e < kOverflowReduce ? 0 : e - kOverflowReduce;
        h = h < kOverflowReduce ? 0 : h - kOverflowReduce;
        eh[i + 1] = (h << 16) | e;
      }
    }
    int i = start;
    for (; i != end; --i) {
      int curr_h = (eh[i + 1] >> 16) + sa[i];
      if (curr_h < 0) curr_h = 0;
      if (last_h > 0) {
        f = (f > last_h - q) ? f - r : last_h - qr;
        if (curr_h < f) curr_h = f;
      }
      int curr_last_h = eh[i] >> 16;
      int e = ((eh[i + 1] & 0xffff) > curr_last_h - q)
                  ? (eh[i + 1] & 0xffff) - r : curr_last_h - qr;
      if (e < 0) e = 0;
      if (curr_h < e) curr_h = e;
      eh[i + 1] = (last_h << 16) | e;
      last_h = curr_h;
      if (score_r < curr_h) {
        score_r = curr_h; start_i = i; start_j = j;
        if (score_r + of_base - qr == score_f) { j = 1; break; }
        if (score_r > kOverflowThreshold) is_overflow = 1;
      }
    }
    eh[i + 1] = last_h << 16;
    if ((eh[start] >> 16) <= qr) --start;
    if (start <= 0) start = 0;
    end = start_i - (start_j - j)
          - (score_r + of_base + (start_j - j) * max_score) / r - 1;
    if (end <= 0) end = 0;
  }

  score_r += of_base;
  score_r -= qr;

  // path fill by banded global DP with doubling band (gap_end = -1)
  int score_g = 0;
  int n_cigar = 0;
  int jmax = (end_i - start_i > end_j - start_j) ? end_i - start_i
                                                 : end_j - start_j;
  ++jmax;
  for (int bw = band;; bw <<= 1) {
    int32_t sc = 0;
    n_cigar = ibwa_global_aln(seq1 + (start_i - 1), end_i - start_i + 1,
                              seq2 + (start_j - 1), end_j - start_j + 1,
                              gap_open, gap_ext, /*gap_end=*/-1, bw,
                              matrix, row, out_cigar, out_cap, &sc);
    if (n_cigar < 0) return -1;
    score_g = sc;
    if (score_g == score_r || score_f == score_g) break;
    if (bw > jmax) break;
  }
  if (score_r > score_g && score_f > score_g) {
    out_meta[0] = -1;  // reference warns "Potential bug" and flags -1
  } else {
    out_meta[0] = score_g;
  }

  { // suboptimal score outside +-33% of the hit span (stdaln.c:700-708)
    int tmp2 = 0;
    int tmp = (int)(start_j - 0.33 * (end_j - start_j) + 0.499);
    for (int j2 = 1; j2 <= tmp; ++j2)
      if (tmp2 < suba[j2]) tmp2 = suba[j2];
    tmp = (int)(end_j + 0.33 * (end_j - start_j) + 0.499);
    for (int j2 = tmp; j2 <= len2; ++j2)
      if (j2 >= 1 && tmp2 < suba[j2]) tmp2 = suba[j2];
    out_meta[5] = tmp2;
  }

  // first path cell (reference path[path_len-1] after coordinate shift)
  int fi = 0, fj = 0;
  if (n_cigar > 0) {
    uint32_t op = out_cigar[0] >> 29;
    fi = (op == 0 || op == 2) ? 1 : 0;
    fj = (op == 0 || op == 1) ? 1 : 0;
  }
  out_meta[1] = fi + start_i - 1;
  out_meta[2] = fj + start_j - 1;
  out_meta[3] = end_i;
  out_meta[4] = end_j;
  return n_cigar;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-sided seed extension matching aln_extend_core (stdaln.c:862-1008):
// banded SW seeded with score G0 at the origin, adaptive band shrink, no
// traceback (BWA-SW only needs the best endpoint; the final CIGAR comes
// from a separate global DP, bwtsw2_aux.c:167-216).
// ---------------------------------------------------------------------------

extern "C" {

// out_meta = [score, end_i, end_j]
void ibwa_extend_aln(const uint8_t* seq1, int32_t len1, const uint8_t* seq2,
                     int32_t len2, int32_t gap_open, int32_t gap_ext,
                     int32_t band, const int32_t* matrix, int32_t row,
                     int32_t G0, int32_t* out_meta) {
  out_meta[0] = -1;
  out_meta[1] = out_meta[2] = 0;
  if (len1 == 0 || len2 == 0) return;
  const int q = gap_open, r = gap_ext, qr = q + r;

  // no per-call score profile: the reference indexes the matrix row
  // directly per cell (stdaln.c:905); a profile costs an O(row*len1)
  // fill + allocation per call and extensions are called per hit side
  static thread_local std::vector<uint32_t> eh;
  eh.assign((size_t)len1 + 2, 0);
  int start = 1, end = 2;
  int end_i = 0, end_j = 0, score = 0;
  int is_overflow = 0, of_base = 0;
  eh[1] = (uint32_t)G0 << 16;
  const uint8_t* s1 = seq1 - 1;  // 1-based cell index -> seq1[i-1]

  for (int j = 1; j <= len2; ++j) {
    int h1 = 0, f = 0;
    const int32_t* srow = matrix + (size_t)seq2[j - 1] * row;
    int s2 = j - band;
    if (s2 < 1) s2 = 1;
    if (s2 > start) start = s2;
    int e2 = j + band;
    if (e2 > len1 + 1) e2 = len1 + 1;
    if (e2 < end) end = e2;
    if (start == end) break;
    if (is_overflow) {
      score -= kOverflowReduce;
      of_base += kOverflowReduce;
      is_overflow = 0;
      for (int i = start; i <= end; ++i) {
        int h = eh[i] >> 16, e = eh[i] & 0xffff;
        e = e < kOverflowReduce ? 0 : e - kOverflowReduce;
        h = h < kOverflowReduce ? 0 : h - kOverflowReduce;
        eh[i] = ((uint32_t)h << 16) | e;
      }
    }
    int nstart = 0, nend = 0;
    for (int i = start; i < end; ++i) {
      int h = (int)(eh[i] >> 16);
      int e = eh[i] & 0xffff;
      eh[i] = (uint32_t)h1 << 16;
      h += h ? srow[s1[i]] : 0;  // left_core: empty cells stay empty
      h = h > e ? h : e;
      h = h > f ? h : f;
      h1 = h;
      if (h > 0) {
        if (nstart == 0) nstart = i;
        nend = i;
        if (score < h) {
          score = h; end_i = i; end_j = j;
          if (score > kOverflowThreshold) is_overflow = 1;
        }
      }
      h -= qr;
      h = h > 0 ? h : 0;
      e -= r;
      e = e > h ? e : h;
      f -= r;
      f = f > h ? f : h;
      eh[i] |= (uint32_t)e;
    }
    eh[end] = (uint32_t)h1 << 16;
    if (nend <= 0) break;
    start = nstart;
    end = nend + 3;
  }

  score += of_base - 1;
  out_meta[0] = score;
  out_meta[1] = end_i;
  out_meta[2] = end_j;
}

}  // extern "C"

extern "C" {

// bwt_occ4 on the interleaved layout (bwt.c:139-175); single query.
void ibwa_occ4(const uint32_t* interleaved, uint32_t primary,
               const uint32_t* l2, uint32_t seq_len, uint32_t k,
               uint32_t* out) {
  InterleavedBwt b{interleaved, primary,
                   {l2[0], l2[1], l2[2], l2[3], l2[4]}, seq_len};
  if (k == 0xFFFFFFFFu) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  if (k == seq_len) {
    for (int c = 0; c < 4; ++c) out[c] = b.l2[c + 1] - b.l2[c];
    return;
  }
  if (k >= b.primary) --k;
  const uint32_t* blk = b.data + (k / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t base0 = (k / 128) * 128;
  uint32_t full_words = (k - base0) / 16;
  for (int c = 0; c < 4; ++c) {
    uint32_t n = blk[c];
    for (uint32_t j = 0; j < full_words; ++j)
      n += count_code_prefix(w[j], c, 16);
    n += count_code_prefix(w[full_words], c, (int)(k % 16) + 1);
    out[c] = n;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host gapped search: exact semantics of bwt_match_gap (bwtgap.c:104-264)
// including score-bucketed LIFO pop order, D(i)/seed width pruning,
// top2 stopping, gap_shadow and (k,l) dedup.  Used as the fast fallback
// for reads whose search exceeds the device engine's step budget (the
// reference similarly bails at max_entries, bwtgap.c:139).
// ---------------------------------------------------------------------------

namespace {

constexpr int ST_M = 0, ST_I = 1, ST_D = 2;

struct GapEntry {
  int a, i;
  uint32_t k, l;
  int n_mm, n_gapo, n_gape, state, last_diff_pos, score;
};

struct GapOptC {
  int s_mm, s_gapo, s_gape, max_gapo, max_gape, max_seed_diff;
  int indel_end_skip, max_del_occ, max_entries, max_top2, mode;
};

constexpr int MODE_GAPE = 0x01, MODE_LOGGAP = 0x04, MODE_NONSTOP = 0x10;

struct GapStack {
  std::vector<std::vector<GapEntry>> buckets;
  int best, n;
  explicit GapStack(int nb) : buckets(nb), best(nb), n(0) {}
  void push(const GapEntry& e) {
    buckets[e.score].push_back(e);
    ++n;
    if (e.score < best) best = e.score;
  }
  GapEntry pop() {
    GapEntry e = buckets[best].back();
    buckets[best].pop_back();
    --n;
    if (buckets[best].empty() && n) {
      int b = best + 1;
      while (buckets[b].empty()) ++b;
      best = b;
    } else if (n == 0) {
      best = (int)buckets.size();
    }
    return e;
  }
};

static inline void occ4_at(const InterleavedBwt& b, uint32_t k,
                           uint32_t cnt[4]) {
  if (k == 0xFFFFFFFFu) {
    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;
    return;
  }
  if (k == b.seq_len) {
    for (int c = 0; c < 4; ++c) cnt[c] = b.l2[c + 1] - b.l2[c];
    return;
  }
  if (k >= b.primary) --k;
  const uint32_t* blk = b.data + (k / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t full = (k % 128) / 16;
  if (full >= 4 && (k / 128) * 128 + 128 < b.seq_len) {
    // upper half: count backward from the next block's checkpoint
    uint32_t x = 0;
    for (uint32_t j = full + 1; j < 8; ++j) x += occ_packed4(w[j]);
    uint32_t ns = 15 - (k % 16);
    if (ns) x += occ_packed4_suffix(w[full], ns);
    for (int c = 0; c < 4; ++c) cnt[c] = blk[12 + c] - ((x >> (8 * c)) & 0xff);
    return;
  }
  uint32_t x = 0;
  for (uint32_t j = 0; j < full; ++j) x += occ_packed4(w[j]);
  x += occ_packed4_prefix(w[full], (k % 16) + 1);
  for (int c = 0; c < 4; ++c) cnt[c] = blk[c] + ((x >> (8 * c)) & 0xff);
}

// paired occ4 at (k, l) sharing one block scan when co-resident — the
// reference's bwt_2occ4 (bwt.c:177-214)
static inline void occ2x4_at(const InterleavedBwt& b, uint32_t k, uint32_t l,
                             uint32_t cnt_k[4], uint32_t cnt_l[4]) {
  uint32_t k2 = k, l2 = l;
  if (k2 != 0xFFFFFFFFu && k2 != b.seq_len && k2 >= b.primary) --k2;
  if (l2 != 0xFFFFFFFFu && l2 != b.seq_len && l2 >= b.primary) --l2;
  if (k == 0xFFFFFFFFu || k == b.seq_len || l == 0xFFFFFFFFu ||
      l == b.seq_len || (k2 >> 7) != (l2 >> 7)) {
    occ4_at(b, k, cnt_k);
    occ4_at(b, l, cnt_l);
    return;
  }
  const uint32_t* blk = b.data + (k2 / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t fw_k = (k2 % 128) / 16, fw_l = (l2 % 128) / 16;
  if (fw_k >= 4 && (k2 / 128) * 128 + 128 < b.seq_len) {
    // both in the upper half (l2 >= k2): shared backward scan
    uint32_t x = 0, j = 7;
    for (; j > fw_l; --j) x += occ_packed4(w[j]);
    uint32_t nsl = 15 - (l2 % 16);
    uint32_t xl = x + (nsl ? occ_packed4_suffix(w[fw_l], nsl) : 0);
    for (; j > fw_k; --j) x += occ_packed4(w[j]);
    uint32_t nsk = 15 - (k2 % 16);
    uint32_t xk = x + (nsk ? occ_packed4_suffix(w[fw_k], nsk) : 0);
    for (int c = 0; c < 4; ++c) {
      cnt_k[c] = blk[12 + c] - ((xk >> (8 * c)) & 0xff);
      cnt_l[c] = blk[12 + c] - ((xl >> (8 * c)) & 0xff);
    }
    return;
  }
  uint32_t x = 0, j = 0;
  for (; j < fw_k; ++j) x += occ_packed4(w[j]);
  uint32_t xk = x + occ_packed4_prefix(w[fw_k], (k2 % 16) + 1);
  for (; j < fw_l; ++j) x += occ_packed4(w[j]);
  uint32_t xl = x + occ_packed4_prefix(w[fw_l], (l2 % 16) + 1);
  for (int c = 0; c < 4; ++c) {
    cnt_k[c] = blk[c] + ((xk >> (8 * c)) & 0xff);
    cnt_l[c] = blk[c] + ((xl >> (8 * c)) & 0xff);
  }
}

static void cal_width_c(const InterleavedBwt& b, const uint8_t* s, int n,
                        uint32_t* w, int* bid) {
  uint32_t k = 0, l = b.seq_len;
  int bb = 0;
  for (int i = 0; i < n; ++i) {
    int c = s[i];
    if (c < 4) {
      uint32_t ok, ol;
      occ1_pair(b, k == 0 ? 0xFFFFFFFFu : k - 1, l, c, &ok, &ol);
      k = b.l2[c] + ok + 1;
      l = b.l2[c] + ol;
    }
    if (k > l || c > 3) {
      k = 0;
      l = b.seq_len;
      ++bb;
    }
    w[i] = l - k + 1;
    bid[i] = bb;
  }
  w[n] = 0;
  bid[n] = bb + 1;
}

static void gap_shadow_c(int64_t x, uint32_t seq_len, int last_diff_pos,
                         uint32_t* w, int* bid) {
  int j = 0;
  for (int i = 0; i < last_diff_pos; ++i) {
    if ((int64_t)w[i] > x) {
      w[i] -= (uint32_t)x;
    } else if ((int64_t)w[i] == x) {
      bid[i] = 1;
      ++j;
      w[i] = seq_len - j;
    }
  }
}

static inline int aln_score_c(int mm, int gapo, int gape,
                              const GapOptC& o) {
  return mm * o.s_mm + gapo * o.s_gapo + gape * o.s_gape;
}

static inline int int_log2_c(uint32_t v) {
  int c = 0;
  if (v & 0xFFFF0000u) { v >>= 16; c |= 16; }
  if (v & 0xFF00) { v >>= 8; c |= 8; }
  if (v & 0xF0) { v >>= 4; c |= 4; }
  if (v & 0xC) { v >>= 2; c |= 2; }
  if (v & 0x2) c |= 1;
  return c;
}

}  // namespace

extern "C" {

// Single-read gapped search. fms[0]=fwd, fms[1]=rev interleaved tables.
// Returns n_hits (records: meta = n_mm|gapo<<8|gape<<16|a<<24, k, l,
// score), or -1 on out-capacity overflow.
int32_t ibwa_match_gap(const uint32_t* itl_fwd, uint32_t primary_fwd,
                       const uint32_t* itl_rev, uint32_t primary_rev,
                       const uint32_t* l2, uint32_t seq_len,
                       const uint8_t* seq, const uint8_t* rseq,
                       int32_t len, int32_t max_diff, int32_t seed_len,
                       const int32_t* optv, uint32_t* out, int32_t cap) {
  GapOptC o{optv[0], optv[1], optv[2], optv[3], optv[4], optv[5],
            optv[6], optv[7], optv[8], optv[9], optv[10]};
  InterleavedBwt fms[2] = {
      {itl_fwd, primary_fwd, {l2[0], l2[1], l2[2], l2[3], l2[4]}, seq_len},
      {itl_rev, primary_rev, {l2[0], l2[1], l2[2], l2[3], l2[4]}, seq_len}};
  const uint8_t* seqs[2] = {seq, rseq};
  const int n = len;

  int n_amb = 0;
  for (int i = 0; i < n; ++i) n_amb += seq[i] > 3;
  if (n_amb > max_diff) return 0;

  // widths (strand a computed against fms[a]) + optional seed widths
  std::vector<uint32_t> w0(n + 1), w1(n + 1), sw0, sw1;
  std::vector<int> b0(n + 1), b1(n + 1), sb0, sb1;
  cal_width_c(fms[0], seq, n, w0.data(), b0.data());
  cal_width_c(fms[1], rseq, n, w1.data(), b1.data());
  uint32_t* W[2] = {w0.data(), w1.data()};
  int* BID[2] = {b0.data(), b1.data()};
  bool has_seed = seed_len < n;
  uint32_t* SW[2] = {nullptr, nullptr};
  int* SBID[2] = {nullptr, nullptr};
  if (has_seed) {
    sw0.resize(seed_len + 1); sw1.resize(seed_len + 1);
    sb0.resize(seed_len + 1); sb1.resize(seed_len + 1);
    cal_width_c(fms[0], seq + n - seed_len, seed_len, sw0.data(),
                sb0.data());
    cal_width_c(fms[1], rseq + n - seed_len, seed_len, sw1.data(),
                sb1.data());
    SW[0] = sw0.data(); SW[1] = sw1.data();
    SBID[0] = sb0.data(); SBID[1] = sb1.data();
  }

  const bool gape_mode = o.mode & MODE_GAPE;
  const bool nonstop = o.mode & MODE_NONSTOP;
  const bool loggap = o.mode & MODE_LOGGAP;

  int best_score = aln_score_c(max_diff + 1, o.max_gapo + 1,
                               o.max_gape + 1, o);
  int best_diff = max_diff + 1;
  // bwtgap.c's best_cnt is an int: the rows of the best hits summed wrap
  // at 2^31 as there (and as in the device search, csrc/search_step.cuh),
  // which a hit of 2^31 rows and more, on a table above 2^31 rows, reaches
  int32_t best_cnt = 0;
  int n_buckets = best_score + 1;
  GapStack stack(n_buckets);
  stack.push({0, n, 0, seq_len, 0, 0, 0, ST_M, 0, 0});
  stack.push({1, n, 0, seq_len, 0, 0, 0, ST_M, 0, 0});

  int n_hits = 0;
  while (stack.n) {
    if (stack.n > o.max_entries) break;
    GapEntry e = stack.pop();
    if (!nonstop && e.score > best_score + o.s_mm) break;

    int m = max_diff - (e.n_mm + e.n_gapo);
    if (gape_mode) m -= e.n_gape;
    if (m < 0) continue;
    const InterleavedBwt& fm = fms[1 - e.a];
    const uint8_t* s = seqs[e.a];
    uint32_t* w_arr = W[e.a];
    int* bid_arr = BID[e.a];
    int m_seed = 0;
    if (has_seed) {
      m_seed = o.max_seed_diff - (e.n_mm + e.n_gapo);
      if (gape_mode) m_seed -= e.n_gape;
    }
    int i = e.i;
    uint32_t k = e.k, l = e.l;
    if (i > 0 && m < bid_arr[i - 1]) continue;

    bool hit_found = false;
    if (i == 0) {
      hit_found = true;
    } else if (m == 0 && (e.state == ST_M || gape_mode
                          || e.n_gape == o.max_gape)) {
      // bwt_match_exact_alt over s[0..i-1] (bwt.c:235-250)
      bool ok = true;
      for (int t = i - 1; t >= 0; --t) {
        int c = s[t];
        if (c > 3) { ok = false; break; }
        uint32_t okk, oll;
        occ1_pair(fm, k == 0 ? 0xFFFFFFFFu : k - 1, l, c, &okk, &oll);
        k = fm.l2[c] + okk + 1;
        l = fm.l2[c] + oll;
        if (k > l) { ok = false; break; }
      }
      if (ok) hit_found = true;
      else continue;
    }

    if (hit_found) {
      int score = aln_score_c(e.n_mm, e.n_gapo, e.n_gape, o);
      bool do_add = true;
      if (n_hits == 0) {
        best_score = score;
        best_diff = e.n_mm + e.n_gapo + (gape_mode ? e.n_gape : 0);
        if (!nonstop && best_diff + 1 < max_diff) max_diff = best_diff + 1;
        else if (!nonstop) max_diff = max_diff < best_diff + 1
                                          ? max_diff : best_diff + 1;
      }
      if (score == best_score) {
        best_cnt = (int32_t)((uint32_t)best_cnt + (l - k) + 1u);
      } else if (best_cnt > o.max_top2) {
        break;
      }
      if (e.n_gapo) {
        for (int t = 0; t < n_hits; ++t)
          if (out[t * 4 + 1] == k && out[t * 4 + 2] == l) {
            do_add = false;
            break;
          }
      }
      if (do_add) {
        gap_shadow_c((int64_t)(l - k) + 1, seq_len, e.last_diff_pos,
                     w_arr, bid_arr);
        if (n_hits >= cap) return -1;
        out[n_hits * 4 + 0] = (uint32_t)e.n_mm | (uint32_t)e.n_gapo << 8
                              | (uint32_t)e.n_gape << 16
                              | (uint32_t)e.a << 24;
        out[n_hits * 4 + 1] = k;
        out[n_hits * 4 + 2] = l;
        out[n_hits * 4 + 3] = (uint32_t)score;
        ++n_hits;
      }
      continue;
    }

    --i;
    uint32_t cnt_k[4], cnt_l[4];
    occ2x4_at(fm, k == 0 ? 0xFFFFFFFFu : k - 1, l, cnt_k, cnt_l);
    int64_t occv = (int64_t)(l - k) + 1;

    bool allow_diff = true, allow_m = true;
    if (i > 0) {
      int ii = i - (n - seed_len);
      if (bid_arr[i - 1] > m - 1) allow_diff = false;
      else if (bid_arr[i - 1] == m - 1 && bid_arr[i] == m - 1
               && w_arr[i - 1] == w_arr[i]) allow_m = false;
      if (has_seed && ii > 0) {
        const int* sbid = SBID[e.a];
        const uint32_t* sww = SW[e.a];
        if (sbid[ii - 1] > m_seed - 1) allow_diff = false;
        else if (sbid[ii - 1] == m_seed - 1 && sbid[ii] == m_seed - 1
                 && sww[ii - 1] == sww[ii]) allow_m = false;
      }
    }

    int tmp = loggap ? int_log2_c(e.n_gape + e.n_gapo) / 2 + 1
                     : e.n_gapo + e.n_gape;
    if (allow_diff && i >= o.indel_end_skip + tmp
        && n - i >= o.indel_end_skip + tmp) {
      if (e.state == ST_M) {
        if (e.n_gapo < o.max_gapo) {
          stack.push({e.a, i, k, l, e.n_mm, e.n_gapo + 1, e.n_gape, ST_I,
                      i, aln_score_c(e.n_mm, e.n_gapo + 1, e.n_gape, o)});
          for (int j = 0; j < 4; ++j) {
            uint32_t kj = fm.l2[j] + cnt_k[j] + 1;
            uint32_t lj = fm.l2[j] + cnt_l[j];
            if (kj <= lj)
              stack.push({e.a, i + 1, kj, lj, e.n_mm, e.n_gapo + 1,
                          e.n_gape, ST_D, i + 1,
                          aln_score_c(e.n_mm, e.n_gapo + 1, e.n_gape, o)});
          }
        }
      } else if (e.state == ST_I) {
        if (e.n_gape < o.max_gape)
          stack.push({e.a, i, k, l, e.n_mm, e.n_gapo, e.n_gape + 1, ST_I,
                      i, aln_score_c(e.n_mm, e.n_gapo, e.n_gape + 1, o)});
      } else if (e.state == ST_D) {
        if (e.n_gape < o.max_gape
            && (e.n_gape + e.n_gapo < max_diff || occv < o.max_del_occ)) {
          for (int j = 0; j < 4; ++j) {
            uint32_t kj = fm.l2[j] + cnt_k[j] + 1;
            uint32_t lj = fm.l2[j] + cnt_l[j];
            if (kj <= lj)
              stack.push({e.a, i + 1, kj, lj, e.n_mm, e.n_gapo,
                          e.n_gape + 1, ST_D, i + 1,
                          aln_score_c(e.n_mm, e.n_gapo, e.n_gape + 1, o)});
          }
        }
      }
    }

    if (allow_diff && allow_m) {
      for (int j = 1; j <= 4; ++j) {
        int c = (s[i] + j) & 3;
        int is_mm = (j != 4 || s[i] > 3);
        uint32_t kj = fm.l2[c] + cnt_k[c] + 1;
        uint32_t lj = fm.l2[c] + cnt_l[c];
        if (kj <= lj)
          stack.push({e.a, i, kj, lj, e.n_mm + is_mm, e.n_gapo, e.n_gape,
                      ST_M, is_mm ? i : e.last_diff_pos,
                      aln_score_c(e.n_mm + is_mm, e.n_gapo, e.n_gape, o)});
      }
    } else if (s[i] < 4) {
      int c = s[i] & 3;
      uint32_t kj = fm.l2[c] + cnt_k[c] + 1;
      uint32_t lj = fm.l2[c] + cnt_l[c];
      if (kj <= lj)
        stack.push({e.a, i, kj, lj, e.n_mm, e.n_gapo, e.n_gape, ST_M,
                    e.last_diff_pos, e.score});
    }
  }
  return n_hits;
}

// The host threads of the batch search.  omp_set_num_threads would set
// only the calling thread's count (an OpenMP ICV is per thread: the device
// engine calls the search from a pool thread), and that count is also the
// one torch's own OpenMP regions read on the thread; so the library keeps
// its own count and hands it to its parallel loop.  0 leaves the choice to
// OpenMP (OMP_NUM_THREADS as read when the library loaded, else the cores).
static std::atomic<int32_t> g_host_threads{0};

// Returns the setting before.
int32_t ibwa_set_threads(int32_t n) {
  return g_host_threads.exchange(n > 0 ? n : 0);
}

int32_t ibwa_get_threads() {
  const int32_t n = g_host_threads;
  return n > 0 ? n : omp_get_max_threads();
}

// One strand's row table of the device FM index (fm/device.py::
// build_blocks): the 128-base blocks of the interleaved stream (4
// checkpoint words + 8 text words, the last block's text short, then the
// final checkpoint) re-checkpointed at intv-base rows, out uint32[ceil(
// seq_len / intv)][4 + intv / 16]; a row's checkpoint is its block's plus
// the counts of the block's bases before it (three popcounts a word: low
// bits C + T, high bits G + T, both T; zero padding past seq_len counts as
// A, as ibwa_tpu/fm/device.py::_popcount_bases counts it).  Row and word
// offsets are 64-bit: a table of 2^32 rows has 2^26 blocks of 12 words.
void ibwa_build_blocks(const uint32_t* itl, uint32_t seq_len, int32_t intv,
                       uint32_t* out) {
  const int64_t n128 = ((int64_t)seq_len + 127) / 128;
  const int64_t n_rows = ((int64_t)seq_len + intv - 1) / intv;
  const int64_t n_words = ((int64_t)seq_len + 15) >> 4;
  const int sub = 128 / intv, w = intv >> 4, roww = 4 + w;
#pragma omp parallel for schedule(static) num_threads(ibwa_get_threads())
  for (int64_t b = 0; b < n128; ++b) {
    const uint32_t* blk = itl + 12 * b;
    uint32_t acc[4] = {blk[0], blk[1], blk[2], blk[3]};
    uint32_t words[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const int64_t have = std::min<int64_t>(8, n_words - 8 * b);
    for (int64_t j = 0; j < have; ++j) words[j] = blk[4 + j];
    for (int i = 0; i < sub && b * sub + i < n_rows; ++i) {
      uint32_t* row = out + (b * sub + i) * roww;
      for (int c = 0; c < 4; ++c) row[c] = acc[c];
      for (int j = 0; j < w; ++j) {
        const uint32_t x = words[w * i + j];
        const uint32_t lo = x & 0x55555555u, hi = (x >> 1) & 0x55555555u;
        const uint32_t nl = __builtin_popcount(lo);
        const uint32_t nh = __builtin_popcount(hi);
        const uint32_t nt = __builtin_popcount(lo & hi);
        row[4 + j] = x;
        acc[0] += 16u - nl - nh + nt;
        acc[1] += nl - nt;
        acc[2] += nh - nt;
        acc[3] += nt;
      }
    }
  }
}

// Batch entry point with OpenMP parallelism over reads, on
// ibwa_get_threads() threads.
void ibwa_match_gap_batch(const uint32_t* itl_fwd, uint32_t primary_fwd,
                          const uint32_t* itl_rev, uint32_t primary_rev,
                          const uint32_t* l2, uint32_t seq_len,
                          const uint8_t* seqs, const uint8_t* rseqs,
                          const int64_t* offsets, const int32_t* lens,
                          const int32_t* max_diffs,
                          const int32_t* seed_lens, const int32_t* optv,
                          int32_t n_reads, uint32_t* out, int32_t cap,
                          int32_t* out_n) {
#pragma omp parallel for schedule(dynamic, 1) num_threads(ibwa_get_threads())
  for (int32_t r = 0; r < n_reads; ++r) {
    out_n[r] = ibwa_match_gap(
        itl_fwd, primary_fwd, itl_rev, primary_rev, l2, seq_len,
        seqs + offsets[r], rseqs + offsets[r], lens[r], max_diffs[r],
        seed_lens[r], optv, out + (int64_t)r * cap * 4, cap);
  }
}

}  // extern "C"
