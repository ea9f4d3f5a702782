// Copy of ibwa_tpu/native/src/sais_frugal.cpp: the port keeps its own host code.
//
// Space-frugal suffix-array construction for >2 Gbp genomes.
//
// The reference reaches human scale via the bounded-memory BWT-SW
// incremental builder (bwt_gen/bwt_gen.c:1390-1528, ~2.5 GB for human,
// bwa.1:450).  The BWT of a text is unique, so any construction with a
// bounded footprint satisfies the same contract byte-for-byte.  This
// file provides SA-IS over 32-bit unsigned indexes with all heavy
// workspace inside the caller's SA buffer:
//
//   peak = 4 bytes/char (SA) + text/4 (2-bit packed) + n/8 (type bits)
//        ~ 13.3 GB for a 3.2 Gbp genome — under a 16 GB host.
//
// vs. the int64 SA-IS path (core.cpp) which needs ~8 bytes/char for SA
// alone plus O(n) auxiliary vectors (~36+ GB at 3 Gbp).
//
// Layout of the standard in-buffer recursion (Nong, Zhang & Chan; same
// family as core.cpp's sais_core, re-engineered for O(1) extra space
// beyond SA + the type bitvector):
//   step 1: induce a rough order from bucket-tail LMS placement
//   step 2: compact sorted LMS positions to sa[0..n_lms), write names
//           into sa[n_lms..n) keyed by pos/2
//   step 3: build the reduced string at the END of sa, recurse writing
//           into sa[0..n_lms)
//   step 4: rewrite sub-SA into text positions (LMS positions are
//           re-enumerated into sa[n_lms..2*n_lms) by a text scan),
//           induce the final order.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cstdio>
#include <cstdlib>

namespace {

using u32 = uint32_t;
using u64 = uint64_t;
constexpr u32 EMPTY = 0xFFFFFFFFu;

// 2-bit packed text accessor (bwa .pac layout: base i in byte i>>2,
// bits (~i&3)<<1, matching bntseq.c's pac macros)
struct PackedText {
  const uint8_t* pac;
  inline u32 operator[](u64 i) const {
    return (pac[i >> 2] >> (((~i) & 3) << 1)) & 3;
  }
};

// reversed view of a packed text (for the .rbwt index: BWT of the
// reversed genome without materializing it)
struct RevPackedText {
  const uint8_t* pac;
  u64 n;
  inline u32 operator[](u64 i) const {
    u64 j = n - 1 - i;
    return (pac[j >> 2] >> (((~j) & 3) << 1)) & 3;
  }
};

// u32 reduced-text accessor
struct U32Text {
  const u32* t;
  inline u32 operator[](u64 i) const { return t[i]; }
};

template <typename TextT>
struct Frugal {
  TextT text;
  u32 n;
  u32 K;              // alphabet size
  std::vector<bool> stype;
  std::vector<u32> bkt;  // K entries — top level K=4; recursion K<=n/2:
                         // bounded by n_lms of the parent, lives while
                         // the parent's bkt is freed (see run()).

  bool is_lms(u32 i) const { return i > 0 && stype[i] && !stype[i - 1]; }

  void classify() {
    stype.assign((size_t)n + 1, false);
    stype[n] = true;
    if (n == 0) return;
    stype[n - 1] = false;
    for (u32 i = n - 1; i-- > 0;) {
      u32 ci = text[i], cn = text[i + 1];
      stype[i] = (ci < cn) || (ci == cn && stype[i + 1]);
    }
  }

  void buckets(bool tails) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (u32 i = 0; i < n; ++i) bkt[text[i]] += 1;
    u32 sum = 0;
    for (u32 c = 0; c < K; ++c) {
      sum += bkt[c];
      bkt[c] = tails ? sum : sum - bkt[c];
    }
  }

  void induce(u32* sa) {
    buckets(false);
    if (n > 0 && !stype[n - 1]) sa[bkt[text[n - 1]]++] = n - 1;
    for (u32 i = 0; i < n; ++i) {
      u32 v = sa[i];
      if (v != EMPTY && v > 0 && !stype[v - 1]) sa[bkt[text[v - 1]]++] = v - 1;
    }
    buckets(true);
    for (u32 i = n; i-- > 0;) {
      u32 v = sa[i];
      if (v != EMPTY && v > 0 && stype[v - 1]) sa[--bkt[text[v - 1]]] = v - 1;
    }
  }

  static inline int& depth() { static int d = 0; return d; }
  void run(u32* sa) {
#ifdef FRG_DEBUG
    fprintf(stderr, "[frg] depth=%d n=%u K=%u\n", depth(), n, K);
    if (++depth() > 50) abort();
#endif

    struct DepthGuard {
#ifdef FRG_DEBUG
      ~DepthGuard() { --depth(); }
#endif
    } dg_;
    (void)dg_;
    if (n == 0) return;
    if (n == 1) {
      sa[0] = 0;
      return;
    }
#ifdef FRG_DEBUG
    if (true) {}
#endif
    classify();
    bkt.assign(K, 0);

    // step 1: rough sort
    std::fill(sa, sa + n, EMPTY);
    buckets(true);
    for (u32 i = n; i-- > 1;)
      if (is_lms(i)) sa[--bkt[text[i]]] = i;
    induce(sa);

    // step 2: compact sorted LMS, name their substrings
    u32 n_lms = 0;
    for (u32 i = 0; i < n; ++i) {
      u32 v = sa[i];
      if (v != EMPTY && is_lms(v)) sa[n_lms++] = v;
    }
    u32* names = sa + n_lms;  // indexed by pos/2; (n - n_lms) slots and
                              // pos/2 < n/2 <= n - n_lms always
    std::fill(names, sa + n, EMPTY);
    u32 n_names = 0;
    u32 prev = EMPTY;
    for (u32 k = 0; k < n_lms; ++k) {
      u32 cur = sa[k];
      bool differ = (prev == EMPTY);
      if (!differ) {
        for (u32 d = 0;; ++d) {
          bool end_p = (prev + d == n) || (d > 0 && is_lms(prev + d));
          bool end_c = (cur + d == n) || (d > 0 && is_lms(cur + d));
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
#ifdef FRG_DEBUG
      if (n_lms + cur / 2 >= n) { fprintf(stderr, "[frg] NAME OOB n=%u n_lms=%u cur=%u\n", n, n_lms, cur); abort(); }
#endif
      names[cur / 2] = n_names - 1;
    }

    // step 3: reduced problem at the tail of sa.  The name slots are
    // sparse in [n_lms, n) and can overlap the tail, so compact them
    // RIGHT-TO-LEFT (write index always >= read index) — the scattered
    // names collapse into sa[n - n_lms .. n) in text order.
    u32* reduced = sa + (n - n_lms);
    {
      u32 j = n - 1;
      for (u32 i = n; i-- > n_lms;)
        if (sa[i] != EMPTY) sa[j--] = sa[i];
#ifdef FRG_DEBUG
      if (j != n - n_lms - 1) {
        fprintf(stderr, "[frg] RED count n=%u n_lms=%u j=%u\n", n, n_lms, j);
        abort();
      }
#endif
    }
    if (n_names < n_lms) {
      // free this level's big state before recursing
      stype.clear();
      stype.shrink_to_fit();
      std::vector<u32>().swap(bkt);
      Frugal<U32Text> sub{U32Text{reduced}, n_lms, n_names, {}, {}};
      sub.run(sa);                // sub-SA in sa[0..n_lms)
      // restore this level's state
      classify();
      bkt.assign(K, 0);
    } else {
      for (u32 k = 0; k < n_lms; ++k) sa[reduced[k]] = k;
      // invert: sa[rank] = k  ->  need sa[0..n_lms) = order
      // (reduced[k] is the rank of the k-th LMS in text order)
      // after the loop above sa[rank] = k already IS the order array
    }

    // step 4: map sub-SA entries to text positions.  Enumerate LMS
    // positions in text order into sa[n_lms..2*n_lms) (2*n_lms <= n).
    u32* lms_pos = sa + n_lms;
    {
      u32 w = 0;
      for (u32 i = 1; i < n; ++i)
        if (is_lms(i)) {
#ifdef FRG_DEBUG
          if (n_lms + w >= n) { fprintf(stderr, "[frg] LMSPOS OOB n=%u n_lms=%u w=%u\n", n, n_lms, w); abort(); }
#endif
          lms_pos[w++] = i;
        }
    }
    for (u32 k = 0; k < n_lms; ++k) sa[k] = lms_pos[sa[k]];
    // clear the rest and induce from the exactly-sorted LMS suffixes
    std::fill(sa + n_lms, sa + n, EMPTY);
    buckets(true);
    // place LMS at bucket tails from the back, reading sa[0..n_lms)
    // back-to-front; move values out first to avoid overwrite hazards:
    // walk k from high to low, as targets are always >= k.
    for (u32 k = n_lms; k-- > 0;) {
      u32 j = sa[k];
      sa[k] = EMPTY;
#ifdef FRG_DEBUG
      if (j == EMPTY || j >= n) { fprintf(stderr, "[frg] PLACE OOB n=%u k=%u j=%u\n", n, k, j); abort(); }
#endif
      sa[--bkt[text[j]]] = j;
    }
    induce(sa);
  }
};

}  // namespace

extern "C" {

// Suffix array of a 2-bit packed text (bwa .pac layout), n < 2^32 - 1.
// sa must hold n u32 entries.  Returns 0 on success.
int32_t ibwa_sais_packed32(const uint8_t* pac, uint32_t* sa, uint32_t n) {
  if (!pac || !sa) return -1;
  Frugal<PackedText> f{PackedText{pac}, n, 4, {}, {}};
  f.run(sa);
  return 0;
}

// Sentinel-removed BWT from a packed text using the frugal SA-IS:
// writes the BWT as 2-bit packed codes into out_pac (ceil(n/4) bytes)
// and returns the primary index, or -1 on failure.  reverse != 0 builds
// the BWT of the REVERSED text (for .rbwt) without materializing it.
// Peak memory is the caller-provided sa buffer (4n bytes) + n/8 type
// bits.
int64_t ibwa_bwt_packed32(const uint8_t* pac, uint32_t n, uint32_t* sa,
                          uint8_t* out_pac, int32_t reverse) {
  auto emit = [&](auto text) -> int64_t {
    std::memset(out_pac, 0, ((size_t)n + 3) / 4);
    int64_t primary = 0;
    // full SA order = [empty suffix] + sa; BWT[r] = text[SA_full[r]-1],
    // with the sentinel row (SA_full[r] == 0) removed (bwtmisc.c:56-98)
    uint64_t out = 0;
    auto put = [&](uint64_t r, uint32_t c) {
      out_pac[r >> 2] |= (uint8_t)(c << (((~r) & 3) << 1));
    };
    put(out++, text[n - 1]);  // row 0: empty suffix
    for (uint32_t i = 0; i < n; ++i) {
      if (sa[i] == 0) {
        primary = (int64_t)i + 1;
        continue;
      }
      put(out++, text[sa[i] - 1]);
    }
    return primary;
  };
  if (reverse) {
    RevPackedText t{pac, n};
    Frugal<RevPackedText> f{t, n, 4, {}, {}};
    f.run(sa);
    return emit(t);
  }
  if (ibwa_sais_packed32(pac, sa, n) != 0) return -1;
  return emit(PackedText{pac});
}

}  // extern "C"
