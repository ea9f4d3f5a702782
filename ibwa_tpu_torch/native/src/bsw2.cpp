// Native BWA-SW core: the DP over (prefix-DAG of the read's BWT) x
// (prefix-trie of the genome FM-index) with the Z-best beam heuristic.
//
// Port of ibwa_tpu/bwasw/core.py (itself the byte-parity port of the
// reference's bwtsw2_core.c:429-594) — the reference runs this as
// threaded C; the Python version is kept as the test oracle.  The driver
// (chaining, extensions, CIGAR, SAM) stays in ibwa_tpu/bwasw/aux.py.
//
// Reference parity anchors:
//   bsw2_connectivity        bwtsw2_core.c:87-120
//   fill_cell                bwtsw2_core.c:401-413
//   cut_tail                 bwtsw2_core.c:122-145
//   remove_duplicate         bwtsw2_core.c:147-172
//   merge/pending machinery  bwtsw2_core.c:174-193, 546-580
//   save_hits/narrow_hits    bwtsw2_core.c:211-258
//   bsw2_resolve_duphits     bwtsw2_core.c:261-327
//   bwt_lite construction    bwt_lite.c:9-54
//
// Copy of ibwa_tpu/native/src/bsw2.cpp: the port keeps its own host code.
// What differs from the original, and nothing else:
//   * the batched seed-extension callback (ibwa_bsw2_set_extend_fn)
//     returns an int32_t status; a non-zero status fails the run
//     (ibwa_bsw2_run returns -2) instead of leaving its results at zero;
//   * the minimum batch size of the callback, the staged switch and the
//     section timers are arguments of ibwa_bsw2_run, not environment
//     variables, and the stage timers come back in its `stats` out-array
//     with per-run counts of the extension jobs by route (kBsw2Stats).

#include <time.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "lf_step.h"

namespace {

constexpr int32_t MINUS_INF = -0x3FFFFFFF;
constexpr double MASK_LEVEL = 0.90;

// ---------------------------------------------------------------------------
// genome FM-index occ4 + SA walk (interleaved layout; see core.cpp)
// ---------------------------------------------------------------------------

struct Itl {
  const uint32_t* data;
  uint32_t primary;
  uint32_t l2[5];
  uint32_t seq_len;
  uint32_t sa_intv;
  const uint32_t* sampled_sa;
};

// per-byte packed symbol counts (8 bits per channel) — the reference's
// bwt_gen_cnt_table / __occ_aux4 trick (bwt.c:36-45,153-155): one table
// lookup counts all four channels of 4 bases at once
static uint32_t kCntTbl[256];
static const bool kCntInit = [] {
  for (int b = 0; b < 256; ++b) {
    uint32_t x = 0;
    for (int j = 0; j < 4; ++j) x += 1u << (((b >> (2 * j)) & 3) * 8);
    kCntTbl[b] = x;
  }
  return true;
}();

static inline uint32_t occ_aux4(uint32_t w) {
  return kCntTbl[w & 0xff] + kCntTbl[(w >> 8) & 0xff] +
         kCntTbl[(w >> 16) & 0xff] + kCntTbl[w >> 24];
}

// packed counts of the first `nb` bases (1..16) of a text word; channel 0
// overcount of masked-out trailing bases is subtracted exactly as the
// reference does (bwt.c:188: "- (~k&15)")
static inline uint32_t occ_aux4_partial(uint32_t w, uint32_t nb) {
  if (nb < 16) w &= ~((1u << ((16 - nb) * 2)) - 1u);
  return occ_aux4(w) - (16 - nb);
}

// packed counts of the LAST ns (1..15) bases of a word (the zeroed
// prefix fields count as channel 0 and are subtracted)
static inline uint32_t occ_aux4_suffix(uint32_t w, uint32_t ns) {
  w &= (1u << (2 * ns)) - 1u;
  return occ_aux4(w) - (16 - ns);
}

static void fm_occ4(const Itl& b, uint32_t k, int64_t out[4]) {
  if (k == 0xFFFFFFFFu) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  if (k == b.seq_len) {
    for (int c = 0; c < 4; ++c) out[c] = b.l2[c + 1] - b.l2[c];
    return;
  }
  if (k >= b.primary) --k;
  const uint32_t* blk = b.data + (k / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t base0 = (k / 128) * 128;
  uint32_t full_words = (k - base0) / 16;
  if (full_words >= 4 && base0 + 128 < b.seq_len) {
    // upper half: count backward from the next block's checkpoint
    uint32_t x = 0;
    for (uint32_t j = full_words + 1; j < 8; ++j) x += occ_aux4(w[j]);
    uint32_t ns = 15 - (uint32_t)(k % 16);
    if (ns) x += occ_aux4_suffix(w[full_words], ns);
    for (int c = 0; c < 4; ++c)
      out[c] = blk[12 + c] - (int64_t)((x >> (8 * c)) & 0xff);
    return;
  }
  uint32_t x = 0;
  for (uint32_t j = 0; j < full_words; ++j) x += occ_aux4(w[j]);
  x += occ_aux4_partial(w[full_words], (uint32_t)(k % 16) + 1);
  for (int c = 0; c < 4; ++c) out[c] = blk[c] + ((x >> (8 * c)) & 0xff);
}

// paired occ4 at (k, l) sharing the block scan when both land in one
// 128-base block (the reference's bwt_2occ4 trick, bwt.c:177-214);
// results are exactly fm_occ4(k) and fm_occ4(l)
static void fm_2occ4(const Itl& b, uint32_t k, uint32_t l, int64_t ck[4],
                     int64_t cl[4]) {
  uint32_t k2 = k, l2 = l;
  if (k2 != 0xFFFFFFFFu && k2 != b.seq_len && k2 >= b.primary) --k2;
  if (l2 != 0xFFFFFFFFu && l2 != b.seq_len && l2 >= b.primary) --l2;
  if (k == 0xFFFFFFFFu || k == b.seq_len || l == 0xFFFFFFFFu ||
      l == b.seq_len || (k2 / 128) != (l2 / 128)) {
    fm_occ4(b, k, ck);
    fm_occ4(b, l, cl);
    return;
  }
  const uint32_t* blk = b.data + (k2 / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t base0 = (k2 / 128) * 128;
  uint32_t fw_k = (k2 - base0) / 16, fw_l = (l2 - base0) / 16;
  if (fw_k >= 4 && base0 + 128 < b.seq_len) {
    // both in the upper half (l2 >= k2): shared backward scan
    uint32_t x = 0, j = 7;
    for (; j > fw_l; --j) x += occ_aux4(w[j]);
    uint32_t nsl = 15 - (l2 % 16);
    uint32_t xl = x + (nsl ? occ_aux4_suffix(w[fw_l], nsl) : 0);
    for (; j > fw_k; --j) x += occ_aux4(w[j]);
    uint32_t nsk = 15 - (k2 % 16);
    uint32_t xk = x + (nsk ? occ_aux4_suffix(w[fw_k], nsk) : 0);
    for (int c = 0; c < 4; ++c) {
      ck[c] = blk[12 + c] - (int64_t)((xk >> (8 * c)) & 0xff);
      cl[c] = blk[12 + c] - (int64_t)((xl >> (8 * c)) & 0xff);
    }
    return;
  }
  uint32_t x = 0, j = 0;
  for (; j < fw_k; ++j) x += occ_aux4(w[j]);
  uint32_t xk = x + occ_aux4_partial(w[fw_k], (k2 % 16) + 1);
  for (; j < fw_l; ++j) x += occ_aux4(w[j]);
  uint32_t xl = x + occ_aux4_partial(w[fw_l], (l2 % 16) + 1);
  for (int c = 0; c < 4; ++c) {
    ck[c] = blk[c] + ((xk >> (8 * c)) & 0xff);
    cl[c] = blk[c] + ((xl >> (8 * c)) & 0xff);
  }
}

static uint32_t count_code_prefix(uint32_t word, int c, int nbases) {
  uint32_t t = word ^ (0x55555555u * (uint32_t)c);
  t = ~t;
  t &= t >> 1;
  t &= 0x55555555u;
  if (nbases < 16) t &= ~((1u << ((16 - nbases) * 2)) - 1u);
  return (uint32_t)__builtin_popcount(t);
}

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

static uint32_t fm_occ1(const Itl& b, uint32_t k, int c) {
  if (k == 0xFFFFFFFFu) return 0;
  if (k == b.seq_len) return b.l2[c + 1] - b.l2[c];
  if (k >= b.primary) --k;
  const uint32_t* blk = b.data + (k / 128) * 12;
  const uint32_t* w = blk + 4;
  uint32_t nb = (k % 128) + 1;
  if (nb > 64 && (k / 128) * 128 + 128 < b.seq_len) {
    // upper half: count backward from the next block's checkpoint
    uint32_t n = blk[12 + c];
    uint32_t ns = 128 - nb, j = 7;
    while (ns >= 32) {
      n -= ibwa_lf::cnt_suffix64(((uint64_t)w[j - 1] << 32) | w[j], c, 32);
      j -= 2;
      ns -= 32;
    }
    if (ns)
      n -= ibwa_lf::cnt_suffix64(((uint64_t)w[j - 1] << 32) | w[j], c,
                                 (int)ns);
    return n;
  }
  uint32_t n = blk[c];
  uint32_t j = 0;
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

static inline int fm_code_at(const Itl& b, uint32_t k) {
  const uint32_t* blk = b.data + (k / 128) * 12 + 4;
  uint32_t word = blk[(k % 128) / 16];
  return (int)((word >> (((~k) & 0xF) << 1)) & 3u);
}

static inline uint32_t fm_inv_psi(const Itl& b, uint32_t k) {
  return ibwa_lf::lf_step(b.data, b.primary, b.l2, b.seq_len, k);
}

static uint32_t fm_sa(const Itl& b, uint32_t k) {
  uint32_t add = 0;
  if (b.sa_intv && (b.sa_intv & (b.sa_intv - 1)) == 0) {
    const uint32_t mask = b.sa_intv - 1;
    while (k & mask) {
      ++add;
      k = fm_inv_psi(b, k);
    }
    return add + b.sampled_sa[k / b.sa_intv];
  }
  while (k % b.sa_intv != 0) {
    ++add;
    k = fm_inv_psi(b, k);
  }
  return add + b.sampled_sa[k / b.sa_intv];
}

// ---------------------------------------------------------------------------
// bwt_lite of the read (bwt_lite.c:9-54; mirror of bwasw/bwtl.py)
// ---------------------------------------------------------------------------

extern "C" int32_t ibwa_sais(const uint8_t*, int32_t*, int32_t, int32_t);

struct Bwtl {
  int32_t seq_len;
  int32_t primary;
  std::vector<int32_t> sa;        // [n+1], sa[0] = n
  std::vector<uint8_t> bwt;       // sentinel-removed, length n
  std::vector<int32_t> cum[4];    // cum[c][i] = #{j < i : bwt[j]==c}
  int64_t L2[5];

  void build(const uint8_t* seq, int32_t n) {
    seq_len = n;
    sa.assign(n + 1, 0);
    sa[0] = n;
    if (n) ibwa_sais(seq, sa.data() + 1, n, 4);
    bwt.clear();
    bwt.reserve(n);
    primary = 0;
    for (int32_t i = 0; i <= n; ++i) {
      if (sa[i] == 0) {
        primary = i;
      } else {
        bwt.push_back(seq[sa[i] - 1]);
      }
    }
    for (int c = 0; c < 4; ++c) {
      cum[c].assign(n + 1, 0);
      for (int32_t i = 0; i < n; ++i)
        cum[c][i + 1] = cum[c][i] + (bwt[i] == c ? 1 : 0);
    }
    L2[0] = 0;
    for (int c = 0; c < 4; ++c) L2[c + 1] = L2[c] + cum[c][n];
  }

  void occ4(int64_t k, int64_t out[4]) const {
    // bwtl_occ4 (bwt_lite.c:69-83); mirror of bwtl.py::occ4
    if (k == -1 || k == (int64_t)0xFFFFFFFFLL) {
      out[0] = out[1] = out[2] = out[3] = 0;
      return;
    }
    if (k >= primary) --k;
    int64_t idx = (k < seq_len - 1 ? k : seq_len - 1) + 1;
    for (int c = 0; c < 4; ++c) out[c] = cum[c][idx];
  }
};

// ---------------------------------------------------------------------------
// cells / entries (bsw2cell_t, bsw2entry_t)
// ---------------------------------------------------------------------------

struct Cell {
  // 32-bit fields as in the reference's bsw2cell_t: half the struct size
  // halves the cell-array memory traffic of the hot fill loop
  uint32_t qk = 0, ql = 0;
  int32_t I = MINUS_INF, D = MINUS_INF, G = MINUS_INF;
  int32_t pj = 0;
  int32_t qlen = 0, tlen = 0;
  int32_t ppos = -1, upos = -1;
  int32_t cpos[4] = {-1, -1, -1, -1};
};

struct Entry {
  int64_t tk = 0, tl = 0;
  std::vector<Cell> cells;
};

struct Hit {
  int64_t k = 0, l = 0;
  int32_t flag = 0, n_seeds = 0;
  int32_t len = 0;
  int64_t G = 0, G2 = 0;
  int32_t beg = 0, end = 0;
};

static void heapadjust(int i, int n, int64_t* h) {
  int64_t tmp = h[i];
  int k = (i << 1) + 1;
  while (k < n) {
    if (k != n - 1 && h[k] < h[k + 1]) ++k;
    if (h[k] < tmp) break;
    h[i] = h[k];
    i = k;
    k = (i << 1) + 1;
  }
  h[i] = tmp;
}

// cut_tail (bwtsw2_core.c:122-145)
static void cut_tail(Entry& u, int T) {
  if ((int)u.cells.size() <= T) return;
  static thread_local std::vector<int64_t> a;
  a.clear();
  for (const Cell& c : u.cells)
    if (c.ql && c.G > 0) a.push_back(-c.G);
  if ((int)a.size() <= T) return;
  // selection, not a full sort (the reference's ks_ksmall)
  std::nth_element(a.begin(), a.begin() + T, a.end());
  int64_t x = -a[T];
  int n = 0;
  for (Cell& p : u.cells) {
    if (p.G == x) ++n;
    if (p.G < x || (p.G == x && n >= T)) {
      p.qk = p.ql = 0;
      p.G = 0;
      if (p.ppos >= 0) u.cells[p.ppos].cpos[p.pj] = -1;
    }
  }
}

// Flat open-addressing uint64->uint64 hash (khash-style; the reference
// uses khash here and std::unordered_map's node allocations were ~40% of
// core time).  Key 0 is the empty sentinel — callers never insert 0.
struct FlatU64Map {
  std::vector<uint64_t> keys, vals;
  size_t mask = 0, n = 0;

  void reset(size_t expect) {
    size_t cap = 16;
    while (cap < expect * 2) cap <<= 1;
    if (cap > keys.size()) {
      keys.assign(cap, 0);
      vals.resize(cap);
    } else {
      std::fill(keys.begin(), keys.end(), 0);
    }
    mask = keys.size() - 1;
    n = 0;
  }

  static inline size_t hash(uint64_t k) {
    k ^= k >> 33;
    k *= 0xFF51AFD7ED558CCDULL;
    k ^= k >> 33;
    return (size_t)k;
  }

  // returns slot value pointer; *created = true if newly inserted
  uint64_t* get(uint64_t key, bool* created) {
    if (n * 2 >= keys.size()) grow();
    size_t i = hash(key) & mask;
    while (keys[i] != 0 && keys[i] != key) i = (i + 1) & mask;
    if (keys[i] == 0) {
      keys[i] = key;
      vals[i] = 0;
      ++n;
      *created = true;
    } else {
      *created = false;
    }
    return &vals[i];
  }

  // lookup only; nullptr if absent
  uint64_t* find(uint64_t key) {
    size_t i = hash(key) & mask;
    while (keys[i] != 0 && keys[i] != key) i = (i + 1) & mask;
    return keys[i] ? &vals[i] : nullptr;
  }

  void grow() {
    std::vector<uint64_t> ok(std::move(keys)), ov(std::move(vals));
    keys.assign(ok.size() * 2, 0);
    vals.resize(ok.size() * 2);
    mask = keys.size() - 1;
    for (size_t j = 0; j < ok.size(); ++j)
      if (ok[j]) {
        size_t i = hash(ok[j]) & mask;
        while (keys[i]) i = (i + 1) & mask;
        keys[i] = ok[j];
        vals[i] = ov[j];
      }
  }
};

// remove_duplicate (bwtsw2_core.c:147-172); value packs idx<<32 | G+2^31
static void remove_duplicate(Entry& u) {
  static thread_local FlatU64Map seen;
  seen.reset(u.cells.size());
  for (int i = 0; i < (int)u.cells.size(); ++i) {
    Cell& p = u.cells[i];
    if (p.ql == 0) continue;
    uint64_t key = ((uint64_t)p.qk << 32) | (uint64_t)p.ql;
    int j = -1;
    bool created;
    uint64_t* v = seen.get(key, &created);
    uint64_t packed =
        ((uint64_t)(uint32_t)i << 32) |
        (uint64_t)(uint32_t)((int64_t)p.G + 0x80000000LL);
    if (!created) {
      int64_t seen_g = (int64_t)(uint32_t)*v - 0x80000000LL;
      if (seen_g >= p.G) {
        j = i;
      } else {
        j = (int)(*v >> 32);
        *v = packed;
      }
    } else {
      *v = packed;
    }
    if (j >= 0) {
      Cell& p2 = u.cells[j];
      p2.qk = p2.ql = 0;
      p2.G = 0;
      if (p2.ppos >= 0) u.cells[p2.ppos].cpos[p2.pj] = -3;
    }
  }
}

// merge_entry (bwtsw2_core.c:174-193)
static void merge_entry(Entry& u, Entry& v) {
  int off = (int)u.cells.size();
  for (Cell& p : v.cells) {
    if (p.ppos >= 0) p.ppos += off;
    for (int t = 0; t < 4; ++t)
      if (p.cpos[t] >= 0) p.cpos[t] += off;
  }
  u.cells.insert(u.cells.end(), v.cells.begin(), v.cells.end());
  v.cells.clear();
}

// save_hits (bwtsw2_core.c:211-233): 2 slots per read position
static void save_hits(const Bwtl& bwt, int64_t thres, std::vector<Hit>& hits,
                      const Entry& u) {
  for (const Cell& p : u.cells) {
    if (p.G < thres) continue;
    for (int64_t k = u.tk; k <= u.tl; ++k) {
      int32_t beg = bwt.sa[k];
      int32_t end = beg + p.tlen;
      Hit* q = nullptr;
      if (p.G > hits[beg * 2].G) {
        hits[beg * 2 + 1] = hits[beg * 2];
        q = &hits[beg * 2];
      } else if (p.G > hits[beg * 2 + 1].G) {
        q = &hits[beg * 2 + 1];
      }
      if (q) {
        q->k = p.qk;
        q->l = p.ql;
        q->len = p.qlen;
        q->G = p.G;
        q->beg = beg;
        q->end = end;
        q->G2 = (q->k == q->l) ? 0 : q->G;
        q->flag = q->n_seeds = 0;
      }
    }
  }
}

// save_narrow_hits (bwtsw2_core.c:236-258)
static void save_narrow_hits(const Bwtl& bwtl, Entry& u,
                             std::vector<Hit>& b1, int64_t t, int64_t IS) {
  for (Cell& p : u.cells) {
    if (p.G >= t && (int64_t)p.ql - p.qk + 1 <= IS) {
      Hit h;
      h.k = p.qk;
      h.l = p.ql;
      h.len = p.qlen;
      h.G = p.G;
      h.G2 = 0;
      h.beg = bwtl.sa[u.tk];
      h.end = h.beg + p.tlen;
      h.flag = 0;
      b1.push_back(h);
      p.qk = p.ql = 0;
      p.G = 0;
      if (p.ppos >= 0) u.cells[p.ppos].cpos[p.pj] = -3;
    }
  }
}

// bsw2_resolve_duphits (bwtsw2_core.c:261-327); fm == nullptr skips the
// SA expansion (mirror of core.py::resolve_duphits)
static void resolve_duphits(const Itl* fm, std::vector<Hit>& hits,
                            int64_t IS) {
  if (hits.empty()) return;
  if (fm) {
    std::vector<Hit> nh;
    for (const Hit& p : hits) {
      if (p.l - p.k + 1 <= IS) {
        for (int64_t k = p.k; k <= p.l; ++k) {
          Hit q = p;
          q.k = fm_sa(*fm, (uint32_t)k);
          q.l = 0;
          nh.push_back(q);
        }
      } else if (p.G > 0) {
        Hit q = p;
        q.k = fm_sa(*fm, (uint32_t)p.k);
        q.l = 0;
        q.flag |= 1;
        nh.push_back(q);
      }
    }
    hits.swap(nh);
  }
  std::stable_sort(hits.begin(), hits.end(),
                   [](const Hit& a, const Hit& b) { return a.G > b.G; });
  int n = (int)hits.size();
  int cut = n;
  bool broke = false;
  for (int i = 1; i < n; ++i) {
    Hit& p = hits[i];
    if (p.G == 0) {
      cut = i;
      broke = true;
      break;
    }
    for (int j = 0; j < i; ++j) {
      const Hit& q = hits[j];
      bool compatible = true;
      if (q.G == 0) continue;
      if (p.l == 0 && q.l == 0) {
        int64_t qol = std::min<int64_t>(p.end, q.end) -
                      std::max<int64_t>(p.beg, q.beg);
        if (qol < 0) qol = 0;
        if ((double)qol / (p.end - p.beg) > MASK_LEVEL ||
            (double)qol / (q.end - q.beg) > MASK_LEVEL) {
          int64_t tol = std::min(p.k + p.len, q.k + q.len) -
                        std::max(p.k, q.k);
          if ((double)tol / p.len > MASK_LEVEL ||
              (double)tol / q.len > MASK_LEVEL)
            compatible = false;
        }
      }
      if (!compatible) {
        p.G = 0;
        break;
      }
    }
  }
  if (!broke) cut = n;
  std::vector<Hit> out;
  for (int i = 0; i < cut; ++i)
    if (hits[i].G != 0) out.push_back(hits[i]);
  hits.swap(out);
}

// ---------------------------------------------------------------------------
// bsw2_core (bwtsw2_core.c:429-594; mirror of core.py::bsw2_core)
// ---------------------------------------------------------------------------

struct Opt {
  int64_t a, b, q, r, t, bw, z, IS;
  int64_t qr() const { return q + r; }
};

// entry pool (mirrors the reference's mempool, bwtsw2_core.c:58-84):
// recycled entries keep their cells vector CAPACITY, so the steady state
// runs allocation-free
struct EntryPool {
  std::vector<Entry*> free_, all_;
  Entry* alloc() {
    if (free_.empty()) {
      Entry* e = new Entry();
      all_.push_back(e);
      return e;
    }
    Entry* e = free_.back();
    free_.pop_back();
    e->cells.clear();
    return e;
  }
  void put(Entry* e) { free_.push_back(e); }
  ~EntryPool() {
    for (Entry* e : all_) delete e;
  }
};

static double g_c_pre = 0, g_c_fill = 0, g_c_save = 0, g_c_child = 0;
static double bsw_now2();
// section timers are compiled in but only sampled when ibwa_bsw2_run's
// `profile` argument asks for them
static bool g_bsw_prof = false;
static bool bsw_prof() { return g_bsw_prof; }

static void bsw2_core(const Opt& opt, const Bwtl& target, const Itl& query,
                      std::vector<Hit>& b, std::vector<Hit>& b1,
                      EntryPool& pool) {
  double tpre = bsw_prof() ? bsw_now2() : 0;
  // connectivity prepass (bwtsw2_core.c:87-120)
  static thread_local FlatU64Map chash;
  chash.reset((size_t)target.seq_len * 2 + 16);
  {
    std::vector<std::pair<int64_t, int64_t>> stack;
    stack.push_back({0, target.seq_len});
    while (!stack.empty()) {
      auto [k0, l0] = stack.back();
      stack.pop_back();
      int64_t cntk[4], cntl[4];
      target.occ4(k0 - 1, cntk);
      target.occ4(l0, cntl);
      for (int j = 0; j < 4; ++j) {
        int64_t k = target.L2[j] + cntk[j] + 1;
        int64_t l = target.L2[j] + cntl[j];
        if (k > l) continue;
        uint64_t key = ((uint64_t)k << 32) | (uint64_t)l;
        bool created;
        uint64_t* slot = chash.get(key, &created);
        if (created) {
          *slot = 1;
          stack.push_back({k, l});
        } else {
          *slot += 1;
        }
      }
    }
  }

  if (bsw_prof()) g_c_pre += bsw_now2() - tpre;
  int32_t score_mat[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      score_mat[i][j] = (i == j) ? opt.a : -opt.b;
  int heap_size = (int)opt.z;
  std::vector<int64_t> heap(heap_size);

  b.assign((size_t)target.seq_len * 2, Hit());
  b1.clear();
  std::vector<Entry*> pending;
  std::vector<Entry*> stack0;

  Entry* root = pool.alloc();
  root->tk = 0;
  root->tl = target.seq_len;
  {
    Cell x0;
    x0.G = 0;
    x0.qk = 0;
    x0.ql = query.seq_len;
    root->cells.push_back(x0);
  }
  stack0.push_back(root);
  int64_t n_pending = 0;

  while (!stack0.empty() || n_pending) {
    Entry* v = stack0.back();
    stack0.pop_back();
    int old_n = (int)v->cells.size();

    for (Cell& p : v->cells) {  // band-width test
      if (p.ql == 0) continue;
      if (p.tlen - p.qlen > opt.bw || p.qlen - p.tlen > opt.bw) {
        p.qk = p.ql = 0;
        if (p.ppos >= 0) v->cells[p.ppos].cpos[p.pj] = -5;
      }
    }

    int64_t tcntk[4], tcntl[4];
    target.occ4(v->tk - 1, tcntk);
    target.occ4(v->tl, tcntl);
    for (int tj = 0; tj < 4; ++tj) {
      int64_t k = target.L2[tj] + tcntk[tj] + 1;
      int64_t l = target.L2[tj] + tcntl[tj];
      if (k > l) continue;
      uint64_t key = ((uint64_t)k << 32) | (uint64_t)l;
      uint64_t& slot = *chash.find(key);
      slot -= 1;
      uint32_t cnt = (uint32_t)(slot & 0xFFFFFFFFu);
      Entry* u = pool.alloc();
      u->tk = k;
      u->tl = l;
      std::fill(heap.begin(), heap.end(), 0);
      const int32_t* csm = score_mat[tj];

      double tfill = bsw_prof() ? bsw_now2() : 0;
      u->cells.reserve(v->cells.size());
      for (int i = 0; i < (int)v->cells.size(); ++i) {
        // NOTE: v->cells grows during this loop (the qj section), so the
        // data pointer is re-cached per iteration and re-fetched after
        // every push; within an iteration `p` stays valid until then.
        Cell* vc = v->cells.data();
        Cell& p = vc[i];
        bool is_added = false;
        if (p.ql == 0) continue;
        int64_t xG = MINUS_INF;
        p.upos = -1;
        if (p.ppos >= 0) {  // parent has been visited
          Cell& par = vc[p.ppos];
          Cell* c1 = (par.upos >= 0) ? &u->cells[par.upos] : nullptr;
          // fill_cell (bwtsw2_core.c:401-413)
          int64_t G = par.G + csm[p.pj];
          int32_t xI;
          if (c1) {
            xI = (c1->I > c1->G - opt.q) ? c1->I - opt.r
                                         : c1->G - opt.qr();
            if (xI > G) G = xI;
          } else {
            xI = MINUS_INF;
          }
          int32_t xD = (p.D > p.G - opt.q) ? p.D - opt.r : p.G - opt.qr();
          if (xD > G) G = xD;
          xG = G;
          if (G > 0) {
            int32_t xppos = par.upos;
            p.upos = (int)u->cells.size();
            u->cells.emplace_back();
            Cell& xs = u->cells.back();   // fresh slot, default cpos=-1
            xs.I = xI;
            xs.D = xD;
            xs.G = (int32_t)G;
            xs.ppos = xppos;
            xs.upos = -1;
            if (xppos >= 0) u->cells[xppos].cpos[p.pj] = p.upos;
            is_added = true;
          }
        } else {
          int32_t xD = (p.D > p.G - opt.q) ? p.D - opt.r : p.G - opt.qr();
          if (xD > 0) {
            xG = xD;
            p.upos = (int)u->cells.size();
            u->cells.emplace_back();
            Cell& xs = u->cells.back();
            xs.I = MINUS_INF;
            xs.D = xD;
            xs.G = xD;
            xs.ppos = -1;
            xs.upos = -1;
            is_added = true;
          }
        }
        if (is_added) {
          Cell& xs = u->cells.back();
          xs.pj = p.pj;
          xs.qk = p.qk;
          xs.ql = p.ql;
          xs.qlen = p.qlen;
          xs.tlen = p.tlen + 1;
          if (xs.G > -heap[0]) {
            heap[0] = -xs.G;
            heapadjust(0, heap_size, heap.data());
          }
        }
        if ((xG > opt.qr() && xG >= -heap[0]) || i < old_n) {
          if (p.cpos[0] == -1 || p.cpos[1] == -1 || p.cpos[2] == -1 ||
              p.cpos[3] == -1) {
            int64_t qcntk[4], qcntl[4];
            fm_2occ4(query, (uint32_t)(p.qk - 1), (uint32_t)p.ql,
                     qcntk, qcntl);
            for (int qj = 0; qj < 4; ++qj) {
              if (v->cells[i].cpos[qj] != -1) continue;
              int64_t k2 = (int64_t)query.l2[qj] + qcntk[qj] + 1;
              int64_t l2 = (int64_t)query.l2[qj] + qcntl[qj];
              if (k2 > l2) {
                v->cells[i].cpos[qj] = -2;
                continue;
              }
              int32_t at = (int)v->cells.size();
              v->cells.emplace_back();
              Cell& y = v->cells.back();  // fresh slot, default fields
              Cell& p2 = v->cells[i];     // re-fetch: emplace may realloc
              y.qk = (uint32_t)k2;
              y.ql = (uint32_t)l2;
              y.pj = qj;
              y.qlen = p2.qlen + 1;
              y.ppos = i;
              y.tlen = p2.tlen;
              p2.cpos[qj] = at;
            }
          }
        }
      }

      if (bsw_prof()) {
        double now = bsw_now2();
        g_c_fill += now - tfill;
        if (!u->cells.empty()) save_hits(target, opt.t, b, *u);
        g_c_save += bsw_now2() - now;
      } else if (!u->cells.empty()) {
        save_hits(target, opt.t, b, *u);
      }
      // push u to stack0 or pending (bwtsw2_core.c:546-580)
      uint64_t full = *chash.find(key);
      uint64_t pos = full >> 32;
      if (pos) {
        Entry* w = pending[pos - 1];
        if (!u->cells.empty()) {
          if (w->cells.size() < u->cells.size()) {
            std::swap(pending[pos - 1], u);
            w = pending[pos - 1];
          }
          merge_entry(*w, *u);
        }
        if (cnt == 0) {
          remove_duplicate(*w);
          save_narrow_hits(target, *w, b1, opt.t, opt.IS);
          cut_tail(*w, (int)opt.z);
          stack0.push_back(w);
          pending[pos - 1] = nullptr;
          n_pending -= 1;
        }
        pool.put(u);
      } else if (cnt) {
        if (!u->cells.empty()) {
          n_pending += 1;
          pending.push_back(u);
          *chash.find(key) = ((uint64_t)pending.size() << 32) | cnt;
        } else {
          pool.put(u);
        }
      } else {
        save_narrow_hits(target, *u, b1, opt.t, opt.IS);
        cut_tail(*u, (int)opt.z);
        stack0.push_back(u);
      }
    }
    pool.put(v);
  }
  for (Entry* e : pending)
    if (e) pool.put(e);

  resolve_duphits(&query, b, opt.IS);
  resolve_duphits(&query, b1, opt.IS);
}

}  // namespace

// ---------------------------------------------------------------------------
// Native per-read driver: the bwtsw2_aux.c pipeline (chain filter,
// extensions, CIGAR, fix_cigar, SAM emission).  Semantic source of truth
// is ibwa_tpu/bwasw/aux.py (kept as the IBWA_PURE_PY oracle); reference
// lines cited per function.  Python list.sort is stable, so every sort
// here is std::stable_sort to keep tie order identical to the oracle.
// ---------------------------------------------------------------------------

extern "C" int32_t ibwa_extend_aln(const uint8_t*, int32_t, const uint8_t*,
                                   int32_t, int32_t, int32_t, int32_t,
                                   const int32_t*, int32_t, int32_t,
                                   int32_t*);
extern "C" int32_t ibwa_global_aln(const uint8_t*, int32_t, const uint8_t*,
                                   int32_t, int32_t, int32_t, int32_t,
                                   int32_t, const int32_t*, int32_t,
                                   uint32_t*, int32_t, int32_t*);

namespace {

struct BswOpt {
  int a, b, q, r, t, bw, z, is_, t_seeds, hard_clip;
  double mask_level, coef;
};

struct BswCtx {
  Itl fm[2];                 // 0 = fwd, 1 = rev
  const uint8_t* pac;        // packed 2-bit .pac bytes
  int64_t l_pac;
  int32_t n_seqs;
  const int64_t* ann_off;
  const int64_t* ann_len;
  const uint8_t* name_blob;
  const int64_t* name_off;
  int64_t n_holes;
  const int64_t* amb_off;
  const int64_t* amb_len;
  std::string buf;
};

inline int pac_base(const uint8_t* pac, int64_t p) {
  return (pac[p >> 2] >> ((~p & 3) << 1)) & 3;
}

// drand48 (rng.py semantics: step then X / 2^48)
inline double bsw_drand48(uint64_t* x) {
  *x = (0x5DEECE66DULL * *x + 0xBULL) & 0xFFFFFFFFFFFFULL;
  return (double)*x / 9007199254740992.0 * 32.0;  // 2^53 / 32 == 2^48
}

struct HL {
  std::vector<Hit> hits;
  std::vector<std::vector<uint32_t>> cigars;  // len<<4|op (samtools enc)
  std::vector<uint8_t> has_cig;
};

// stage timers, returned in ibwa_bsw2_run's `stats`
static double g_t_core = 0, g_t_ext = 0, g_t_cig = 0, g_t_other = 0;
static double bsw_now2() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
static double bsw_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// chaining (bwtsw2_chain.c:16-42); z entries are (tbeg,tend,qbeg,qend,
// flag,idx,chain)
struct Chain {
  int64_t tbeg, tend, qbeg, qend;
  int32_t flag, idx, chain;
};

static std::vector<Chain> bsw_chaining(const BswOpt& opt, int shift,
                                       std::vector<Chain>& z) {
  std::stable_sort(z.begin(), z.end(),
                   [](const Chain& a, const Chain& b) {
                     return a.qbeg < b.qbeg;
                   });
  std::vector<Chain> chains;
  for (Chain& p : z) {
    int k = (int)chains.size() - 1;
    for (; k >= 0; --k) {
      Chain& q = chains[k];
      int64_t x = p.qbeg - q.qbeg;
      int64_t y = p.tbeg - q.tbeg;
      if (y > 0 && x - y <= opt.bw && y - x <= opt.bw) {
        if (p.qend > q.qend) q.qend = p.qend;
        if (p.tend > q.tend) q.tend = p.tend;
        q.chain += 1;
        p.chain = shift + k;
        break;
      }
    }
    if (k < 0) {
      Chain c = p;
      c.chain = 1;
      c.idx = shift + (int)chains.size();
      p.chain = shift + (int)chains.size();
      chains.push_back(c);
    }
  }
  return chains;
}

// bsw2_chain_filter (bwtsw2_chain.c:44-107)
static void bsw_chain_filter(const BswOpt& opt, int64_t length, HL* b0,
                             HL* b1) {
  HL* b[2] = {b0, b1};
  std::vector<Chain> z[2];
  for (int k = 0; k < 2; ++k)
    for (size_t i = 0; i < b[k]->hits.size(); ++i) {
      const Hit& p = b[k]->hits[i];
      z[k].push_back(Chain{p.k, p.k + p.len, p.beg, p.end, k, (int32_t)i,
                           -1});
    }
  std::vector<Chain> chains0 = bsw_chaining(opt, 0, z[0]);
  std::vector<Chain> chains1 =
      bsw_chaining(opt, (int)chains0.size(), z[1]);
  for (Chain& p : chains1) {
    int64_t tmp = p.qbeg;
    p.qbeg = length - p.qend;
    p.qend = length - tmp;
  }
  std::vector<Chain> allc = chains0;
  allc.insert(allc.end(), chains1.begin(), chains1.end());
  std::vector<uint8_t> flag(allc.size(), 0);
  std::vector<Chain> order = allc;
  std::stable_sort(order.begin(), order.end(),
                   [](const Chain& a, const Chain& b) {
                     return a.qbeg < b.qbeg;
                   });
  for (size_t k = 1; k < order.size(); ++k) {
    const Chain& p = order[k];
    for (size_t j = 0; j < k; ++j) {
      const Chain& q = order[j];
      if (flag[q.idx]) continue;
      if (q.qend >= p.qend &&
          q.chain > (int64_t)p.chain * opt.t_seeds * 2) {
        flag[p.idx] = 1;
        break;
      }
    }
  }
  for (int k = 0; k < 2; ++k) {
    for (const Chain& p : z[k])
      if (flag[p.chain]) b[p.flag]->hits[p.idx].G = 0;
    std::vector<Hit> kept;
    for (const Hit& h : b[k]->hits)
      if (h.G) kept.push_back(h);
    b[k]->hits.swap(kept);
  }
}

// ---------------------------------------------------------------------------
// Batched seed extensions.  Collect/apply split so the staged driver can
// fan a whole read chunk's jobs into ONE device dispatch; apply replays
// the reference's sequential skip/containment logic exactly against the
// precomputed per-hit results (an extension's INPUTS are the hit's own
// pre-extension fields, so speculative precomputation is value-exact;
// results of contained hits are simply discarded).  With no batch fn
// registered (ibwa_bsw2_set_extend_fn) the host scalar loop runs — the
// original code path, bit for bit.
// ---------------------------------------------------------------------------

typedef int32_t (*ibwa_ext_batch_fn)(
    int32_t n, const uint8_t* tgt_blob, const int64_t* tgt_off,
    const uint8_t* qry_blob, const int64_t* qry_off, const int32_t* g0,
    const int32_t* band, int32_t gap_open, int32_t gap_ext,
    const int32_t* matrix, int32_t* out_meta);
static ibwa_ext_batch_fn g_ext_fn = nullptr;
// below this many jobs a device round trip costs more than it saves
// (ibwa_bsw2_run's `ext_min`)
static int g_ext_dev_min = 64;
// a callback returned non-zero: the run fails, no later batch runs
static bool g_ext_failed = false;
// per-run extension counts and times (ibwa_bsw2_run's `stats`): jobs,
// jobs handed to the callback, non-empty jobs the host loop ran (no
// callback, or a batch under the minimum), empty jobs (either route),
// batches of each route, seconds in the callback and in the host loop
static double g_x_jobs = 0, g_x_cb_jobs = 0, g_x_host_jobs = 0,
              g_x_empty = 0, g_x_cb_batches = 0, g_x_host_batches = 0,
              g_x_cb_s = 0, g_x_host_s = 0;

struct ExtBatch {
  int32_t q, r;
  const int32_t* matrix;
  std::vector<uint8_t> tgt_blob, qry_blob;
  std::vector<int64_t> tgt_off{0}, qry_off{0};
  std::vector<int32_t> g0, band;
  std::vector<int32_t> out;  // [n, 3] after run()

  ExtBatch(int32_t q_, int32_t r_, const int32_t* m) : q(q_), r(r_),
                                                       matrix(m) {}
  size_t size() const { return g0.size(); }

  int32_t add(const uint8_t* tgt, int64_t nt, const uint8_t* qry,
              int64_t nq, int32_t g0v, int32_t bandv) {
    tgt_blob.insert(tgt_blob.end(), tgt, tgt + nt);
    qry_blob.insert(qry_blob.end(), qry, qry + nq);
    tgt_off.push_back((int64_t)tgt_blob.size());
    qry_off.push_back((int64_t)qry_blob.size());
    g0.push_back(g0v);
    band.push_back(bandv);
    return (int32_t)g0.size() - 1;
  }

  void run() {
    size_t n = size();
    out.assign(3 * n, 0);
    if (!n || g_ext_failed) return;
    size_t empty = 0;
    for (size_t i = 0; i < n; ++i)
      empty += tgt_off[i + 1] == tgt_off[i] || qry_off[i + 1] == qry_off[i];
    g_x_jobs += n;
    g_x_empty += empty;
    double t0 = bsw_now();
    if (g_ext_fn && (int)n >= g_ext_dev_min) {
      if (g_ext_fn((int32_t)n, tgt_blob.data(), tgt_off.data(),
                   qry_blob.data(), qry_off.data(), g0.data(), band.data(),
                   q, r, matrix, out.data()) != 0)
        g_ext_failed = true;
      g_x_cb_jobs += n;
      g_x_cb_batches += 1;
      g_x_cb_s += bsw_now() - t0;
      return;
    }
    for (size_t i = 0; i < n; ++i)
      ibwa_extend_aln(tgt_blob.data() + tgt_off[i],
                      (int32_t)(tgt_off[i + 1] - tgt_off[i]),
                      qry_blob.data() + qry_off[i],
                      (int32_t)(qry_off[i + 1] - qry_off[i]),
                      q, r, band[i], matrix, 5, g0[i], &out[3 * i]);
    g_x_host_jobs += n - empty;
    g_x_host_batches += 1;
    g_x_host_s += bsw_now() - t0;
  }
};

// bsw2_extend_left (bwtsw2_aux.c:80-129) split: collect sorts the hits
// and extracts every candidate's target window + reversed-query slice
// from the hit's PRE-extension fields; apply replays the containment
// scan (which reads earlier hits' post-extension fields) and applies
// the precomputed result for non-contained candidates.
static void bsw_extend_left_collect(const BswCtx& ctx, const BswOpt& opt,
                                    HL& b, const uint8_t* query,
                                    int64_t lq, bool is_rev,
                                    std::vector<uint8_t>& rquery,
                                    ExtBatch& eb,
                                    std::vector<int32_t>& jid) {
  std::stable_sort(b.hits.begin(), b.hits.end(),
                   [](const Hit& a, const Hit& c) { return a.end > c.end; });
  rquery.assign(query, query + lq);
  std::reverse(rquery.begin(), rquery.end());
  int64_t l_pac = ctx.l_pac;
  jid.assign(b.hits.size(), -1);
  std::vector<uint8_t> target;
  for (size_t i = 0; i < b.hits.size(); ++i) {
    Hit& p = b.hits[i];
    if (p.l || p.k == 0) continue;
    int64_t lt = ((p.beg + 1) / 2 * opt.a + opt.r) / opt.r + lq;
    if (lt > p.k) lt = p.k;
    // bases p.k-1 down to (exclusive) max(p.k-1-lt, 0): index 0 is never
    // included (the reference's FIXME, bwtsw2_aux.c:103)
    int64_t lo = p.k - 1 - lt;
    if (lo < 0) lo = 0;
    int64_t n = p.k - 1 - lo;
    target.resize(n);
    if (is_rev)
      for (int64_t j = 0; j < n; ++j)
        target[j] = pac_base(ctx.pac, l_pac - 1 - (p.k - 1 - j));
    else
      for (int64_t j = 0; j < n; ++j)
        target[j] = pac_base(ctx.pac, p.k - 1 - j);
    jid[i] = eb.add(target.data(), n, rquery.data() + (lq - p.beg),
                    p.beg, (int32_t)p.G, opt.bw);
  }
}

static void bsw_extend_left_apply(HL& b, const ExtBatch& eb,
                                  const std::vector<int32_t>& jid) {
  for (size_t i = 0; i < b.hits.size(); ++i) {
    Hit& p = b.hits[i];
    p.n_seeds = 1;
    if (p.l || p.k == 0) continue;
    int score = 0;
    for (size_t j = 0; j < i; ++j) {
      Hit& q = b.hits[j];
      if (q.beg <= p.beg && q.k <= p.k && q.k + q.len >= p.k + p.len) {
        if (q.n_seeds < (1 << 14) - 2) q.n_seeds += 1;
        ++score;
      }
    }
    if (score) continue;
    const int32_t* meta = &eb.out[3 * jid[i]];
    if (meta[0] > p.G) {
      p.G = meta[0];
      p.len += meta[1];
      p.beg -= meta[2];
      p.k -= meta[1];
    }
  }
}

static void bsw_extend_rght_collect(const BswCtx& ctx, const BswOpt& opt,
                                    HL& b, const uint8_t* query,
                                    int64_t lq, bool is_rev, ExtBatch& eb,
                                    std::vector<int32_t>& jid) {
  int64_t l_pac = ctx.l_pac;
  jid.assign(b.hits.size(), -1);
  std::vector<uint8_t> target;
  for (size_t i = 0; i < b.hits.size(); ++i) {
    Hit& p = b.hits[i];
    if (p.l) continue;
    int64_t lt = ((lq - p.beg + 1) / 2 * opt.a + opt.r) / opt.r + lq;
    int64_t hi = p.k + lt;
    if (hi > l_pac) hi = l_pac;
    int64_t n = hi - p.k;
    if (n < 0) n = 0;
    target.resize(n);
    if (is_rev)
      for (int64_t j = 0; j < n; ++j)
        target[j] = pac_base(ctx.pac, l_pac - 1 - (p.k + j));
    else
      for (int64_t j = 0; j < n; ++j)
        target[j] = pac_base(ctx.pac, p.k + j);
    jid[i] = eb.add(target.data(), n, query + p.beg, lq - p.beg, 1,
                    opt.bw);
  }
}

static void bsw_extend_rght_apply(HL& b, const ExtBatch& eb,
                                  const std::vector<int32_t>& jid) {
  for (size_t i = 0; i < b.hits.size(); ++i) {
    Hit& p = b.hits[i];
    if (p.l) continue;
    const int32_t* meta = &eb.out[3 * jid[i]];
    if (meta[0] >= p.G) {
      p.G = meta[0];
      p.len = meta[1];
      p.end = meta[2] + p.beg;
    }
  }
}

// bsw2_extend_left (bwtsw2_aux.c:80-129); pac access goes through the
// packed accessor, reversed-pac indexing mirrors aux.py::extend_left
static void bsw_extend_left(const BswCtx& ctx, const BswOpt& opt, HL& b,
                            const uint8_t* query, int64_t lq, bool is_rev,
                            const int32_t* matrix,
                            std::vector<uint8_t>& rquery,
                            std::vector<uint8_t>& target) {
  ExtBatch eb(opt.q, opt.r, matrix);
  std::vector<int32_t> jid;
  bsw_extend_left_collect(ctx, opt, b, query, lq, is_rev, rquery, eb, jid);
  (void)target;
  eb.run();
  bsw_extend_left_apply(b, eb, jid);
}

// bsw2_extend_rght (bwtsw2_aux.c:131-164)
static void bsw_extend_rght(const BswCtx& ctx, const BswOpt& opt, HL& b,
                            const uint8_t* query, int64_t lq, bool is_rev,
                            const int32_t* matrix,
                            std::vector<uint8_t>& target) {
  ExtBatch eb(opt.q, opt.r, matrix);
  std::vector<int32_t> jid;
  bsw_extend_rght_collect(ctx, opt, b, query, lq, is_rev, eb, jid);
  (void)target;
  eb.run();
  bsw_extend_rght_apply(b, eb, jid);
}

// merge_hits (bwtsw2_aux.c:231-252)
static void bsw_merge_hits(HL& b0, HL& b1, int64_t length,
                           bool is_reverse) {
  for (Hit& p : b1.hits) {
    if (is_reverse) {
      int64_t x = p.beg;
      p.beg = length - p.end;
      p.end = length - x;
      p.flag |= 0x10;
    }
    b0.hits.push_back(p);
  }
  b1.hits.clear();
}

static void hl_from_vec(std::vector<Hit>& v, HL& out) {
  out.hits.swap(v);
  out.cigars.clear();
  out.has_cig.clear();
}

// bsw2_resolve_query_overlaps (bwtsw2_core.c:329-378)
static void bsw_resolve_query_overlaps(HL& b, double mask_level,
                                       uint64_t* rng) {
  size_t n = b.hits.size();
  if (!n) return;
  std::stable_sort(b.hits.begin(), b.hits.end(),
                   [](const Hit& a, const Hit& c) { return a.G > c.G; });
  int64_t G0 = b.hits[0].G;
  size_t i = 1;
  while (i < n && b.hits[i].G == G0) ++i;
  size_t j = (size_t)(i * bsw_drand48(rng));
  if (j) std::swap(b.hits[0], b.hits[j]);
  size_t cut = n;
  for (i = 1; i < n; ++i) {
    Hit& p = b.hits[i];
    bool all_compatible = true;
    if (p.G == 0) {
      cut = i;
      break;
    }
    for (size_t k = 0; k < i; ++k) {
      Hit& q = b.hits[k];
      if (q.G == 0) continue;
      int64_t tol = 0;
      int64_t qol = std::min(p.end, q.end) - std::max(p.beg, q.beg);
      if (qol < 0) qol = 0;
      if (p.l == 0 && q.l == 0) {
        tol = std::min(p.k + p.len, q.k + q.len) - std::max(p.k, q.k);
        if (tol < 0) tol = 0;
      }
      double fol =
          (double)qol / (double)std::min(p.end - p.beg, q.end - q.beg);
      bool compatible = fol < mask_level ||
                        (tol > 0 && qol < p.end - p.beg &&
                         qol < q.end - q.beg);
      if (!compatible) {
        if (q.G2 < p.G) q.G2 = p.G;
        all_compatible = false;
      }
    }
    if (!all_compatible) p.G = 0;
  }
  std::vector<Hit> kept;
  for (size_t k = 0; k < cut; ++k)
    if (b.hits[k].G != 0) kept.push_back(b.hits[k]);
  b.hits.swap(kept);
}

// bsw2_aln1_core (bwtsw2_aux.c:252-276)
static void bsw_resolve_query_overlaps(HL& b, double mask_level,
                                       uint64_t* rng);
static void bsw_aln1_core(BswCtx& ctx, const BswOpt& opt, int64_t length,
                          const uint8_t* seq0, const uint8_t* seq1,
                          bool is_rev, const int32_t* matrix,
                          EntryPool& pool, uint64_t* rng, HL& out) {
  const Itl& target_fm = ctx.fm[is_rev ? 1 : 0];
  Opt copt{opt.a, opt.b, opt.q, opt.r, opt.t, opt.bw, opt.z, opt.is_};
  HL bb[2][2];
  const uint8_t* seqs[2] = {seq0, seq1};
  double tt = bsw_now();
  for (int k = 0; k < 2; ++k) {
    Bwtl bwtl;
    bwtl.build(seqs[k], (int32_t)length);
    std::vector<Hit> b, b1;
    bsw2_core(copt, bwtl, target_fm, b, b1, pool);
    hl_from_vec(b, bb[k][0]);
    hl_from_vec(b1, bb[k][1]);
  }
  g_t_core += bsw_now() - tt;
  bsw_chain_filter(opt, length, &bb[0][1], &bb[1][1]);
  std::vector<uint8_t> rq_scratch, tgt_scratch;
  HL* b[2];
  tt = bsw_now();
  for (int k = 0; k < 2; ++k) {
    bsw_extend_left(ctx, opt, bb[k][1], seqs[k], length, is_rev, matrix,
                    rq_scratch, tgt_scratch);
    bsw_merge_hits(bb[k][0], bb[k][1], length, false);
    resolve_duphits(nullptr, bb[k][0].hits, 0);
    bsw_extend_rght(ctx, opt, bb[k][0], seqs[k], length, is_rev, matrix,
                    tgt_scratch);
    b[k] = &bb[k][0];
  }
  g_t_ext += bsw_now() - tt;
  bsw_merge_hits(*b[0], *b[1], length, true);
  bsw_resolve_query_overlaps(*b[0], opt.mask_level, rng);
  out.hits.swap(b[0]->hits);
  out.cigars.clear();
  out.has_cig.clear();
}

// flag_fr (bwtsw2_aux.c:279-300)
static void bsw_flag_fr(HL& b0, HL& b1) {
  for (Hit& p : b0.hits) p.flag |= 0x10000;
  for (Hit& p : b1.hits) p.flag |= 0x20000;
  for (Hit& p : b0.hits)
    for (Hit& q : b1.hits)
      if (q.beg == p.beg && q.end == p.end && q.k == p.k &&
          q.len == p.len && q.G == p.G) {
        q.flag |= 0x30000;
        p.flag |= 0x30000;
        break;
      }
}

// gen_cigar (bwtsw2_aux.c:167-216); cigars stored len<<4|op
static void bsw_gen_cigar(const BswCtx& ctx, const BswOpt& opt, int64_t lq,
                          const uint8_t* seq0, const uint8_t* seq1, HL& b,
                          const int32_t* matrix) {
  b.cigars.assign(b.hits.size(), {});
  b.has_cig.assign(b.hits.size(), 0);
  std::vector<uint8_t> target;
  std::vector<uint32_t> cig_bwa;
  for (size_t i = 0; i < b.hits.size(); ++i) {
    Hit& p = b.hits[i];
    if (p.l) continue;
    int64_t beg = (p.flag & 0x10) ? lq - p.end : p.beg;
    int64_t end = (p.flag & 0x10) ? lq - p.beg : p.end;
    const uint8_t* query = ((p.flag & 0x10) ? seq1 : seq0) + beg;
    int64_t n = p.len;
    target.resize(n);
    for (int64_t j = 0; j < n; ++j)
      target[j] = pac_base(ctx.pac, p.k + j);
    cig_bwa.resize(n + (end - beg) + 2);
    int32_t score = 0;
    int32_t nc = ibwa_global_aln(target.data(), (int32_t)n, query,
                                 (int32_t)(end - beg), opt.q, opt.r, opt.r,
                                 opt.bw, matrix, 5, cig_bwa.data(),
                                 (int32_t)cig_bwa.size(), &score);
    std::vector<uint32_t>& cigar = b.cigars[i];
    cigar.clear();
    for (int32_t j = 0; j < nc; ++j) {
      uint32_t c = cig_bwa[j];
      cigar.push_back(((c & 0x1FFFFFFF) << 4) | (c >> 29));
    }
    if (beg != 0 || end < lq) {
      if (beg != 0)
        cigar.insert(cigar.begin(), (uint32_t)(beg << 4 | 4));
      if (end < lq) cigar.push_back((uint32_t)((lq - end) << 4 | 4));
    }
    b.has_cig[i] = 1;
  }
}

// bns_seq_for_pos (bntseq.c:278-294)
static int32_t bsw_seq_for_pos(const BswCtx& ctx, int64_t pac_coor) {
  int32_t left = 0, mid = 0, right = ctx.n_seqs;
  while (left < right) {
    mid = (left + right) >> 1;
    if (pac_coor >= ctx.ann_off[mid]) {
      if (mid == ctx.n_seqs - 1) break;
      if (pac_coor < ctx.ann_off[mid + 1]) break;
      left = mid + 1;
    } else {
      right = mid;
    }
  }
  return mid;
}

// bns_coor_pac2real (bntseq.c:296-318)
static void bsw_coor_pac2real(const BswCtx& ctx, int64_t pac_coor,
                              int64_t length, int64_t* nn_out,
                              int32_t* seqid_out) {
  int32_t seqid = bsw_seq_for_pos(ctx, pac_coor);
  int64_t left = 0, right = ctx.n_holes, nn = 0;
  while (left < right) {
    int64_t mid = (left + right) >> 1;
    int64_t ho = ctx.amb_off[mid], hl = ctx.amb_len[mid];
    if (pac_coor >= ho + hl) {
      left = mid + 1;
    } else if (pac_coor + length <= ho) {
      right = mid;
    } else {
      if (pac_coor >= ho)
        nn += (ho + hl < pac_coor + length) ? ho + hl - pac_coor : length;
      else
        nn += (ho + hl < pac_coor + length) ? hl
                                            : length - (ho - pac_coor);
      break;
    }
  }
  *nn_out = nn;
  *seqid_out = seqid;
}

// fix_cigar (bwtsw2_aux.c:316-386)
static std::vector<uint32_t> bsw_fix_cigar(const BswCtx& ctx, Hit& p,
                                           const std::vector<uint32_t>&
                                               cigar) {
  int32_t seqid = bsw_seq_for_pos(ctx, p.k);
  int64_t coor = p.k - ctx.ann_off[seqid];
  int64_t refl = ctx.ann_len[seqid];
  int64_t x = coor, y = 0;
  for (uint32_t c : cigar) {
    int op = c & 0xF;
    int64_t ln = c >> 4;
    if (op == 1 || op == 4 || op == 5)
      y += ln;
    else if (op == 2)
      x += ln;
    else {
      x += ln;
      y += ln;
    }
  }
  int64_t lq = y;
  if (x <= refl) return cigar;
  size_t nc = 0;
  int64_t mq[2] = {0, 0}, nlen[2] = {0, 0}, kk = 0;
  std::vector<uint32_t> cn;
  x = coor;
  y = 0;
  for (uint32_t c : cigar) {
    int op = c & 0xF;
    int64_t ln = c >> 4;
    if (op == 4 || op == 5 || op == 1) {
      y += ln;
      cn.push_back(c);
    } else if (op == 2) {
      if (x + ln >= refl && nc == 0) {
        cn.push_back((uint32_t)((lq - y) << 4 | 4));
        nc = cn.size();
        cn.push_back((uint32_t)(y << 4 | 4));
        kk = p.k + (x + ln - refl);
        nlen[0] = x - coor;
        nlen[1] = p.len - nlen[0] - ln;
      } else {
        cn.push_back(c);
      }
      x += ln;
    } else if (op == 0) {
      if (x + ln >= refl && nc == 0) {
        cn.push_back((uint32_t)((refl - x) << 4 | 0));
        cn.push_back((uint32_t)((lq - y - (refl - x)) << 4 | 4));
        nc = cn.size();
        cn.push_back((uint32_t)((y + (refl - x)) << 4 | 4));
        if (x + ln - refl)
          cn.push_back((uint32_t)((x + ln - refl) << 4 | 0));
        mq[1] += x + ln - refl;
        kk = ctx.ann_off[seqid] + refl;
        nlen[0] = refl - coor;
        nlen[1] = p.len - nlen[0];
        mq[0] += refl - x;
      } else {
        cn.push_back(c);
        mq[nc ? 1 : 0] += ln;
      }
      x += ln;
      y += ln;
    }
  }
  if (mq[0] > mq[1]) {
    p.len = nlen[0];
    return std::vector<uint32_t>(cn.begin(), cn.begin() + nc);
  }
  p.k = kk;
  p.len = nlen[1];
  return std::vector<uint32_t>(cn.begin() + nc, cn.end());
}

inline void bsw_put_i64(std::string& out, int64_t v) {
  char tmp[24];
  int n = 0;
  bool neg = v < 0;
  uint64_t uv = neg ? (uint64_t)(-v) : (uint64_t)v;
  if (!uv) tmp[n++] = '0';
  while (uv) {
    tmp[n++] = (char)('0' + uv % 10);
    uv /= 10;
  }
  if (neg) out.push_back('-');
  for (int i = n - 1; i >= 0; --i) out.push_back(tmp[i]);
}

inline char bsw_comp_char(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case 'N': return 'N';
    case 'a': return 't';
    case 'c': return 'g';
    case 'g': return 'c';
    case 't': return 'a';
    case 'n': return 'n';
    default: return 'N';
  }
}

// print_hits (bwtsw2_aux.c:390-455)
static void bsw_print_hits(BswCtx& ctx, const BswOpt& opt,
                           const char* name, int64_t name_len,
                           const char* seq_str, int64_t L,
                           const char* qual, int64_t qual_len, HL* b) {
  std::string& out = ctx.buf;
  if (b == nullptr || b->hits.empty()) {
    out.append(name, name_len);
    out.append("\t4\t*\t0\t0\t*\t*\t0\t0\t");
    out.append(seq_str, L);
    if (qual_len) {
      out.push_back('\t');
      out.append(qual, qual_len);
    } else {
      out.append("\t*");
    }
    out.push_back('\n');
    return;
  }
  for (size_t i = 0; i < b->hits.size(); ++i) {
    Hit& p = b->hits[i];
    int32_t seqid = -1;
    int64_t coor = -1, nn = 0;
    if (p.l == 0) {
      b->cigars[i] = bsw_fix_cigar(ctx, p, b->cigars[i]);
      bsw_coor_pac2real(ctx, p.k, p.len, &nn, &seqid);
      coor = p.k - ctx.ann_off[seqid];
    }
    const std::vector<uint32_t>& cigar = b->cigars[i];
    out.append(name, name_len);
    out.push_back('\t');
    bsw_put_i64(out, p.flag & 0x10);
    out.push_back('\t');
    if (seqid >= 0)
      out.append((const char*)ctx.name_blob + ctx.name_off[seqid],
                 (size_t)(ctx.name_off[seqid + 1] - ctx.name_off[seqid]));
    else
      out.push_back('*');
    out.push_back('\t');
    bsw_put_i64(out, coor + 1);
    if (p.l == 0) {
      double c = 1.0;
      int64_t subo = p.G2 > opt.t ? p.G2 : opt.t;
      int fr = (int)(p.flag >> 16);
      if (fr == 1 || fr == 2) c *= 0.5;
      if (p.n_seeds < 2) c *= 0.2;
      int64_t qv = (int64_t)(c * (double)(p.G - subo) *
                                 (250.0 / (double)p.G + 0.03 / opt.a) +
                             0.499);
      if (qv > 250) qv = 250;
      if (p.flag & 1) qv = 0;
      out.push_back('\t');
      bsw_put_i64(out, qv);
      out.push_back('\t');
      const char* ops = opt.hard_clip ? "MIDNHHP" : "MIDNSHP";
      for (uint32_t c2 : cigar) {
        bsw_put_i64(out, c2 >> 4);
        out.push_back(ops[c2 & 0xF]);
      }
    } else {
      out.append("\t0\t*");
    }
    out.append("\t*\t0\t0\t");
    int64_t beg = 0, end = L;
    if (opt.hard_clip && !cigar.empty()) {
      if ((cigar.front() & 0xF) == 4) beg += cigar.front() >> 4;
      if ((cigar.back() & 0xF) == 4) end -= cigar.back() >> 4;
    }
    if (p.flag & 0x10)
      for (int64_t j = beg; j < end; ++j)
        out.push_back(bsw_comp_char(seq_str[L - 1 - j]));
    else
      out.append(seq_str + beg, (size_t)(end - beg));
    if (qual_len) {
      out.push_back('\t');
      if (p.flag & 0x10)
        for (int64_t j = beg; j < end; ++j)
          out.push_back(qual[L - 1 - j]);
      else
        out.append(qual + beg, (size_t)(end - beg));
    } else {
      out.append("\t*");
    }
    out.append("\tAS:i:");
    bsw_put_i64(out, p.G);
    out.append("\tXS:i:");
    bsw_put_i64(out, p.G2);
    out.append("\tXF:i:");
    bsw_put_i64(out, p.flag >> 16);
    out.append("\tXE:i:");
    bsw_put_i64(out, p.n_seeds);
    out.append("\tXN:i:");
    bsw_put_i64(out, nn);
    if (p.l) {
      out.append("\tXI:i:");
      bsw_put_i64(out, p.l - p.k + 1);
    }
    out.push_back('\n');
  }
}

// nst_nt4_table (bntseq.c:39)
static const uint8_t kNt4[256] = {
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 5,
    4, 4, 0, 1, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 0, 4, 1, 4,
    4, 4, 2, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 0, 4, 1, 4, 4, 4, 2, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 3,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4};

// __gen_ap (bwtsw2_aux.c:70-77)
static void bsw_gen_matrix(const BswOpt& opt, int32_t* m) {
  for (int i = 0; i < 25; ++i) m[i] = -opt.b;
  for (int i = 0; i < 4; ++i) m[i * 5 + i] = opt.a;
}

// floor division matching Python // for possibly-negative numerators
inline int64_t bsw_floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// bsw2_aln_core body for one read (bwtsw2_aux.c:459-545 — the per-read
// slice of the chunked pipeline; aux.py::bsw2_aln_one is the oracle)
static void bsw_aln_one(BswCtx& ctx, const BswOpt& opt0, const char* name,
                        int64_t name_len, const char* seq_str, int64_t l,
                        const char* qual, int64_t qual_len, uint64_t* rng,
                        EntryPool& pool) {
  BswOpt opt = opt0;
  if ((double)opt.t < std::log((double)l) * opt.coef)
    opt.t = (int)(std::log((double)l) * opt.coef + 0.499);
  int64_t k = bsw_floordiv(l * opt.a - 2 * opt.q, 2 * opt.r + opt.a);
  int64_t i = bsw_floordiv(l * opt.a - opt.a - opt.t, opt.r);
  if (k > i) k = i;
  if (k < 1) k = 1;
  opt.bw = (int)std::min((int64_t)opt0.bw, k);

  std::vector<uint8_t> codes(l);
  int64_t n_amb = 0;
  for (int64_t j = 0; j < l; ++j) {
    uint8_t c = kNt4[(uint8_t)seq_str[j]];
    if (c >= 4) {
      c = (uint8_t)(int)(bsw_drand48(rng) * 4);
      ++n_amb;
    }
    codes[j] = c;
  }
  if (l - n_amb < opt.t) {
    bsw_print_hits(ctx, opt, name, name_len, seq_str, l, qual, qual_len,
                   nullptr);
    return;
  }
  // seq[0] = codes, seq[1] = revcomp; rseq[0] = reversed, rseq[1] = comp
  std::vector<uint8_t> seq1(l), rseq0(l), rseq1(l);
  for (int64_t j = 0; j < l; ++j) {
    seq1[j] = (uint8_t)(3 - codes[l - 1 - j]);
    rseq0[j] = codes[l - 1 - j];
    rseq1[j] = (uint8_t)(3 - codes[j]);
  }
  int32_t matrix[25];
  bsw_gen_matrix(opt, matrix);
  HL b0;
  bsw_aln1_core(ctx, opt, l, codes.data(), seq1.data(), false, matrix,
                pool, rng, b0);
  bool need_rev = false;
  for (const Hit& h : b0.hits)
    if (h.n_seeds < opt.t_seeds) {
      need_rev = true;
      break;
    }
  if (need_rev) {
    HL b1;
    bsw_aln1_core(ctx, opt, l, rseq0.data(), rseq1.data(), true, matrix,
                  pool, rng, b1);
    for (Hit& p : b1.hits) {
      int64_t x = p.beg;
      p.beg = l - p.end;
      p.end = l - x;
      if (p.l == 0) p.k = ctx.l_pac - (p.k + p.len);
    }
    bsw_flag_fr(b0, b1);
    bsw_merge_hits(b0, b1, l, false);
    resolve_duphits(nullptr, b0.hits, 0);
    bsw_resolve_query_overlaps(b0, opt.mask_level, rng);
  }
  double tt = bsw_now();
  bsw_gen_cigar(ctx, opt, l, codes.data(), seq1.data(), b0, matrix);
  g_t_cig += bsw_now() - tt;
  bsw_print_hits(ctx, opt, name, name_len, seq_str, l, qual, qual_len,
                 &b0);
}

// ---------------------------------------------------------------------------
// Staged driver: runs a chunk of ambiguity-free reads through the same
// per-read pipeline as bsw_aln_one, but with the seed extensions of the
// WHOLE chunk batched into two ExtBatch rounds (left, then right) so a
// registered device fn gets thousands of lanes per dispatch instead of
// a handful per read.  drand48 parity: the only draws are N-base fills
// (zero here by the amb-free precondition) and the resolve passes,
// which run strictly in read order in stage E — the stream is identical
// to the sequential path.  Reads needing the reverse orientation
// (need_rev, rng-dependent) run the full bsw_aln1_core inline in stage
// E; its small per-read extension batches fall below the minimum batch
// size (ext_min) and stay on the host.
// ---------------------------------------------------------------------------

struct ReadStage {
  BswOpt opt;
  const char* name;
  int64_t name_len;
  const char* seq_str;
  int64_t l;
  const char* qual;
  int64_t qual_len;
  std::vector<uint8_t> codes, seq1;
  int32_t matrix[25];
  HL bb[2][2];
  std::vector<uint8_t> rquery[2];
  std::vector<int32_t> jl[2], jr[2];
  bool done = false;  // too short: print an unmapped record in stage G
};

static void bsw_run_staged(BswCtx& ctx, const BswOpt& opt0, int32_t n,
                           const uint8_t* seq_blob, const int64_t* seq_off,
                           const uint8_t* qual_blob, const int64_t* qual_off,
                           const uint8_t* name_blob, const int64_t* name_off,
                           int32_t i0, uint64_t* rng, EntryPool& pool) {
  std::vector<ReadStage> rs(n);
  // every read in the chunk shares opt0's scoring, so one q/r/matrix set
  // serves both batches (per-read opt only adjusts t and bw)
  bsw_gen_matrix(opt0, rs[0].matrix);
  ExtBatch eb_l(opt0.q, opt0.r, rs[0].matrix);
  ExtBatch eb_r(opt0.q, opt0.r, rs[0].matrix);

  double tt = bsw_now();
  for (int32_t x = 0; x < n; ++x) {  // ---- stage A: core + left collect
    ReadStage& s = rs[x];
    int32_t i = i0 + x;
    s.name = (const char*)name_blob + name_off[i];
    s.name_len = name_off[i + 1] - name_off[i];
    s.seq_str = (const char*)seq_blob + seq_off[i];
    s.l = seq_off[i + 1] - seq_off[i];
    s.qual = (const char*)qual_blob + qual_off[i];
    s.qual_len = qual_off[i + 1] - qual_off[i];
    s.opt = opt0;
    if ((double)s.opt.t < std::log((double)s.l) * s.opt.coef)
      s.opt.t = (int)(std::log((double)s.l) * s.opt.coef + 0.499);
    int64_t k = bsw_floordiv(s.l * s.opt.a - 2 * s.opt.q,
                             2 * s.opt.r + s.opt.a);
    int64_t lim = bsw_floordiv(s.l * s.opt.a - s.opt.a - s.opt.t,
                               s.opt.r);
    if (k > lim) k = lim;
    if (k < 1) k = 1;
    s.opt.bw = (int)std::min((int64_t)opt0.bw, k);
    s.codes.resize(s.l);
    for (int64_t j = 0; j < s.l; ++j)
      s.codes[j] = kNt4[(uint8_t)s.seq_str[j]];  // caller ensures < 4
    if (s.l < s.opt.t) {  // n_amb == 0 by precondition
      s.done = true;
      continue;
    }
    s.seq1.resize(s.l);
    for (int64_t j = 0; j < s.l; ++j)
      s.seq1[j] = (uint8_t)(3 - s.codes[s.l - 1 - j]);
    bsw_gen_matrix(s.opt, s.matrix);
    const uint8_t* seqs[2] = {s.codes.data(), s.seq1.data()};
    Opt copt{s.opt.a, s.opt.b, s.opt.q, s.opt.r, s.opt.t, s.opt.bw,
             s.opt.z, s.opt.is_};
    for (int kk = 0; kk < 2; ++kk) {
      Bwtl bwtl;
      bwtl.build(seqs[kk], (int32_t)s.l);
      std::vector<Hit> b, b1;
      bsw2_core(copt, bwtl, ctx.fm[0], b, b1, pool);
      hl_from_vec(b, s.bb[kk][0]);
      hl_from_vec(b1, s.bb[kk][1]);
    }
    bsw_chain_filter(s.opt, s.l, &s.bb[0][1], &s.bb[1][1]);
    for (int kk = 0; kk < 2; ++kk)
      bsw_extend_left_collect(ctx, s.opt, s.bb[kk][1], seqs[kk], s.l,
                              false, s.rquery[kk], eb_l, s.jl[kk]);
  }
  g_t_core += bsw_now() - tt;

  tt = bsw_now();
  eb_l.run();  // ---- stage B: one batched left-extension round

  for (int32_t x = 0; x < n; ++x) {  // ---- stage C: apply + right collect
    ReadStage& s = rs[x];
    if (s.done) continue;
    const uint8_t* seqs[2] = {s.codes.data(), s.seq1.data()};
    for (int kk = 0; kk < 2; ++kk) {
      bsw_extend_left_apply(s.bb[kk][1], eb_l, s.jl[kk]);
      bsw_merge_hits(s.bb[kk][0], s.bb[kk][1], s.l, false);
      resolve_duphits(nullptr, s.bb[kk][0].hits, 0);
      bsw_extend_rght_collect(ctx, s.opt, s.bb[kk][0], seqs[kk], s.l,
                              false, eb_r, s.jr[kk]);
    }
  }

  eb_r.run();  // ---- stage D: one batched right-extension round
  g_t_ext += bsw_now() - tt;

  for (int32_t x = 0; x < n; ++x) {  // ---- stage E..G: rng + cigar + print
    ReadStage& s = rs[x];
    if (s.done) {
      bsw_print_hits(ctx, s.opt, s.name, s.name_len, s.seq_str, s.l,
                     s.qual, s.qual_len, nullptr);
      continue;
    }
    for (int kk = 0; kk < 2; ++kk)
      bsw_extend_rght_apply(s.bb[kk][0], eb_r, s.jr[kk]);
    HL& b0 = s.bb[0][0];
    bsw_merge_hits(b0, s.bb[1][0], s.l, true);
    bsw_resolve_query_overlaps(b0, s.opt.mask_level, rng);

    bool need_rev = false;
    for (const Hit& h : b0.hits)
      if (h.n_seeds < s.opt.t_seeds) {
        need_rev = true;
        break;
      }
    if (need_rev) {
      std::vector<uint8_t> rseq0(s.l), rseq1(s.l);
      for (int64_t j = 0; j < s.l; ++j) {
        rseq0[j] = s.codes[s.l - 1 - j];
        rseq1[j] = (uint8_t)(3 - s.codes[j]);
      }
      HL b1;
      bsw_aln1_core(ctx, s.opt, s.l, rseq0.data(), rseq1.data(), true,
                    s.matrix, pool, rng, b1);
      for (Hit& p : b1.hits) {
        int64_t x2 = p.beg;
        p.beg = s.l - p.end;
        p.end = s.l - x2;
        if (p.l == 0) p.k = ctx.l_pac - (p.k + p.len);
      }
      bsw_flag_fr(b0, b1);
      bsw_merge_hits(b0, b1, s.l, false);
      resolve_duphits(nullptr, b0.hits, 0);
      bsw_resolve_query_overlaps(b0, s.opt.mask_level, rng);
    }
    double tc = bsw_now();
    bsw_gen_cigar(ctx, s.opt, s.l, s.codes.data(), s.seq1.data(), b0,
                  s.matrix);
    g_t_cig += bsw_now() - tc;
    bsw_print_hits(ctx, s.opt, s.name, s.name_len, s.seq_str, s.l,
                   s.qual, s.qual_len, &b0);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// the length of ibwa_bsw2_run's `stats`
constexpr int kBsw2Stats = 15;

// Runs bwtl construction + bsw2_core + duphit resolution for one read
// strand.  Hit fields are written as 9 x int64 per hit:
//   k, l, flag, n_seeds, len, G, G2, beg, end
// Returns 0 on success, -1 if either list exceeds `cap`.
int32_t ibwa_bsw2_core(
    const uint32_t* itl, uint32_t primary, const uint32_t* l2,
    uint32_t seq_len, uint32_t sa_intv, const uint32_t* sampled_sa,
    const uint8_t* seq, int32_t len,
    int64_t a, int64_t bmm, int64_t q, int64_t r, int64_t t, int64_t bw,
    int64_t z, int64_t IS,
    int64_t* out_b, int32_t* n_b, int64_t* out_b1, int32_t* n_b1,
    int32_t cap) {
  Itl query{itl, primary, {l2[0], l2[1], l2[2], l2[3], l2[4]}, seq_len,
            sa_intv, sampled_sa};
  Bwtl target;
  target.build(seq, len);
  Opt opt{a, bmm, q, r, t, bw, z, IS};
  std::vector<Hit> b, b1;
  static thread_local EntryPool pool;
  bsw2_core(opt, target, query, b, b1, pool);
  if ((int32_t)b.size() > cap || (int32_t)b1.size() > cap) return -1;
  auto emit = [](const std::vector<Hit>& hs, int64_t* out) {
    for (size_t i = 0; i < hs.size(); ++i) {
      const Hit& h = hs[i];
      int64_t* o = out + i * 9;
      o[0] = h.k;
      o[1] = h.l;
      o[2] = h.flag;
      o[3] = h.n_seeds;
      o[4] = h.len;
      o[5] = h.G;
      o[6] = h.G2;
      o[7] = h.beg;
      o[8] = h.end;
    }
  };
  emit(b, out_b);
  emit(b1, out_b1);
  *n_b = (int32_t)b.size();
  *n_b1 = (int32_t)b1.size();
  return 0;
}

// Full per-read bwasw driver context (bsw2_aln minus read IO).  All
// arrays stay owned by the caller for the context lifetime.
void* ibwa_bsw2_new_ctx(
    const uint32_t* itl_f, uint32_t primary_f, const uint32_t* itl_r,
    uint32_t primary_r, const uint32_t* l2, uint32_t seq_len,
    uint32_t sa_intv, const uint32_t* sa_f, const uint32_t* sa_r,
    const uint8_t* pac_packed, int64_t l_pac, int32_t n_seqs,
    const int64_t* ann_off, const int64_t* ann_len,
    const uint8_t* name_blob, const int64_t* name_off, int64_t n_holes,
    const int64_t* amb_off, const int64_t* amb_len) {
  BswCtx* ctx = new BswCtx();
  ctx->fm[0] = Itl{itl_f, primary_f, {l2[0], l2[1], l2[2], l2[3], l2[4]},
                   seq_len, sa_intv, sa_f};
  ctx->fm[1] = Itl{itl_r, primary_r, {l2[0], l2[1], l2[2], l2[3], l2[4]},
                   seq_len, sa_intv, sa_r};
  ctx->pac = pac_packed;
  ctx->l_pac = l_pac;
  ctx->n_seqs = n_seqs;
  ctx->ann_off = ann_off;
  ctx->ann_len = ann_len;
  ctx->name_blob = name_blob;
  ctx->name_off = name_off;
  ctx->n_holes = n_holes;
  ctx->amb_off = amb_off;
  ctx->amb_len = amb_len;
  return ctx;
}

void ibwa_bsw2_free_ctx(void* pctx) { delete (BswCtx*)pctx; }

// Aligns a batch of reads; seq/qual/name are raw ASCII blobs with
// int64[n+1] offsets (qual span 0 => no quality string).  rng_state is
// the 48-bit drand48 state, advanced in read order.  ext_min: the least
// jobs an extension batch hands to the registered callback (smaller ones
// run the host loop); staged != 0 batches a segment's extensions (the
// default of the original), 0 runs every read sequentially; profile != 0
// samples the core's section timers.  stats (kBsw2Stats doubles, or
// NULL) gets this run's: seconds of core, extensions, CIGAR, all, the
// core's pre / fill / save sections; then the extension jobs, the jobs
// handed to the callback, the non-empty jobs of the host loop, the empty
// jobs, the batches of the callback and of the host loop, and the
// seconds in the callback and in the host loop.  Returns the SAM text
// length (fetch via ibwa_bsw2_text), or -2 if a callback failed.
int64_t ibwa_bsw2_run(void* pctx, int32_t n_reads, const uint8_t* seq_blob,
                      const int64_t* seq_off, const uint8_t* qual_blob,
                      const int64_t* qual_off, const uint8_t* name_blob,
                      const int64_t* name_off, uint64_t* rng_state,
                      int32_t a, int32_t b, int32_t q, int32_t r,
                      int32_t t, int32_t bw, int32_t z, int32_t is_,
                      int32_t t_seeds, int32_t hard_clip,
                      double mask_level, double coef, int32_t ext_min,
                      int32_t staged, int32_t profile, double* stats) {
  BswCtx* ctx = (BswCtx*)pctx;
  BswOpt opt{a, b, q, r, t, bw, z, is_, t_seeds, hard_clip, mask_level,
             coef};
  ctx->buf.clear();
  uint64_t rng = *rng_state;
  static thread_local EntryPool pool;
  g_ext_dev_min = ext_min;
  g_bsw_prof = profile != 0;
  g_ext_failed = false;
  g_t_core = g_t_ext = g_t_cig = g_t_other = 0;
  g_c_pre = g_c_fill = g_c_save = g_c_child = 0;
  g_x_jobs = g_x_cb_jobs = g_x_host_jobs = g_x_empty = 0;
  g_x_cb_batches = g_x_host_batches = g_x_cb_s = g_x_host_s = 0;
  double t_all = bsw_now();
  auto has_amb = [&](int32_t i) {
    for (int64_t j = seq_off[i]; j < seq_off[i + 1]; ++j)
      if (kNt4[seq_blob[j]] >= 4) return true;
    return false;
  };
  const int32_t SEG_MAX = 1024;
  int32_t i = 0;
  while (i < n_reads && !g_ext_failed) {
    if (!staged || has_amb(i)) {
      // N bases consume drand48 draws inside the per-read loop; such
      // reads run the sequential path so the stream order is exact
      bsw_aln_one(*ctx, opt, (const char*)name_blob + name_off[i],
                  name_off[i + 1] - name_off[i],
                  (const char*)seq_blob + seq_off[i],
                  seq_off[i + 1] - seq_off[i],
                  (const char*)qual_blob + qual_off[i],
                  qual_off[i + 1] - qual_off[i], &rng, pool);
      ++i;
      continue;
    }
    int32_t j = i + 1;
    while (j < n_reads && j - i < SEG_MAX && !has_amb(j)) ++j;
    bsw_run_staged(*ctx, opt, j - i, seq_blob, seq_off, qual_blob,
                   qual_off, name_blob, name_off, i, &rng, pool);
    i = j;
  }
  g_t_other += bsw_now() - t_all;
  *rng_state = rng;
  if (stats) {
    const double v[kBsw2Stats] = {
        g_t_core, g_t_ext, g_t_cig, g_t_other, g_c_pre, g_c_fill, g_c_save,
        g_x_jobs, g_x_cb_jobs, g_x_host_jobs, g_x_empty, g_x_cb_batches,
        g_x_host_batches, g_x_cb_s, g_x_host_s};
    std::copy(v, v + kBsw2Stats, stats);
  }
  if (g_ext_failed) return -2;
  return (int64_t)ctx->buf.size();
}

const char* ibwa_bsw2_text(void* pctx) {
  return ((BswCtx*)pctx)->buf.data();
}

// Register a batched seed-extension backend (the device DP engine,
// ibwa_tpu_torch/ops/dp.py via bwasw/dp_glue.py); NULL restores the host
// scalar loop.  The fn sees (n, tgt blob+offsets, qry blob+offsets, g0,
// band, gap_open, gap_ext, matrix[25], out int32[n,3]) and returns 0, or
// non-zero if it failed (the run then returns -2).
void ibwa_bsw2_set_extend_fn(void* fn) {
  g_ext_fn = (ibwa_ext_batch_fn)fn;
}

}  // extern "C"
