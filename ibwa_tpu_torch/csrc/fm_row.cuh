// Row load and masked 2-bit popcount over one row of the device FM block
// table, shared by the occ queries (occ.cu), the LF walker (lf_walk.cu) and
// the search step (search_step.cu); and the occ query itself (locate the
// row of a bound, fetch it, count a base with the sentinel / clamp / NEG1 /
// seq_len edges of bwt_occ), shared by occ.cu and search_step.cu.
//
// A row is uint32[4 + WPB]: 4 occ checkpoint words, then the 2-bit packed
// BWT text of the intv = 16 * WPB bases after the checkpoint.
//
// Where the rows are is the row source, a template parameter of the fetch
// (B8): FlatRows, the whole table as one array, or ShardRows, the table
// split by rows into contiguous ranges of `rows` rows each, every range its
// own allocation (fm/device.py::shard_pair).  ShardRows replaces
// ibwa_tpu/fm/device.py::_gather_block's sharded branch (:309-319): there
// every shard fetched the rows it owned, zeros elsewhere, and the rows were
// summed over the `idx` mesh axis; a sum of one-hot rows is the one owner's
// row, so here the fetch reads that row where it lies, bitwise the same.
//
// Peer path: a shard may live on another card.  Its base pointer is then a
// peer pointer, valid in the launching card's address space only after
// fm/device.py::enable_peer has called the extern-C entry of peer.cu (which
// raises where the cards cannot reach each other), and the load below reads
// the remote row over NVLink; there is no collective per fetch and no copy
// of the table.  A kernel reaches a shard only through its pointer in the
// IbwaShards table of its arguments, which shard_pair fills from the
// tensors it placed; nothing else in this package holds a peer address.
#ifndef IBWA_FM_ROW_CUH
#define IBWA_FM_ROW_CUH

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace ibwa_fm {

constexpr int kMaxShards = 8;

// The row ranges of a split table.  fm/device.py::Shards mirrors this
// layout field for field; n == 0 is a flat table.
struct IbwaShards {
  const uint32_t* base[kMaxShards];  // range i: rows [i * rows, (i+1) * rows)
  int64_t rows;                      // rows per range
  int n;                             // ranges in use
};

// Whether a launch's shard table can serve a table of `table_rows` rows:
// flat (n == 0), or n ranges of `rows` rows that cover them, in 32 bits,
// every base set.
inline bool shards_ok(const IbwaShards& sh, int64_t table_rows) {
  if (sh.n == 0) return true;
  if (sh.n < 0 || sh.n > kMaxShards || sh.rows <= 0 ||
      sh.rows * sh.n < table_rows || sh.rows * sh.n > 0xFFFFFFFFll)
    return false;
  for (int i = 0; i < sh.n; ++i)
    if (sh.base[i] == nullptr) return false;
  return true;
}

// The whole table as one array: row r at blocks + r * ROWW.
struct FlatRows {
  const uint32_t* blocks;
  __device__ __forceinline__ static FlatRows of(const uint32_t* blocks,
                                                const IbwaShards&) {
    return {blocks};
  }
  template <int ROWW>
  __device__ __forceinline__ const uint32_t* row(uint64_t r) const {
    return blocks + r * ROWW;
  }
};

// The table split by rows: row r is row r % rows of range r / rows.  `t`
// points into the kernel's parameter space (a __grid_constant__ argument),
// so the base pointer is read from the constant bank, with no copy of the
// arguments in local memory.  Rows fit 32 bits (2 * n_blk < 2^32).
struct ShardRows {
  const IbwaShards* t;
  uint32_t rows;
  __device__ __forceinline__ static ShardRows of(const uint32_t*,
                                                 const IbwaShards& sh) {
    return {&sh, (uint32_t)sh.rows};
  }
  template <int ROWW>
  __device__ __forceinline__ const uint32_t* row(uint64_t r) const {
    const uint32_t q = (uint32_t)r / rows;
    return t->base[q] + (uint64_t)((uint32_t)r - q * rows) * ROWW;
  }
};

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

// Where bound k is in the table: skip the sentinel row at `prim`, clamp to
// the last base and the last block.  Sets o's off / neg / full and returns
// k's block.
template <int WPB>
__device__ __forceinline__ uint32_t occ_block(uint32_t k, uint32_t prim,
                                              uint32_t seq_len,
                                              uint32_t n_blk,
                                              OccRow<WPB>& o) {
  constexpr int shift = WPB == 2 ? 5 : WPB == 4 ? 6 : 7;  // log2(intv)
  uint32_t kk = k - (k >= prim ? 1u : 0u);
  kk = min(kk, seq_len > 0 ? seq_len - 1u : 0u);
  o.off = kk & ((1u << shift) - 1u);
  o.neg = k == kNeg1;
  o.full = k == seq_len;
  return min(kk >> shift, n_blk - 1u);
}

// The address of the row of bound k on `strand` (rows of strand 1 follow
// the n_blk rows of strand 0) in the row source `src` (occ_block).
template <int WPB, class Rows>
__device__ __forceinline__ const uint32_t* locate_occ_row(
    const Rows& src, uint32_t k, uint32_t prim, uint32_t seq_len,
    uint32_t n_blk, uint32_t strand, OccRow<WPB>& o) {
  const uint32_t blk = occ_block<WPB>(k, prim, seq_len, n_blk, o);
  return src.template row<4 + WPB>((uint64_t)strand * n_blk + blk);
}

// Locate and fetch the row of bound k (locate_occ_row).  The load starts
// here and is not waited for, so a caller that fetches the two bounds of an
// interval before it counts either has both loads in flight.
template <int WPB, class Rows>
__device__ __forceinline__ void fetch_occ_row(
    const Rows& src, uint32_t k, uint32_t prim,
    uint32_t seq_len, uint32_t n_blk, uint32_t strand, OccRow<WPB>& o) {
  load_row<4 + WPB>(locate_occ_row<WPB>(src, k, prim, seq_len, n_blk,
                                        strand, o), o.r);
}

// An asynchronous copy of BYTES (4, 8 or 16, aligned so) from global to
// shared memory (cp.async: the data goes to shared memory without passing
// through registers, and the thread goes on), and the wait for every copy
// this thread started.  A host build (the CPU stand-in) copies at once.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(BYTES));
#else
  memcpy(dst, src, BYTES);
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Words of shared memory a warp needs for the two rows of an interval
// asked for ahead (prefetch_pair), at the widest rows.
constexpr int kPairWords = 2 * (4 + 8);

// Ask for the rows of the bounds k0 and k1 on `strand` into `buf`
// ([2][4 + WPB] words of shared memory, 16-byte aligned), a few threads of
// the warp each copying a 16-byte piece (8 at intv 32, whose 24 B rows are
// only 8-byte aligned); no register holds them meanwhile.  Before anything
// reads buf, every thread calls copy_async_wait() and the warp meets at a
// __syncwarp(); take_pair then reads them as fetch_occ_row would have.
template <int WPB, class Rows>
__device__ __forceinline__ void prefetch_pair(
    const Rows& src, uint32_t k0, uint32_t k1, uint32_t prim,
    uint32_t seq_len, uint32_t n_blk, uint32_t strand, uint32_t* buf,
    int lane) {
  constexpr int kRow = 4 + WPB;
  constexpr int kPiece = kRow % 4 == 0 ? 16 : 8;  // bytes a copy
  constexpr int kPieces = kRow * 4 / kPiece;      // copies a row
  if (lane < 2 * kPieces) {
    const int r = lane / kPieces, c = lane % kPieces;
    OccRow<WPB> o;
    const uint32_t* row = locate_occ_row<WPB>(src, r ? k1 : k0, prim,
                                              seq_len, n_blk, strand, o);
    copy_async<kPiece>(buf + r * kRow + c * (kPiece / 4),
                       row + c * (kPiece / 4));
  }
}

// The rows prefetch_pair copied for (k0, k1), as fetch_occ_row gives them.
template <int WPB>
__device__ __forceinline__ void take_pair(
    const uint32_t* buf, uint32_t k0, uint32_t k1, uint32_t prim,
    uint32_t seq_len, uint32_t n_blk, OccRow<WPB>& r0, OccRow<WPB>& r1) {
  constexpr int kRow = 4 + WPB;
  occ_block<WPB>(k0, prim, seq_len, n_blk, r0);
  occ_block<WPB>(k1, prim, seq_len, n_blk, r1);
#pragma unroll
  for (int i = 0; i < kRow; ++i) {
    r0.r[i] = buf[i];
    r1.r[i] = buf[kRow + i];
  }
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
