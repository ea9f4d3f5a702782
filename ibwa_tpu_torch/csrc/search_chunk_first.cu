// K8's first version, kept only to be timed beside the redesign
// (search_chunk.cu), as extend_dp_first.cu is kept beside extend_dp.cu.
// Nothing on a path of the package launches it; engine.py::
// _launch_search_chunk_first is its wrapper, for the measurement alone.
//
// What it is: the whole chunk search in one launch, lane b taking reads
// b, b + B, b + 2B, ... (B = the launch's lane count, the phased loop's),
// its clock `t` reproducing the phased loop's step count; the step with
// every thread holding all ten children (10-wide register arrays, a serial
// rank loop) and stack_commit taking them from those arrays; 184 registers
// a thread, two blocks of four warps an SM (PERF.md).  The code is the
// first version's search_step.cuh, stack_commit.cuh and search_chunk.cu
// as they stood, in a namespace of its own; the index, the row fetch and a
// read's start are the shared fm_row.cuh and lane_switch.cuh, and the
// search configuration the shared IbwaSearchCfg.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_row.cuh"
#include "lane_switch.cuh"
#include "search_step.cuh"

struct IbwaChunkFirstArgs {
  // outputs, one row per read, zero on entry
  int64_t* out_hm;
  int64_t* out_hk;
  int64_t* out_hl;
  int64_t* out_nh;
  bool* out_fb;
  unsigned long long* counters;  // [5]: {N, 0, 0, 0, 0} on entry
  // per read: length, diff budget, flags, and the width pass's planes
  const int64_t* read_lens;
  const int64_t* read_max_diff;
  const bool* read_has_seed;
  const bool* read_bad;
  int64_t* big_w;
  int64_t* big_bid;
  int64_t* big_meta;
  IbwaSearchCfg c;
  int64_t t_end;
  int B, N, switch_k;
  long long* prof;  // mode 2: [B, kStages] clocks
};

namespace ibwa_first {

using namespace ibwa_fm;

constexpr int kNch = 10;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

struct Children {
  unsigned valid;  // bit j: child j is pushed
  int ofs[kNch];   // exclusive push rank
  int32_t key[kNch];
  uint32_t k[kNch], l[kNch], m1[kNch], m2[kNch];
};

struct Pop {  // the next step's pop; the same in every thread on return
  int slot;
  int32_t key;
  uint32_t k, l, m1, m2;
};

struct Pushed {
  bool ovf;   // a valid child found no free slot
  int count;  // valid children that fit
};

constexpr int kGroup = 8;  // chunks of 32 slots taken together

// All 32 threads of the warp call this together.  `slot0` is freed when
// `act`.  sk/sl/sm1/sm2 point at the lane's rows of the payload planes.
// `used` is the number of leading groups of the row that may hold entries
// (every slot from used * 256 on is free): children fill the lowest free
// slots, so a search keeps its entries at the low end of the row, and a
// row of several groups (ACAP 1,024) is passed over only as far as its
// entries and the children reach.  Pass the row's group count for a row of
// unknown content; on return it is the count for the updated row.
__device__ __forceinline__ Pushed stack_commit(
    int lane, bool act, int64_t slot0, const Children& ch, int32_t* krow,
    int32_t* sk, int32_t* sl, int32_t* sm1, int32_t* sm2, int acap,
    int& used, Pop& pop) {
  const unsigned lt = (1u << lane) - 1u;
  __syncwarp();  // the pop every thread read from the planes at the end of
                 // the last pass is read before its slot is written again
  int last_ofs = -1;  // no free slot of a higher rank takes a child
#pragma unroll
  for (int j = 0; j < kNch; ++j)
    if ((ch.valid >> j) & 1u) last_ofs = max(last_ofs, ch.ofs[j]);
  int n_free = 0;          // free slots in earlier chunks
  int32_t best = INT_MAX;  // this thread's first minimum
  int best_i = lane;
  int used_now = 1;

  int g0 = 0;
  for (int g = 0; g0 < acap && (g < used || n_free <= last_ofs);
       ++g, g0 += 32 * kGroup) {
    int32_t kk[kGroup];
    unsigned m[kGroup];
    bool changed[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int s = g0 + 32 * u + lane;
      kk[u] = s < acap ? krow[s] : INT_MAX;
      changed[u] = act && s == slot0;
      if (changed[u]) kk[u] = INT_MAX;
    }
    unsigned all_free = kFullWarp;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      m[u] = __ballot_sync(kFullWarp, kk[u] == INT_MAX);
      all_free &= m[u];
    }
    // entries in this group after the step: some before it, or a child now
    if (n_free <= last_ofs || all_free != kFullWarp) used_now = g + 1;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int s = g0 + 32 * u + lane;
      if (s - lane >= acap) m[u] = 0u;   // past the row: no slot at all
      if (n_free <= last_ofs) {  // uniform: a child is still to be placed
        const int r = n_free + __popc(m[u] & lt);  // 0-based free rank
        if (((m[u] >> lane) & 1u) && r <= last_ofs) {
          bool placed = false;
          uint32_t vk = 0, vl = 0, vm1 = 0, vm2 = 0;
#pragma unroll
          for (int j = 0; j < kNch; ++j)
            if (((ch.valid >> j) & 1u) && ch.ofs[j] == r) {
              placed = true;
              kk[u] = ch.key[j];
              vk = ch.k[j];
              vl = ch.l[j];
              vm1 = ch.m1[j];
              vm2 = ch.m2[j];
            }
          if (placed) {
            changed[u] = true;
            sk[s] = (int32_t)vk;
            sl[s] = (int32_t)vl;
            sm1[s] = (int32_t)vm1;
            sm2[s] = (int32_t)vm2;
          }
        }
      }
      n_free += __popc(m[u]);
      if (changed[u]) krow[s] = kk[u];
      if (kk[u] < best) {
        best = kk[u];
        best_i = s;
      }
    }
  }
  if (g0 < acap) n_free += acap - g0;  // the rest of the row is free
  used = used_now;

  // the row's first minimum: the least key, then the least slot holding it
  const int32_t kmin = __reduce_min_sync(kFullWarp, best);
  const int slot = __reduce_min_sync(kFullWarp, best == kmin ? best_i
                                                             : INT_MAX);
  __syncwarp();  // the owner's writes of this step are seen by every thread
  pop.slot = slot;
  pop.key = kmin;
  pop.k = (uint32_t)sk[slot];
  pop.l = (uint32_t)sl[slot];
  pop.m1 = (uint32_t)sm1[slot];
  pop.m2 = (uint32_t)sm2[slot];

  Pushed out = {false, 0};
#pragma unroll
  for (int j = 0; j < kNch; ++j) {
    if (!((ch.valid >> j) & 1u)) continue;
    if (ch.ofs[j] < n_free)
      ++out.count;
    else
      out.ovf = true;
  }
  return out;
}



constexpr int kWarps = 4;  // lanes per block, one warp each

// Bytes of shared memory a block needs for its lanes' arenas.
inline size_t arena_bytes(int acap) {
  return (size_t)kWarps * 5 * acap * sizeof(int32_t);
}

// The index words every step needs, read once per launch, and where the
// table's rows are (fm_row.cuh: FlatRows or ShardRows).
template <class Rows>
struct Index {
  Rows rows;
  uint32_t seq_len, n_blk;
  uint32_t l2[4], l2d[4], prim[2];
};

template <class Rows>
__device__ __forceinline__ Index<Rows> load_index(const IbwaSearchCfg& c) {
  Index<Rows> ix;
  ix.rows = Rows::of(c.blocks, c.shards);
  ix.seq_len = (uint32_t)c.seq_len;
  ix.n_blk = (uint32_t)c.n_blk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ix.l2[i] = (uint32_t)c.L2[i];
    ix.l2d[i] = (uint32_t)c.l2diff[i];
  }
  ix.prim[0] = (uint32_t)c.primary[0];
  ix.prim[1] = (uint32_t)c.primary[1];
  return ix;
}

// A lane's scalars: registers, the same value in every thread of the warp.
struct LaneState {
  int lens;
  bool has_seed;
  int lane_it, seqc, stack_n, n_hits, best_score;
  int32_t best_cnt;
  int max_diff;
  bool done, fb;
  int used;  // leading groups of the arena that may hold entries
  Pop pop;
  long long rows;  // FM rows the lane's steps needed, asked ahead or not
};

// Where a lane's rows are.
struct LaneRows {
  int32_t *key, *sk, *sl, *sm1, *sm2;  // the arena, [acap] each, shared
  int64_t *hk, *hl, *hm;               // hit rows, [hcap]
  int64_t *w, *bid, *meta;             // width rows of the read, [2, P]
  const uint8_t* seq2;                 // bases of the read, [2, L]
};

// The arena rows of warp `warp` in the block's shared memory.
__device__ __forceinline__ void arena_rows(int32_t* smem, int warp, int acap,
                                           LaneRows& p) {
  p.key = smem + (size_t)warp * 5 * acap;
  p.sk = p.key + acap;
  p.sl = p.sk + acap;
  p.sm1 = p.sl + acap;
  p.sm2 = p.sm1 + acap;
}

// The two occ4 rows asked for ahead of the next step, and whose they are.
template <int WPB>
struct NextRows {
  OccRow<WPB> r0, r1;
  uint32_t k, l, sidx;
  bool valid;
};

// u32.py::int_log2: bit length - 1 of 0 <= v, counted up to the bit length
// of max_value; log2(0) == 0.
__device__ __forceinline__ int int_log2(int v, int max_value) {
  const int nb = 32 - __clz(max(max_value, 1));
  int out = 0;
  for (int s = 1; s < nb; ++s) out += (v >> s) > 0 ? 1 : 0;
  return out;
}

// One step of a lane that is neither done nor routed to the host; all 32
// threads of the warp call it together.  It may set s.done or s.fb; the
// caller steps the lane no further then.
template <int WPB, bool PF, bool PROF, class Rows>
__device__ __forceinline__ void search_step(const IbwaSearchCfg& a,
                                            const Index<Rows>& ix,
                                            const LaneRows& p, LaneState& s,
                                            NextRows<WPB>& next, int lane,
                                            ibwa_step::StageClock<PROF>& clk) {
  const int P = a.L + a.SL + 2;
  const unsigned le = 0xFFFFFFFFu >> (31 - lane);  // lanes <= this one

  // ---- 1. gating
  if (s.stack_n == 0 || s.stack_n > a.max_entries) {
    s.done = true;
    return;
  }
  ++s.lane_it;  // heavy-tail cap: the read goes to the host search
  if (s.lane_it > a.iter_cap) {
    s.fb = true;
    return;
  }

  // ---- 2. pop decode
  const uint32_t e_k = s.pop.k, e_l = s.pop.l, m1 = s.pop.m1, m2 = s.pop.m2;
  const int e_score = s.pop.key >> 20;
  --s.stack_n;
  const int e_state = (int)(m1 & 3u);
  const uint32_t e_a = (m1 >> 2) & 1u;
  const int e_i = (int)((m1 >> 3) & 0x1FFFu);
  const int e_ldp = (int)((m1 >> 16) & 0x1FFFu);
  const int e_nmm = (int)(m2 & 0xFFu);
  const int e_gapo = (int)((m2 >> 8) & 0xFFu);
  const int e_gape = (int)((m2 >> 16) & 0xFFu);
  if (!a.nonstop && e_score > s.best_score + a.s_mm) {
    s.done = true;
    return;
  }

  const uint32_t sidx = 1u - e_a;  // FM strand searched
  const uint32_t prim = sidx ? ix.prim[1] : ix.prim[0];  // no indexed read:
                                  // the index words stay in registers
  const bool is_e = e_state == a.state_e;
  const bool is_norm = !is_e;
  const int i2 = max(e_i - 1, 0);
  const int i2g = min(i2, a.L - 1);

  clk.mark(ibwa_step::kStDecode);

  // ---- 3. occ4 at (k - 1, l): the rows asked for ahead when they are this
  // pop's, else both in flight now; then the loads that do not depend on
  // them
  OccRow<WPB> r0, r1;
  if (PF && next.valid && next.k == e_k && next.l == e_l &&
      next.sidx == sidx) {
    r0 = next.r0;
    r1 = next.r1;
  } else {
    fetch_occ_row<WPB>(ix.rows, e_k - 1u, prim, ix.seq_len,
                       ix.n_blk, sidx, r0);
    fetch_occ_row<WPB>(ix.rows, e_l, prim, ix.seq_len, ix.n_blk,
                       sidx, r1);
  }
  next.valid = false;
  s.rows += 2;
  const int ii = i2 - (s.lens - a.SL);
  const int ii_c = min(max(ii, 0), a.SL);
  const int64_t* mrow_r = p.meta + (int64_t)e_a * P;
  const uint32_t mm_ = (uint32_t)mrow_r[min(i2, P - 1)];
  const uint32_t ms_ = (uint32_t)mrow_r[ii_c + a.L + 1];
  const int base = (int)__ldg(p.seq2 + e_a * a.L + i2g);
  uint32_t kj[4], lj[4];
  occ_count4<WPB>(r0, ix.l2d, kj);
  occ_count4<WPB>(r1, ix.l2d, lj);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    kj[c] += ix.l2[c] + 1u;
    lj[c] += ix.l2[c];
  }

  clk.mark(ibwa_step::kStOcc4);

  // ---- 4. budget and D(i) pruning, hits
  const int bm1 = (int)(mm_ & 0x3FFFu), b0 = (int)((mm_ >> 14) & 0x3FFFu);
  const int weq = (int)((mm_ >> 28) & 1u);
  const int sbm1 = (int)(ms_ & 0x3FFFu), sb0 = (int)((ms_ >> 14) & 0x3FFFu);
  const int sweq = (int)((ms_ >> 28) & 1u);
  const int spent = e_nmm + e_gapo + (a.gape_mode ? e_gape : 0);
  const int m = s.max_diff - spent;
  const bool alive = is_norm && m >= 0 && !(e_i > 0 && m < b0);
  const bool hit_direct = alive && e_i == 0;
  bool cond_e = alive && e_i > 0 && m == 0;
  if (!a.gape_mode)
    cond_e = cond_e && (e_state == a.state_m || e_gape == a.max_gape);
  const bool expand = alive && !hit_direct && !cond_e;

  // E entry: one base of bwt_match_exact_alt
  const uint32_t e_cn = (uint32_t)min(base, 3);
  const uint32_t e_k2 = pick4(kj, e_cn), e_l2 = pick4(lj, e_cn);
  const bool e_go = is_e && e_i > 0 && base < 4 && e_k2 <= e_l2;
  const bool hit_e = is_e && e_i == 0;

  const bool hit = hit_direct || hit_e;
  const bool first = hit && s.n_hits == 0;
  if (first) {
    s.best_score = e_score;
    if (!a.nonstop) s.max_diff = min(spent + 1, s.max_diff);
  }
  const bool same = e_score == s.best_score;
  const uint32_t occv = e_l - e_k + 1u;
  const bool brk2 = hit && !same && s.best_cnt > a.max_top2;
  if (hit && same) s.best_cnt = (int32_t)((uint32_t)s.best_cnt + occv);
  s.done = s.done || brk2;
  const bool add = hit && !brk2;
  bool dup = false;
  if (add && e_gapo > 0) {  // the slots a thread reads are those it wrote
    bool mine = false;
    for (int t = lane; t < a.hcap; t += 32)
      mine = mine || (t < s.n_hits && p.hk[t] == (int64_t)e_k &&
                      p.hl[t] == (int64_t)e_l);
    dup = __any_sync(kFullWarp, mine);
  }
  bool do_add = add && !dup;
  if (do_add && s.n_hits >= a.hcap) {  // hit capacity: host search
    s.fb = true;
    do_add = false;
  }
  if (do_add) {
    const int slot = min(s.n_hits, a.hcap - 1);
    if (lane == (slot & 31)) {
      p.hk[slot] = (int64_t)e_k;
      p.hl[slot] = (int64_t)e_l;
      p.hm[slot] = (int64_t)((uint32_t)e_nmm | ((uint32_t)e_gapo << 8) |
                             ((uint32_t)e_gape << 16) | (e_a << 24));
    }
    ++s.n_hits;

    // ---- 5. gap_shadow over the positions < ldp of strand a, and the
    // packed meta of the changed row
    int64_t* wrow = p.w + (int64_t)e_a * P;
    int64_t* brow = p.bid + (int64_t)e_a * P;
    int64_t* mrow = p.meta + (int64_t)e_a * P;
    int seen = 0;         // positions with w == occv in earlier chunks
    uint32_t last_w = 0;  // the new values at the chunk's last position
    int64_t last_b = 0;
    for (int c0 = 0; c0 < P; c0 += 32) {
      const int q = c0 + lane;
      const bool in = q < P;
      const uint32_t wv = in ? (uint32_t)wrow[q] : 0u;
      const int64_t bv = in ? brow[q] : 0;
      const bool upd = in && q < e_ldp;
      const bool meq = upd && wv == occv;
      const unsigned mb = __ballot_sync(kFullWarp, meq);
      const int j = seen + __popc(mb & le);  // inclusive running count
      uint32_t nw = wv;
      if (upd && wv > occv)
        nw = wv - occv;
      else if (meq)
        nw = ix.seq_len - (uint32_t)j;
      const int64_t nb = meq ? 1 : bv;
      uint32_t pw = __shfl_up_sync(kFullWarp, nw, 1);
      int64_t pb = __shfl_up_sync(kFullWarp, nb, 1);
      if (lane == 0) {  // position 0 clamps i - 1 to 0
        pw = c0 == 0 ? nw : last_w;
        pb = c0 == 0 ? nb : last_b;
      }
      last_w = __shfl_sync(kFullWarp, nw, 31);
      last_b = __shfl_sync(kFullWarp, nb, 31);
      if (in) {
        wrow[q] = (int64_t)nw;
        brow[q] = nb;
        mrow[q] = (int64_t)(((uint64_t)pb | ((uint64_t)nb << 14) |
                             ((uint64_t)(pw == nw ? 1 : 0) << 28)) &
                            0xFFFFFFFFull);
      }
      seen += __popc(mb);
    }
    __syncwarp();  // the next step's meta read sees these writes
  }

  clk.mark(ibwa_step::kStHits);

  // ---- 6. expansion into <= 10 children in reference push order
  const bool ad1 = bm1 > m - 1;
  const bool am1 = !ad1 && bm1 == m - 1 && b0 == m - 1 && weq == 1;
  const int m_seed = a.max_seed_diff - spent;
  const bool sgate = s.has_seed && ii > 0;
  const bool sad = sbm1 > m_seed - 1;
  const bool ad2 = sgate && sad;
  const bool am2 =
      sgate && !sad && sbm1 == m_seed - 1 && sb0 == m_seed - 1 && sweq == 1;
  const bool at_end = i2 == 0;
  const bool allow_diff = at_end || (!ad1 && !ad2);
  const bool allow_m = at_end || (!am1 && !am2);
  const int tmp = a.loggap
                      ? int_log2(e_gape + e_gapo, a.max_gapo + a.max_gape) /
                                2 + 1
                      : e_gapo + e_gape;
  const bool ok_indel = expand && allow_diff &&
                        i2 >= a.indel_end_skip + tmp &&
                        s.lens - i2 >= a.indel_end_skip + tmp;
  const bool io = ok_indel && e_state == a.state_m && e_gapo < a.max_gapo;
  const bool ie = ok_indel && e_state == a.state_i && e_gape < a.max_gape;
  const bool d_open = io;
  const bool d_ext =
      ok_indel && e_state == a.state_d && e_gape < a.max_gape &&
      (e_gape + e_gapo < s.max_diff ||
       (int64_t)occv < (int64_t)a.max_del_occ);
  const bool d_any = d_open || d_ext;
  const bool allow_full = allow_diff && allow_m;

  // slot 9: the exact-extension chain (spawn or continuation) burns
  // e_unroll - 1 more bases with occ1
  bool ev = cond_e || e_go;
  uint32_t ek9 = cond_e ? e_k : e_k2, el9 = cond_e ? e_l : e_l2;
  int ei9 = cond_e ? e_i : e_i - 1;
  for (int u = 1; u < a.e_unroll; ++u) {
    if (!(ev && ei9 > 0)) continue;  // uniform
    const int bu =
        (int)__ldg(p.seq2 + e_a * a.L + min(max(ei9 - 1, 0), a.L - 1));
    const uint32_t cu = (uint32_t)min(bu, 3);
    OccRow<WPB> u0, u1;
    s.rows += 2;
    fetch_occ_row<WPB>(ix.rows, ek9 - 1u, prim, ix.seq_len,
                       ix.n_blk, sidx, u0);
    fetch_occ_row<WPB>(ix.rows, el9, prim, ix.seq_len, ix.n_blk,
                       sidx, u1);
    const uint32_t k2u =
        pick4(ix.l2, cu) + occ_count<WPB>(u0, cu, ix.l2d) + 1u;
    const uint32_t l2v = pick4(ix.l2, cu) + occ_count<WPB>(u1, cu, ix.l2d);
    if (bu < 4 && k2u <= l2v) {
      ek9 = k2u;
      el9 = l2v;
      --ei9;
    } else {
      ev = false;
    }
  }

  clk.mark(ibwa_step::kStEChain);

  Children ch;
  ch.valid = 0;
  int nmm[kNch], gapo[kNch], gape[kNch], ci[kNch], ldp[kNch], state[kNch];
  // slot 0: I open (from M) or I extend (from I)
  if (io || ie) ch.valid |= 1u;
  ch.k[0] = e_k;
  ch.l[0] = e_l;
  ci[0] = i2;
  state[0] = a.state_i;
  nmm[0] = e_nmm;
  gapo[0] = e_gapo + (io ? 1 : 0);
  gape[0] = e_gape + (ie ? 1 : 0);
  ldp[0] = i2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // slots 1-4: D open (from M) or D extend (from D), base j
    if (d_any && kj[j] <= lj[j]) ch.valid |= 1u << (1 + j);
    ch.k[1 + j] = kj[j];
    ch.l[1 + j] = lj[j];
    ci[1 + j] = i2 + 1;
    state[1 + j] = a.state_d;
    nmm[1 + j] = e_nmm;
    gapo[1 + j] = e_gapo + (d_open ? 1 : 0);
    gape[1 + j] = e_gape + (d_ext ? 1 : 0);
    ldp[1 + j] = i2 + 1;
    // slots 5-8: mismatch / match with base c = (base + j + 1) & 3; the
    // last one is the read's own base when it is one
    const uint32_t c = (uint32_t)(base + j + 1) & 3u;
    const uint32_t kc = pick4(kj, c), lc = pick4(lj, c);
    const bool is_mm = j < 3 || base > 3;
    const bool m_ok = j < 3 ? allow_full : (allow_full || base < 4);
    if (expand && kc <= lc && m_ok) ch.valid |= 1u << (5 + j);
    ch.k[5 + j] = kc;
    ch.l[5 + j] = lc;
    ci[5 + j] = i2;
    state[5 + j] = a.state_m;
    nmm[5 + j] = e_nmm + (is_mm ? 1 : 0);
    gapo[5 + j] = e_gapo;
    gape[5 + j] = e_gape;
    ldp[5 + j] = is_mm ? i2 : e_ldp;
  }
  if (ev) ch.valid |= 1u << 9;
  ch.k[9] = ek9;
  ch.l[9] = el9;
  ci[9] = ei9;
  state[9] = a.state_e;
  nmm[9] = e_nmm;
  gapo[9] = e_gapo;
  gape[9] = e_gape;
  ldp[9] = e_ldp;

  int rank = 0;
  const unsigned pushed_in = ch.valid;
#pragma unroll
  for (int j = 0; j < kNch; ++j) {
    ch.m1[j] = (uint32_t)state[j] | (e_a << 2) | ((uint32_t)ci[j] << 3) |
               ((uint32_t)ldp[j] << 16);
    ch.m2[j] = (uint32_t)nmm[j] | ((uint32_t)gapo[j] << 8) |
               ((uint32_t)gape[j] << 16);
    // the key's low 32 bits, as the plain step wraps them
    const uint32_t sc = (uint32_t)(nmm[j] * a.s_mm + gapo[j] * a.s_gapo +
                                   gape[j] * a.s_gape);
    ch.ofs[j] = rank;  // exclusive rank among the children
    const int seq = s.seqc + rank;
    ch.key[j] = (int32_t)((sc << 20) | (uint32_t)(a.max_seq - seq));
    if ((pushed_in >> j) & 1u) {
      ++rank;
      if (seq >= a.max_seq) {  // seqno field exhausted: host search
        s.fb = true;
        ch.valid &= ~(1u << j);
      }
    }
  }

  clk.mark(ibwa_step::kStChildren);

  // ---- 6b. ask for the rows of the likely next pop before the pass over
  // the key row: the chain's child, else the child that takes the read's own
  // base.  Either has the popped entry's score and the latest push, so it is
  // the next pop whenever it exists; any other step asks for nothing.
  if (PF && (ch.valid >> 8)) {
    const bool c9 = (ch.valid >> 9) & 1u;
    next.k = c9 ? ch.k[9] : ch.k[8];
    next.l = c9 ? ch.l[9] : ch.l[8];
    next.sidx = sidx;
    next.valid = true;
    fetch_occ_row<WPB>(ix.rows, next.k - 1u, prim, ix.seq_len,
                       ix.n_blk, sidx, next.r0);
    fetch_occ_row<WPB>(ix.rows, next.l, prim, ix.seq_len,
                       ix.n_blk, sidx, next.r1);
  }

  clk.mark(ibwa_step::kStPrefetch);

  // ---- 7. the arena update and the next pop
  const Pushed pushed =
      stack_commit(lane, true, s.pop.slot, ch, p.key, p.sk, p.sl, p.sm1,
                   p.sm2, a.acap, s.used, s.pop);
  s.fb = s.fb || pushed.ovf;
  s.seqc += pushed.count;
  s.stack_n += pushed.count;
  clk.mark(ibwa_step::kStCommit);
}

template <int WPB, bool PF, bool PROF, class Rows>
__device__ __forceinline__ void search_chunk_first_body(
    const IbwaChunkFirstArgs& a) {
  extern __shared__ int32_t arena[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= a.B) return;  // uniform across the warp

  const IbwaSearchCfg& c = a.c;
  const int64_t n2p = 2 * (int64_t)(c.L + c.SL + 2);
  const Index<Rows> ix = load_index<Rows>(c);
  LaneRows p;
  arena_rows(arena, warp, c.acap, p);
  LaneState s;
  NextRows<WPB> next;
  ibwa_step::StageClock<PROF> clk;
  if constexpr (PROF) {
    for (int i = 0; i < ibwa_step::kStages; ++i) clk.t[i] = 0;
  }

  s.rows = 0;
  int64_t t = 0;        // the lane's position on the phased loop's clock
  int64_t flushed = 0;  // reads this lane flushed
  int64_t iters = 0;    // iterations this lane ran
  bool stopped = false;
  for (int64_t rid = row; rid < a.N; rid += a.B) {
    // ---- switch stage, start: the read's rows where they are, a root
    // arena, the scalars of a fresh read
    p.w = a.big_w + rid * n2p;
    p.bid = a.big_bid + rid * n2p;
    p.meta = a.big_meta + rid * n2p;
    p.hm = a.out_hm + rid * c.hcap;
    p.hk = a.out_hk + rid * c.hcap;
    p.hl = a.out_hl + rid * c.hcap;
    p.seq2 = c.seqs + rid * 2 * c.L;
    const int64_t len = a.read_lens[rid];
    const int64_t md = a.read_max_diff[rid];
    __syncwarp();  // every thread has read the last read's last pop
    ibwa_switch::root_arena(lane, p.key, p.sk, p.sl, p.sm1, p.sm2, c.acap, len,
                            c.seq_len, c.max_seq, c.state_m);
    s.lens = (int)len;
    s.has_seed = a.read_has_seed[rid];
    s.max_diff = (int)md;
    s.lane_it = 0;
    s.seqc = 2;
    s.stack_n = 2;
    s.n_hits = 0;
    s.best_score = (int)ibwa_switch::start_best_score(
        md, c.s_mm, c.s_gapo, c.s_gape, c.max_gapo, c.max_gape);
    s.best_cnt = 0;
    s.done = a.read_bad[rid];  // too many Ns: nothing to search
    s.fb = false;
    s.used = 1;  // the two roots
    s.pop.slot = 1;
    s.pop.key = c.max_seq - 1;
    s.pop.k = 0;
    s.pop.l = (uint32_t)c.seq_len;
    s.pop.m1 = ibwa_switch::root_m1(c.state_m, 1u, len);
    s.pop.m2 = 0;
    next.valid = false;

    // ---- step stage: j counts to the iteration that sets a flag; past the
    // loop's bound no switch would see it
    int64_t j = 0;
    while (!(s.done || s.fb) && t + j < a.t_end) {
      ++j;
      clk.start();
      search_step<WPB, PF>(c, ix, p, s, next, lane, clk);
    }
    iters += j;

    // ---- switch stage, flush: at the first switch of the phased loop that
    // sees the flag
    const int64_t phases = j <= a.switch_k ? 1 : (j + a.switch_k - 1) /
                                                     a.switch_k;
    const int64_t at = t + phases * a.switch_k;
    if (at >= a.t_end) {  // the loop's bound: this read stays unflushed
      stopped = true;
      break;
    }
    t = at;
    ++flushed;
    if (lane == 0) {
      a.out_nh[rid] = s.n_hits;
      a.out_fb[rid] = s.fb;
    }
  }

  if (lane == 0) {
    if (flushed) atomicAdd(a.counters, 0ull - (unsigned long long)flushed);
    if (stopped)
      atomicMax(a.counters + 1, (unsigned long long)a.t_end);
    else if (flushed)
      atomicMax(a.counters + 1, (unsigned long long)(t + a.switch_k));
    atomicMax(a.counters + 2, (unsigned long long)iters);
    atomicAdd(a.counters + 3, (unsigned long long)iters);
    atomicAdd(a.counters + 4, (unsigned long long)s.rows);
    if constexpr (PROF) {
      long long* out = a.prof + row * ibwa_step::kStages;
      for (int i = 0; i < ibwa_step::kStages; ++i) out[i] = clk.t[i];
    }
  }
}

// (two blocks an SM: 1,024 lanes are 256 blocks on 132 SMs, and a bound of
// three would cap the step at 168 registers, which spills)
template <int WPB, bool PF, bool PROF>
__global__ void __launch_bounds__(kWarps * 32, 2)
    search_chunk_first_kernel(const IbwaChunkFirstArgs a) {
  search_chunk_first_body<WPB, PF, PROF, FlatRows>(a);
}

template <int WPB, bool PF, bool PROF>
__global__ void __launch_bounds__(kWarps * 32, 2)
    search_chunk_first_sharded_kernel(
        const __grid_constant__ IbwaChunkFirstArgs a) {
  search_chunk_first_body<WPB, PF, PROF, ShardRows>(a);
}

template <int WPB, bool PF, bool PROF>
int launch(const IbwaChunkFirstArgs& a, cudaStream_t st) {
  const size_t smem = arena_bytes(a.c.acap);
  const bool sharded = a.c.shards.n > 0;
  const cudaError_t rc =
      sharded ? cudaFuncSetAttribute(
                    search_chunk_first_sharded_kernel<WPB, PF, PROF>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
              : cudaFuncSetAttribute(
                    search_chunk_first_kernel<WPB, PF, PROF>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (a.B + kWarps - 1) / kWarps;
  if (sharded)
    search_chunk_first_sharded_kernel<WPB, PF, PROF>
        <<<grid, kWarps * 32, smem, st>>>(a);
  else
    search_chunk_first_kernel<WPB, PF, PROF>
        <<<grid, kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int WPB>
int launch_mode(const IbwaChunkFirstArgs& a, int mode, cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch<WPB, false, false>(a, st);
    case 1:
      return launch<WPB, true, false>(a, st);
    default:
      return launch<WPB, true, true>(a, st);
  }
}

}  // namespace ibwa_first

// `mode` picks the step: 1 the one the engine ran; 0 the same without the
// rows of the next pop asked for ahead; 2 mode 1 with the stages' clocks
// (search_step.cuh's kSt*) written to `prof`, a row a lane.  All compute
// the same.  A shard table in use (0 < c.shards.n <= kMaxShards, rows a
// multiple of its range size) picks the sharded instantiation.
extern "C" int ibwa_search_chunk_first(const IbwaChunkFirstArgs* args,
                                       int mode, void* stream) {
  const IbwaChunkFirstArgs& a = *args;
  if (a.B <= 0) return 0;
  if (mode < 0 || mode > 2 || (mode == 2 && !a.prof) || a.N <= 0 || a.switch_k <= 0 || a.t_end <= 0 ||
      a.c.acap < 32 ||
      a.c.acap % 32 || ibwa_first::arena_bytes(a.c.acap) > 227 * 1024 ||
      a.c.n_reads != a.N || a.c.L <= 0 || a.c.hcap <= 0 ||
      !ibwa_fm::shards_ok(a.c.shards, 2 * a.c.n_blk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.c.intv) {
    case 32:
      return ibwa_first::launch_mode<2>(a, mode, st);
    case 64:
      return ibwa_first::launch_mode<4>(a, mode, st);
    case 128:
      return ibwa_first::launch_mode<8>(a, mode, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}