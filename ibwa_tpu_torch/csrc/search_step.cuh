// One pop-expand-push step of one aln search lane (bwt_match_gap,
// bwtgap.c:104-264, one popped entry per step), as __device__ code for one
// warp: shared by the phased entry (search_step.cu: n_steps steps of every
// lane per launch, the state in global memory between launches) and by the
// resident chunk kernel (search_chunk.cu: a lane's whole life in one launch).
//
// Replaces: ibwa_tpu/align/engine_jax.py::_search_step (XLA), with the two
// kernels it reached as its stages: the occ queries of
// ibwa_tpu/fm/device.py::occ4 / occ1 (stage 3, fm_row.cuh, K2's code) and
// the arena update of ibwa_tpu/align/stack_kernel.py::stack_update (stage 7,
// stack_commit.cuh, K1's code).  A step leaves the lane as the plain step
// (align/engine.py::_search_step) leaves it, given width rows whose `meta`
// is the packed summary of `w` / `bid` and a pop that matches the arena, as
// every state the engine loads or steps has: the plain step rewrites those
// planes every step, this code only where they change.
//
// Bound on an H100: latency, the chain of one lane, and behind it the
// warp instructions a step issues.  A step moves a few hundred bytes (two FM
// rows for the occ4 bounds, up to two more for the E-chain's occ1, one or
// two read bases, two meta words), and a lane's step is a chain: pop -> occ4
// rows (a dependent fetch from HBM, the table is above what the L2 keeps)
// -> occ1 rows of the E-chain -> the children -> the pass over the key row
// that finds the next pop, before whose end the next rows could not be
// asked for.  Other lanes' chains hide it only as far as warps are
// resident: the chunk kernel keeps 16 an SM (search_chunk.cu).
//
// Design, what it does about the chain:
//   * the lane's arena (key, sk, sl, sm1, sm2 rows) is in shared memory
//     wherever this code runs: the pop is read from it, the <= 10 child
//     writes and the key updates never leave the SM.  The caller decides
//     what happens to it between launches (search_step.cu copies it in and
//     out, search_chunk.cu never writes it back);
//   * the lane's scalars and the popped entry are registers (`LaneState`),
//     the same value in all 32 threads, so every branch on them is uniform
//     and a row fetch is one broadcast transaction per warp;
//   * one thread a child: thread j < 10 builds child j (interval, entry
//     words, key) from the uniform counts, a ballot and a popcount give the
//     push ranks, and each child thread stages its child in shared memory
//     at its rank, where the thread that owns the free slot of that rank
//     takes it in the arena pass.  No thread holds the ten children (the
//     first version kept seven 10-wide arrays in every thread, 184
//     registers), so four blocks of four warps fit an SM;
//   * the E-chain's first extension of a spawned chain (cond_e) is counted
//     on the popped entry's own occ4 rows, which are the rows it needs: only
//     the continuation of a chain fetches for its next base;
//   * the next pop's rows are asked for BEFORE the key pass (PF): the search
//     is depth first, so the next pop is mostly a child just built, and of
//     those the exact-extension child or the one that takes the read's own
//     base (the popped entry's score, the latest push) whenever one exists.
//     Its two occ4 rows are copied into the lane's shared memory
//     (cp.async, fm_row.cuh's prefetch_pair) while stack_commit runs, with
//     no register holding them, and the next step takes them when its pop
//     has that child's interval and strand (`NextPop`); any other pop
//     fetches as before;
//   * all four bases of a bound are counted in one pass over its row
//     (occ_count4), and the arena pass takes the key row in groups of chunks
//     whose loads and ballots overlap (stack_commit.cuh): a lane's own
//     dependent arithmetic, not its bytes, is most of a step;
//   * the warp works as 32 threads only where there is a row to cover: the
//     duplicate test over the hit slots (one ballot), the gap_shadow pass
//     over the P positions of one strand (ballot + popc running count,
//     neighbours by shuffle; only when a hit is recorded) and the arena pass
//     (stack_commit).
// The width rows and the hit rows are global memory, wherever the caller
// points: the lane's own copies (phased) or the read's rows of the chunk's
// planes and outputs, in place (chunk).  Words of w / bid / meta written by
// one thread and read by another are fenced with __syncwarp(); a hit slot
// and an arena slot are read and written by their owner thread only
// (slot & 31 == thread).
#ifndef IBWA_SEARCH_STEP_CUH
#define IBWA_SEARCH_STEP_CUH

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_row.cuh"
#include "stack_commit.cuh"

// What both entries take beside their own tensors: the index, the reads,
// shapes, EngineConfig and the engine's constants, and the row ranges of a
// split table (shards.n == 0: the flat table at `blocks`).  align/engine.py::
// _SearchCfg mirrors this layout field for field.
struct IbwaSearchCfg {
  const uint32_t* blocks;
  const int64_t* primary;
  const int64_t* L2;
  const int64_t* l2diff;
  const uint8_t* seqs;
  int64_t seq_len, n_blk;
  int n_reads, intv;
  int L, SL, acap, hcap;
  int s_mm, s_gapo, s_gape, max_gapo, max_gape, max_del_occ, indel_end_skip;
  int max_top2, max_entries, max_seed_diff, iter_cap;
  int gape_mode, nonstop, loggap;
  int max_seq, e_unroll;
  int state_m, state_i, state_d, state_e;
  ibwa_fm::IbwaShards shards;
};

namespace ibwa_step {

using namespace ibwa_fm;
using namespace ibwa_stack;

constexpr int kWarps = 4;  // lanes per block, one warp each

// Why a read was routed to the host search, in the plain step's order where
// two fire in one step (align/engine.py's FB_* codes).
enum : int {
  kCauseNone = 0,
  kCauseIterCap = 1,  // the read ran past EngineConfig.iter_cap steps
  kCauseArena = 2,    // a child found no free arena slot
  kCauseHits = 3,     // a hit found the hit rows full
  kCauseSeqno = 4,    // the push counter ran out of the key's seqno field
};

// Words of shared memory a lane needs: its arena's five rows, the staging
// rows of its children and the two rows asked for ahead; a multiple of four
// words, so that every lane's area is 16-byte aligned.
__host__ __device__ inline size_t lane_words(int acap) {
  return 5 * (size_t)acap + 5 * kStage + kPairWords;
}

// Bytes of shared memory a block needs for its lanes.
inline size_t arena_bytes(int acap) {
  return (size_t)kWarps * lane_words(acap) * sizeof(int32_t);
}

// The stages of a step whose clocks the profiling instantiation keeps
// (ibwa_tpu_torch/profile_step.py --mode stages).
enum : int {
  kStDecode = 0,    // gating and the pop's fields
  kStOcc4 = 1,      // the occ4 rows and their counts
  kStHits = 2,      // budget, pruning, the hit and gap_shadow
  kStEChain = 3,    // the exact-extension chain's occ1
  kStChildren = 4,  // the children, their ranks and their staging
  kStPrefetch = 5,  // the next pop's rows asked for
  kStCommit = 6,    // stack_commit: the arena pass and the next pop
  kStages = 7
};

// Per-stage clocks of one lane, summed over its steps (clock64), when PROF;
// nothing at all otherwise.
template <bool PROF>
struct StageClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
};

template <>
struct StageClock<true> {
  long long t[kStages];
  long long last;
  __device__ __forceinline__ void start() { last = clock64(); }
  __device__ __forceinline__ void mark(int stage) {
    const long long now = clock64();
    t[stage] += now - last;
    last = now;
  }
};

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
  int cause;  // kCause* of the step that set fb; kCauseNone while it is not
  int used;   // leading groups of the arena that may hold entries
  Pop pop;
  unsigned rows;     // FM rows the lane's steps needed, asked ahead or not
  unsigned efetch;  // of them, the E-chain's fetches (two rows each)
};

// Where a lane's rows are.
struct LaneRows {
  int32_t *key, *sk, *sl, *sm1, *sm2;  // the arena, [acap] each, shared
  int32_t* stage;                      // staged children, [5, kStage]
  uint32_t* pair;                      // the rows asked ahead, [2, 4 + WPB]
  int64_t *hk, *hl, *hm;               // hit rows, [hcap]
  int64_t *w, *bid, *meta;             // width rows of the read, [2, P]
  const uint8_t* seq2;                 // bases of the read, [2, L]
};

// The arena rows of warp `warp` in the block's shared memory.
__device__ __forceinline__ void arena_rows(int32_t* smem, int warp, int acap,
                                           LaneRows& p) {
  p.key = smem + (size_t)warp * lane_words(acap);
  p.sk = p.key + acap;
  p.sl = p.sk + acap;
  p.sm1 = p.sl + acap;
  p.sm2 = p.sm1 + acap;
  p.stage = p.sm2 + acap;
  p.pair = reinterpret_cast<uint32_t*>(p.stage + 5 * kStage);
}

// The interval whose two occ4 rows were asked for ahead of the next step
// (into LaneRows::pair), and on which strand; valid while they are.
struct NextPop {
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
// threads of the warp call it together.  It may set s.done or s.fb (and
// s.cause with fb); the caller steps the lane no further then.  `clk` keeps
// the stages' clocks in the profiling instantiation (PROF) and is nothing
// in any other.
template <int WPB, bool PF, bool PROF, class Rows>
__device__ __forceinline__ void search_step(const IbwaSearchCfg& a,
                                            const Index<Rows>& ix,
                                            const LaneRows& p, LaneState& s,
                                            NextPop& next, int lane,
                                            StageClock<PROF>& clk) {
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
    s.cause = kCauseIterCap;
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
  clk.mark(kStDecode);

  // ---- 3. occ4 at (k - 1, l): the rows asked for ahead when they are this
  // pop's, else both in flight now; then the loads that do not depend on
  // them.  Rows asked for ahead are waited for in any case: the buffer
  // takes the next ones.
  OccRow<WPB> r0, r1;
  bool ahead = false;
  if (PF && next.valid) {
    copy_async_wait();
    __syncwarp();
    ahead = next.k == e_k && next.l == e_l && next.sidx == sidx;
  }
  if (ahead) {
    take_pair<WPB>(p.pair, e_k - 1u, e_l, prim, ix.seq_len, ix.n_blk, r0,
                   r1);
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
  clk.mark(kStOcc4);

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
    s.cause = kCauseHits;
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
  clk.mark(kStHits);

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
  // e_unroll - 1 more bases with occ1.  A spawned chain (cond_e) starts
  // from the popped interval, whose occ4 rows are r0 / r1: its first base
  // is counted there, with no fetch.
  bool ev = cond_e || e_go;
  uint32_t ek9 = cond_e ? e_k : e_k2, el9 = cond_e ? e_l : e_l2;
  int ei9 = cond_e ? e_i : e_i - 1;
  for (int u = 1; u < a.e_unroll; ++u) {
    if (!(ev && ei9 > 0)) continue;  // uniform
    const int bu =
        (int)__ldg(p.seq2 + e_a * a.L + min(max(ei9 - 1, 0), a.L - 1));
    const uint32_t cu = (uint32_t)min(bu, 3);
    uint32_t k2u, l2v;
    if (u == 1 && cond_e) {  // the rows of (e_k - 1, e_l), counted above
      k2u = pick4(kj, cu);
      l2v = pick4(lj, cu);
    } else {
      OccRow<WPB> u0, u1;
      s.rows += 2;
      ++s.efetch;
      fetch_occ_row<WPB>(ix.rows, ek9 - 1u, prim, ix.seq_len,
                         ix.n_blk, sidx, u0);
      fetch_occ_row<WPB>(ix.rows, el9, prim, ix.seq_len, ix.n_blk,
                         sidx, u1);
      k2u = pick4(ix.l2, cu) + occ_count<WPB>(u0, cu, ix.l2d) + 1u;
      l2v = pick4(ix.l2, cu) + occ_count<WPB>(u1, cu, ix.l2d);
    }
    if (bu < 4 && k2u <= l2v) {
      ek9 = k2u;
      el9 = l2v;
      --ei9;
    } else {
      ev = false;
    }
  }
  clk.mark(kStEChain);

  // the child of this thread, j = lane < 10: 0 I open (from M) or I extend
  // (from I); 1-4 D open (from M) or D extend (from D), base j - 1; 5-8
  // mismatch / match with base (base + j - 4) & 3, the last one the read's
  // own base when it is one; 9 the exact-extension chain
  bool cv = false;
  uint32_t ck = e_k, cl = e_l;
  int cnmm = e_nmm, cgapo = e_gapo, cgape = e_gape, cci = i2, cldp = i2;
  int cstate = a.state_i;
  if (lane == 0) {
    cv = io || ie;
    cgapo += io ? 1 : 0;
    cgape += ie ? 1 : 0;
  } else if (lane <= 4) {
    ck = pick4(kj, (uint32_t)(lane - 1));
    cl = pick4(lj, (uint32_t)(lane - 1));
    cv = d_any && ck <= cl;
    cci = cldp = i2 + 1;
    cstate = a.state_d;
    cgapo += d_open ? 1 : 0;
    cgape += d_ext ? 1 : 0;
  } else if (lane <= 8) {
    const uint32_t c = (uint32_t)(base + lane - 4) & 3u;
    ck = pick4(kj, c);
    cl = pick4(lj, c);
    const bool is_mm = lane < 8 || base > 3;
    const bool m_ok = lane < 8 ? allow_full : (allow_full || base < 4);
    cv = expand && ck <= cl && m_ok;
    cstate = a.state_m;
    cnmm += is_mm ? 1 : 0;
    cldp = is_mm ? i2 : e_ldp;
  } else if (lane == 9) {
    cv = ev;
    ck = ek9;
    cl = el9;
    cci = ei9;
    cstate = a.state_e;
    cldp = e_ldp;
  }
  // push ranks: a ballot, and each child's exclusive popcount; the children
  // past the key's seqno field are not pushed, and route the read to the
  // host search
  const unsigned made = __ballot_sync(kFullWarp, cv);
  const int rank = __popc(made & ((1u << lane) - 1u));
  const int n_made = __popc(made);
  const int n_push = min(n_made, max(a.max_seq - s.seqc, 0));
  if (n_push < n_made) {
    if (!s.fb) s.cause = kCauseSeqno;
    s.fb = true;
  }
  if (cv && rank < n_push) {
    // the key's low 32 bits, as the plain step wraps them
    const uint32_t sc = (uint32_t)(cnmm * a.s_mm + cgapo * a.s_gapo +
                                   cgape * a.s_gape);
    p.stage[rank] =
        (int32_t)((sc << 20) | (uint32_t)(a.max_seq - (s.seqc + rank)));
    p.stage[kStage + rank] = (int32_t)ck;
    p.stage[2 * kStage + rank] = (int32_t)cl;
    p.stage[3 * kStage + rank] =
        (int32_t)((uint32_t)cstate | (e_a << 2) | ((uint32_t)cci << 3) |
                  ((uint32_t)cldp << 16));
    p.stage[4 * kStage + rank] =
        (int32_t)((uint32_t)cnmm | ((uint32_t)cgapo << 8) |
                  ((uint32_t)cgape << 16));
  }
  clk.mark(kStChildren);

  // ---- 6b. ask for the rows of the likely next pop before the pass over
  // the key row: the chain's child, else the child that takes the read's own
  // base.  Either has the popped entry's score and the latest push, so it is
  // the next pop whenever it is pushed; any other step asks for nothing.
  // Both are uniform: the chain's interval, and child 8's base (base & 3).
  // The rows go to shared memory (cp.async), so no register holds them
  // through the arena pass.
  const bool push9 = ((made >> 9) & 1u) && __popc(made & 0x1FFu) < n_push;
  const bool push8 = ((made >> 8) & 1u) && __popc(made & 0xFFu) < n_push;
  if (PF && (push8 || push9)) {
    next.k = push9 ? ek9 : pick4(kj, (uint32_t)base & 3u);
    next.l = push9 ? el9 : pick4(lj, (uint32_t)base & 3u);
    next.sidx = sidx;
    next.valid = true;
    prefetch_pair<WPB>(ix.rows, next.k - 1u, next.l, prim, ix.seq_len,
                       ix.n_blk, sidx, p.pair, lane);
  }
  clk.mark(kStPrefetch);

  // ---- 7. the arena update and the next pop: n_push children of ranks
  // 0 .. n_push - 1; those at or beyond the free count overflow the arena
  const int n_free =
      stack_commit(lane, true, s.pop.slot, StagedChildren{p.stage, n_push},
                   p.key, p.sk, p.sl, p.sm1, p.sm2, a.acap, s.used, s.pop);
  if (n_push > n_free) {
    if (!s.fb) s.cause = kCauseArena;
    s.fb = true;
  }
  const int pushed = min(n_push, n_free);
  s.seqc += pushed;
  s.stack_n += pushed;
  clk.mark(kStCommit);
}

}  // namespace ibwa_step

#endif  // IBWA_SEARCH_STEP_CUH
