// The aln search step: n_steps pop-expand-push steps of every search lane
// in one launch (bwt_match_gap, bwtgap.c:104-264, one popped entry per
// step).
//
// Replaces: ibwa_tpu/align/engine_jax.py::_search_step inside the fori_loop
// of _run_search_persistent (XLA), with the two kernels it reached as its
// stages: the occ queries of ibwa_tpu/fm/device.py::occ4 / occ1 (stage 3,
// fm_row.cuh, K2's code) and the arena update of
// ibwa_tpu/align/stack_kernel.py::stack_update (stage 7, stack_commit.cuh,
// K1's code).  It leaves every field of the search state bitwise equal to
// n_steps calls of the plain step (align/engine.py::_search_step), given a
// state whose `meta` plane is the packed summary of its `w` / `bid` planes
// and whose pop fields are those of its arena, as every state that the
// engine loads or steps is: the plain step rewrites those planes every
// step, this kernel only where they change.
//
// Bound on an H100: latency.  Per lane and step the work is two FM rows
// (the occ4 bounds), up to two more (the E-chain's occ1), one or two read
// bases, two meta words, <= 11 changed arena slots and one pass over the
// lane's key row: a few hundred bytes.  Nothing between two switch phases
// crosses lanes, so a lane's steps need no grid-wide barrier; what remains
// is the chain of dependent fetches of one step (the pop's entry -> the occ4
// rows -> the occ1 rows), a few tenths of a microsecond each.
//
// Design: one warp per lane, 4 lanes per block, the loop over n_steps inside
// the kernel.  The scalars of a lane (its counters, its best score, the
// popped entry) live in registers for the whole launch, the same value in
// all 32 threads, so every branch on them is uniform and the row fetches
// are one broadcast transaction per warp.  The lane's key row lives in
// shared memory across the steps; every changed key is also written
// through to the global row, so nothing is copied back at the end.  The
// warp works as 32 threads only where there is a row to cover: the
// duplicate test over the hit slots (one ballot), the gap_shadow pass over
// the P positions of one strand (ballot + popc running count, neighbours by
// shuffle; only when a hit is recorded), and the arena pass (stack_commit).
// Per step only FM rows, read bases, one meta pair and the changed slots go
// to global memory.  A lane that is done or routed to the host idles for
// the rest of the launch.  Global words written by one thread and read by
// another of the warp (w / bid / meta) are fenced with __syncwarp(); the
// hit planes and the arena are read and written by a slot's owner thread
// only.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_row.cuh"
#include "stack_commit.cuh"

namespace {

using namespace ibwa_fm;
using namespace ibwa_stack;

constexpr int kWarps = 4;  // lanes per block

}  // namespace

// The launch arguments: align/engine.py::_StepArgs mirrors this layout
// field for field.  The first 30 pointers are the fields of SearchState in
// its order.
struct IbwaStepArgs {
  const int64_t* rid;
  const int64_t* lens;
  const bool* has_seed;
  int64_t* lane_it;
  int32_t* sk;
  int32_t* sl;
  int32_t* sm1;
  int32_t* sm2;
  int32_t* key;
  int64_t* seqc;
  int64_t* stack_n;
  int64_t* w;
  int64_t* bid;
  int64_t* meta;
  int64_t* hk;
  int64_t* hl;
  int64_t* hm;
  int64_t* n_hits;
  int64_t* best_score;
  int64_t* best_cnt;
  int64_t* max_diff;
  bool* done;
  bool* fb;
  int64_t* it;
  int64_t* pslot;
  int64_t* pkey;
  int64_t* pk;
  int64_t* pl;
  int64_t* pm1;
  int64_t* pm2;
  // the index and the reads
  const uint32_t* blocks;
  const int64_t* primary;
  const int64_t* L2;
  const int64_t* l2diff;
  const uint8_t* seqs;
  int64_t seq_len, n_blk;
  // shapes and EngineConfig
  int B, n_reads, n_steps, intv;
  int L, SL, acap, hcap;
  int s_mm, s_gapo, s_gape, max_gapo, max_gape, max_del_occ, indel_end_skip;
  int max_top2, max_entries, max_seed_diff, iter_cap;
  int gape_mode, nonstop, loggap;
  int max_seq, e_unroll;
  int state_m, state_i, state_d, state_e;
};

namespace {

// u32.py::int_log2: bit length - 1 of 0 <= v, counted up to the bit length
// of max_value; log2(0) == 0.
__device__ __forceinline__ int int_log2(int v, int max_value) {
  const int nb = 32 - __clz(max(max_value, 1));
  int out = 0;
  for (int s = 1; s < nb; ++s) out += (v >> s) > 0 ? 1 : 0;
  return out;
}

template <int WPB>
__global__ void __launch_bounds__(kWarps * 32)
    search_steps_kernel(const IbwaStepArgs a) {
  extern __shared__ int32_t key_rows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= a.B) return;  // uniform across the warp
  if (row == 0 && lane == 0) a.it[0] += a.n_steps;

  const int acap = a.acap, P = a.L + a.SL + 2;
  const uint32_t seq_len = (uint32_t)a.seq_len, n_blk = (uint32_t)a.n_blk;
  const uint32_t l2[4] = {(uint32_t)a.L2[0], (uint32_t)a.L2[1],
                          (uint32_t)a.L2[2], (uint32_t)a.L2[3]};
  const uint32_t l2d[4] = {(uint32_t)a.l2diff[0], (uint32_t)a.l2diff[1],
                           (uint32_t)a.l2diff[2], (uint32_t)a.l2diff[3]};
  const uint32_t prim[2] = {(uint32_t)a.primary[0], (uint32_t)a.primary[1]};
  const unsigned le = 0xFFFFFFFFu >> (31 - lane);  // lanes <= this one

  // the lane's key row: each thread copies, and later touches, only the
  // slots it owns (slot & 31 == lane)
  int32_t* krow = key_rows + warp * acap;
  int32_t* krow_g = a.key + row * acap;
  for (int s = lane; s < acap; s += 32) krow[s] = krow_g[s];
  int32_t* sk = a.sk + row * acap;
  int32_t* sl = a.sl + row * acap;
  int32_t* sm1 = a.sm1 + row * acap;
  int32_t* sm2 = a.sm2 + row * acap;
  int64_t* hk = a.hk + row * a.hcap;
  int64_t* hl = a.hl + row * a.hcap;
  int64_t* hm = a.hm + row * a.hcap;

  // per-lane scalars, the same in every thread
  const int lens = (int)a.lens[row];
  const bool has_seed = a.has_seed[row];
  const int64_t rid = a.rid[row];
  const int64_t crid = rid < 0 ? 0 : rid >= a.n_reads ? a.n_reads - 1 : rid;
  const uint8_t* seq2 = a.seqs + crid * 2 * a.L;  // [2, L] of this read
  int lane_it = (int)a.lane_it[row];
  int seqc = (int)a.seqc[row];
  int stack_n = (int)a.stack_n[row];
  int n_hits = (int)a.n_hits[row];
  int best_score = (int)a.best_score[row];
  int32_t best_cnt = (int32_t)a.best_cnt[row];
  int max_diff = (int)a.max_diff[row];
  bool done = a.done[row];
  bool fb = a.fb[row];
  Pop pop;
  pop.slot = (int)a.pslot[row];
  pop.key = (int32_t)a.pkey[row];
  pop.k = (uint32_t)a.pk[row];
  pop.l = (uint32_t)a.pl[row];
  pop.m1 = (uint32_t)a.pm1[row];
  pop.m2 = (uint32_t)a.pm2[row];

  for (int step = 0; step < a.n_steps; ++step) {
    // ---- 1. gating: an inactive lane changes nothing, now or later
    if (done || fb) break;
    if (stack_n == 0 || stack_n > a.max_entries) {
      done = true;
      break;
    }
    ++lane_it;  // heavy-tail cap: the read goes to the host search
    if (lane_it > a.iter_cap) {
      fb = true;
      break;
    }

    // ---- 2. pop decode
    const uint32_t e_k = pop.k, e_l = pop.l, m1 = pop.m1, m2 = pop.m2;
    const int e_score = pop.key >> 20;
    --stack_n;
    const int e_state = (int)(m1 & 3u);
    const uint32_t e_a = (m1 >> 2) & 1u;
    const int e_i = (int)((m1 >> 3) & 0x1FFFu);
    const int e_ldp = (int)((m1 >> 16) & 0x1FFFu);
    const int e_nmm = (int)(m2 & 0xFFu);
    const int e_gapo = (int)((m2 >> 8) & 0xFFu);
    const int e_gape = (int)((m2 >> 16) & 0xFFu);
    if (!a.nonstop && e_score > best_score + a.s_mm) {
      done = true;
      break;
    }

    const uint32_t sidx = 1u - e_a;  // FM strand searched
    const bool is_e = e_state == a.state_e;
    const bool is_norm = !is_e;
    const int i2 = max(e_i - 1, 0);
    const int i2g = min(i2, a.L - 1);

    // ---- 3. occ4 at (k - 1, l): both rows in flight, then the loads that
    // do not depend on them
    OccRow<WPB> r0, r1;
    fetch_occ_row<WPB>(a.blocks, e_k - 1u, prim[sidx], seq_len, n_blk, sidx,
                       r0);
    fetch_occ_row<WPB>(a.blocks, e_l, prim[sidx], seq_len, n_blk, sidx, r1);
    const int ii = i2 - (lens - a.SL);
    const int ii_c = min(max(ii, 0), a.SL);
    const int64_t* mrow_r = a.meta + (row * 2 + e_a) * P;
    const uint32_t mm_ = (uint32_t)mrow_r[min(i2, P - 1)];
    const uint32_t ms_ = (uint32_t)mrow_r[ii_c + a.L + 1];
    const int base = (int)__ldg(seq2 + e_a * a.L + i2g);
    uint32_t kj[4], lj[4];
#pragma unroll
    for (uint32_t c = 0; c < 4; ++c) {
      kj[c] = l2[c] + occ_count<WPB>(r0, c, l2d) + 1u;
      lj[c] = l2[c] + occ_count<WPB>(r1, c, l2d);
    }

    // ---- 4. budget and D(i) pruning, hits
    const int bm1 = (int)(mm_ & 0x3FFFu), b0 = (int)((mm_ >> 14) & 0x3FFFu);
    const int weq = (int)((mm_ >> 28) & 1u);
    const int sbm1 = (int)(ms_ & 0x3FFFu), sb0 = (int)((ms_ >> 14) & 0x3FFFu);
    const int sweq = (int)((ms_ >> 28) & 1u);
    const int spent = e_nmm + e_gapo + (a.gape_mode ? e_gape : 0);
    const int m = max_diff - spent;
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
    const bool first = hit && n_hits == 0;
    if (first) {
      best_score = e_score;
      if (!a.nonstop) max_diff = min(spent + 1, max_diff);
    }
    const bool same = e_score == best_score;
    const uint32_t occv = e_l - e_k + 1u;
    const bool brk2 = hit && !same && best_cnt > a.max_top2;
    if (hit && same) best_cnt = (int32_t)((uint32_t)best_cnt + occv);
    done = done || brk2;
    const bool add = hit && !brk2;
    bool dup = false;
    if (add && e_gapo > 0) {  // the slots a thread reads are those it wrote
      bool mine = false;
      for (int s = lane; s < a.hcap; s += 32)
        mine = mine || (s < n_hits && hk[s] == (int64_t)e_k &&
                        hl[s] == (int64_t)e_l);
      dup = __any_sync(kFullWarp, mine);
    }
    bool do_add = add && !dup;
    if (do_add && n_hits >= a.hcap) {  // hit capacity: host search
      fb = true;
      do_add = false;
    }
    if (do_add) {
      const int slot = min(n_hits, a.hcap - 1);
      if (lane == (slot & 31)) {
        hk[slot] = (int64_t)e_k;
        hl[slot] = (int64_t)e_l;
        hm[slot] = (int64_t)((uint32_t)e_nmm | ((uint32_t)e_gapo << 8) |
                             ((uint32_t)e_gape << 16) | (e_a << 24));
      }
      ++n_hits;

      // ---- 5. gap_shadow over the positions < ldp of strand a, and the
      // packed meta of the changed row
      int64_t* wrow = a.w + (row * 2 + e_a) * P;
      int64_t* brow = a.bid + (row * 2 + e_a) * P;
      int64_t* mrow = a.meta + (row * 2 + e_a) * P;
      int seen = 0;        // positions with w == occv in earlier chunks
      uint32_t last_w = 0;  // the new values at the chunk's last position
      int64_t last_b = 0;
      for (int c0 = 0; c0 < P; c0 += 32) {
        const int p = c0 + lane;
        const bool in = p < P;
        const uint32_t wv = in ? (uint32_t)wrow[p] : 0u;
        const int64_t bv = in ? brow[p] : 0;
        const bool upd = in && p < e_ldp;
        const bool meq = upd && wv == occv;
        const unsigned mb = __ballot_sync(kFullWarp, meq);
        const int j = seen + __popc(mb & le);  // inclusive running count
        uint32_t nw = wv;
        if (upd && wv > occv)
          nw = wv - occv;
        else if (meq)
          nw = seq_len - (uint32_t)j;
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
          wrow[p] = (int64_t)nw;
          brow[p] = nb;
          mrow[p] = (int64_t)(((uint64_t)pb | ((uint64_t)nb << 14) |
                               ((uint64_t)(pw == nw ? 1 : 0) << 28)) &
                              0xFFFFFFFFull);
        }
        seen += __popc(mb);
      }
      __syncwarp();  // the next step's meta read sees these writes
    }

    // ---- 6. expansion into <= 10 children in reference push order
    const bool ad1 = bm1 > m - 1;
    const bool am1 = !ad1 && bm1 == m - 1 && b0 == m - 1 && weq == 1;
    const int m_seed = a.max_seed_diff - spent;
    const bool sgate = has_seed && ii > 0;
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
                          lens - i2 >= a.indel_end_skip + tmp;
    const bool io = ok_indel && e_state == a.state_m && e_gapo < a.max_gapo;
    const bool ie = ok_indel && e_state == a.state_i && e_gape < a.max_gape;
    const bool d_open = io;
    const bool d_ext =
        ok_indel && e_state == a.state_d && e_gape < a.max_gape &&
        (e_gape + e_gapo < max_diff || (int64_t)occv < (int64_t)a.max_del_occ);
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
          (int)__ldg(seq2 + e_a * a.L + min(max(ei9 - 1, 0), a.L - 1));
      const uint32_t cu = (uint32_t)min(bu, 3);
      OccRow<WPB> u0, u1;
      fetch_occ_row<WPB>(a.blocks, ek9 - 1u, prim[sidx], seq_len, n_blk, sidx,
                         u0);
      fetch_occ_row<WPB>(a.blocks, el9, prim[sidx], seq_len, n_blk, sidx, u1);
      const uint32_t k2u = pick4(l2, cu) + occ_count<WPB>(u0, cu, l2d) + 1u;
      const uint32_t l2v = pick4(l2, cu) + occ_count<WPB>(u1, cu, l2d);
      if (bu < 4 && k2u <= l2v) {
        ek9 = k2u;
        el9 = l2v;
        --ei9;
      } else {
        ev = false;
      }
    }

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
      const int64_t sc = (int64_t)nmm[j] * a.s_mm +
                         (int64_t)gapo[j] * a.s_gapo +
                         (int64_t)gape[j] * a.s_gape;
      ch.ofs[j] = rank;  // exclusive rank among the children
      const int seq = seqc + rank;
      ch.key[j] = (int32_t)((sc << 20) | (int64_t)(a.max_seq - seq));
      if ((pushed_in >> j) & 1u) {
        ++rank;
        if (seq >= a.max_seq) {  // seqno field exhausted: host search
          fb = true;
          ch.valid &= ~(1u << j);
        }
      }
    }

    // ---- 7. the arena update and the next pop
    const Pushed pushed = stack_commit(lane, true, pop.slot, ch, krow, krow_g,
                                       sk, sl, sm1, sm2, acap, pop);
    fb = fb || pushed.ovf;
    seqc += pushed.count;
    stack_n += pushed.count;
  }

  if (lane == 0) {
    a.lane_it[row] = lane_it;
    a.seqc[row] = seqc;
    a.stack_n[row] = stack_n;
    a.n_hits[row] = n_hits;
    a.best_score[row] = best_score;
    a.best_cnt[row] = best_cnt;
    a.max_diff[row] = max_diff;
    a.done[row] = done;
    a.fb[row] = fb;
    a.pslot[row] = pop.slot;
    a.pkey[row] = pop.key;
    a.pk[row] = (int64_t)pop.k;
    a.pl[row] = (int64_t)pop.l;
    a.pm1[row] = (int64_t)pop.m1;
    a.pm2[row] = (int64_t)pop.m2;
  }
}

}  // namespace

extern "C" int ibwa_search_steps(const IbwaStepArgs* args, void* stream) {
  const IbwaStepArgs& a = *args;
  if (a.B <= 0 || a.n_steps <= 0) return 0;
  const size_t smem = (size_t)kWarps * a.acap * sizeof(int32_t);
  if (a.acap <= 0 || a.acap % 32 || smem > 48 * 1024 || a.n_reads <= 0 ||
      a.L <= 0 || a.hcap <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (a.B + kWarps - 1) / kWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.intv) {
    case 32:
      search_steps_kernel<2><<<grid, kWarps * 32, smem, st>>>(a);
      break;
    case 64:
      search_steps_kernel<4><<<grid, kWarps * 32, smem, st>>>(a);
      break;
    case 128:
      search_steps_kernel<8><<<grid, kWarps * 32, smem, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
