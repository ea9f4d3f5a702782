// K9's first version, `extend_dp_first`: the seed extensions of one `bwasw`
// batch, a warp a job, the job's whole row of cells in global memory.  No
// path runs it: `extend_dp.cu` (the redesign, the band's window in shared
// memory) took its place, and `chip_smoke.py` times the two in turns.
//
// Replaces: ibwa_tpu/ops/dp.py::_extend_scan, the XLA lax.scan over query
// rows behind `extend_jobs` / `extend_batch`: the reference's one-sided
// banded Smith-Waterman seed extension (aln_extend_core,
// stdaln.c:862-1008), held bitwise to the port's host kernel
// `ibwa_extend_aln` (native/src/core.cpp): seeded with G0 at cell 1 of row
// 0, per query row j the cells [start, end) of the adaptive band, the
// score and the endpoint of its first maximum, no traceback.
//
// Contract of `ibwa_extend_dp_first`: the batch as bsw2.cpp's ExtBatch
// holds it, uploaded as it comes: the targets in one u8 blob with int64 offsets
// tgt_off[n + 1], the queries likewise, g0 and band int32[n], one 5x5
// matrix and one (gap_open, gap_ext) pair.  The launch runs the n_ids jobs
// listed in ids (each non-empty, each admitted by the gate: G0 + qlen x
// max(matrix) < 30000, so no value leaves 16 bits and the host kernel's
// rescale never fires) and writes (score - 1, end_i, end_j) to
// out[3 * job]; other rows of out are left as they are.  eh is scratch of
// tgt_off[n] + 2n u32: job i's row of packed cells, h << 16 | e as the host
// packs them, at tgt_off[i] + 2i, len1 + 2 cells.  stats u64[4], zeroed by
// the caller: [0] the job queue, [1] rows run, [2] cells computed, [3] the
// longest job's rows.
//
// Design.  One warp a job, jobs taken from an atomic queue (stats[0]) by a
// persistent grid of the blocks the card holds resident, 8 warps a block:
// a batch's jobs differ tenfold in length, and a warp that ends one takes
// the next.  The queue's order is the caller's (ops/dp.py lists the longest
// queries first: 14% off a left batch of 14,000 jobs on 8,448 resident
// warps).  A row is a serial dependence along i (the in-row gap chain F),
// so the warp's lanes take 32 consecutive cells at a time and carry the
// chain from stride to stride:
//   de  = max(h ? h + M[q_j][t_i] : 0, e)       (h, e read from the row)
//   F_i = max_{i' < i} (max(de_i' - qr, 0) - (i - i' - 1) r)
//       = (exclusive prefix max of max(de - qr, 0) + (i - start + 1) r)
//         - (i - start) r, by __shfl_up_sync, the carry from the stride
//         before in lane 0 (offsets from the row's start keep it in 32
//         bits whatever the target's length)
//   h   = max(de, F);   e' = max(e - r, max(h - qr, 0))
//   cell i gets (h_{i-1} << 16 | e'), the h of the cell before by a
//   shuffle (the carry from the stride before, 0 at start), and
//   cell end gets h_{end-1} << 16.
// The row's maximum, its FIRST i (the host updates on score < h in i
// order: the first i within a row, strictly greater across rows), and the
// first and last positive cells are kept a lane and reduced once a row
// (__reduce_max_sync / __reduce_min_sync); start and end are uniform in
// the warp, so every branch on them is.  The job stops where the host's
// stops: on start == end, or on a row with no positive cell.
//
// The row lives in global memory (L1 / L2), not shared: a target may be
// thousands of cells long, and the band touches ~2 x band + 1 cells a row,
// coalesced.  It is the WHOLE row, zeroed once at the job's start, not a
// window: end may shrink to the last positive cell + 3 and grow again by 2
// a row, and the cells it grows over are read as the rows before left
// them (the host kernel relies on these stale cells).
//
// Bound on an H100.  Bytes: the blobs, the rows (written once when zeroed)
// and the outputs: a few MB a batch, microseconds.  Operations: ~40
// integer operations a cell.  Latency: the longest job's rows times one
// row's chain of dependent shuffles and reductions (~8 collectives a
// stride of 32 cells, 4 a row): a batch is as long as its longest job, and
// that chain, not bytes or operations, bounds it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kNeg = -(1 << 29);

struct ExtendArgs {
  const uint8_t* tgt;
  const int64_t* tgt_off;
  const uint8_t* qry;
  const int64_t* qry_off;
  const int32_t* g0;
  const int32_t* band;
  const int32_t* ids;
  uint32_t* eh;
  int32_t* out;
  unsigned long long* stats;
  int n_ids, q, r;
  int matrix[25];
};

// One job by one warp; adds the rows it ran and the cells it computed.
__device__ __forceinline__ void extend_job(const ExtendArgs& a,
                                           const int* mat, int job, int lane,
                                           long long& rows,
                                           long long& cells) {
  const int64_t t0 = a.tgt_off[job], q0 = a.qry_off[job];
  const int len1 = (int)(a.tgt_off[job + 1] - t0);
  const int len2 = (int)(a.qry_off[job + 1] - q0);
  const int band = a.band[job], r = a.r, qr = a.q + a.r;
  uint32_t* eh = a.eh + t0 + 2 * (int64_t)job;
  const uint8_t* s1 = a.tgt + t0 - 1;  // 1-based cell i -> target[i - 1]
  for (int i = lane; i < len1 + 2; i += 32) eh[i] = 0u;
  __syncwarp();
  if (lane == 0) eh[1] = (uint32_t)a.g0[job] << 16;
  __syncwarp();

  int start = 1, end = 2, score = 0, end_i = 0, end_j = 0;
  for (int j = 1; j <= len2; ++j) {
    const int* srow = mat + 5 * a.qry[q0 + j - 1];
    start = max(start, max(j - band, 1));
    end = min(end, min(j + band, len1 + 1));
    if (start == end) break;
    ++rows;
    cells += end - start;
    int fcarry = kNeg, hcarry = 0;
    int best = 0, best_i = INT_MAX, first_pos = INT_MAX, last_pos = 0;
    for (int base = start; base < end; base += 32) {
      const int i = base + lane;
      const bool in = i < end;
      int h = 0, e = 0, de = 0;
      if (in) {
        const uint32_t cell = eh[i];
        h = (int)(cell >> 16);
        e = (int)(cell & 0xFFFFu);
        de = max(h ? h + srow[s1[i]] : 0, e);
      }
      // the gap chain: inclusive prefix max of the keys, then exclusive
      int key = in ? max(de - qr, 0) + (i - start + 1) * r : kNeg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, key, d);
        if (lane >= d) key = max(key, o);
      }
      int excl = __shfl_up_sync(kFull, key, 1);
      excl = lane == 0 ? fcarry : max(excl, fcarry);
      const int hn = max(de, excl - (i - start) * r);
      int hprev = __shfl_up_sync(kFull, hn, 1);
      if (lane == 0) hprev = hcarry;
      if (in) {
        eh[i] = ((uint32_t)hprev << 16) |
                (uint32_t)max(e - r, max(hn - qr, 0));
        if (i == end - 1) eh[end] = (uint32_t)hn << 16;
        if (hn > 0) {
          if (first_pos == INT_MAX) first_pos = i;
          last_pos = i;
          if (hn > best) {
            best = hn;
            best_i = i;
          }
        }
      }
      // lane 31 holds the stride's running max and its last cell's h
      const unsigned long long pk = __shfl_sync(
          kFull, ((unsigned long long)(uint32_t)key << 32) | (uint32_t)hn,
          31);
      fcarry = max(fcarry, (int)(uint32_t)(pk >> 32));
      hcarry = (int)(uint32_t)pk;
    }
    const int rmax = __reduce_max_sync(kFull, best);
    if (rmax > score) {
      score = rmax;
      end_i = __reduce_min_sync(kFull, best == rmax ? best_i : INT_MAX);
      end_j = j;
    }
    const int nstart = __reduce_min_sync(kFull, first_pos);
    const int nend = __reduce_max_sync(kFull, last_pos);
    __syncwarp();  // this row's cells before the next row reads them
    if (nend <= 0) break;
    start = nstart;
    end = nend + 3;
  }
  if (lane == 0) {
    a.out[3 * (int64_t)job] = score - 1;
    a.out[3 * (int64_t)job + 1] = end_i;
    a.out[3 * (int64_t)job + 2] = end_j;
  }
}

__global__ void __launch_bounds__(kThreads)
    extend_dp_first_kernel(const ExtendArgs a) {
  __shared__ int mat[25];
  if (threadIdx.x < 25) mat[threadIdx.x] = a.matrix[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  long long rows = 0, cells = 0, longest = 0;
  for (;;) {
    unsigned long long x = 0;
    if (lane == 0) x = atomicAdd(&a.stats[0], 1ULL);
    x = __shfl_sync(kFull, x, 0);
    if (x >= (unsigned long long)a.n_ids) break;
    const long long before = rows;
    extend_job(a, mat, a.ids[x], lane, rows, cells);
    longest = max(longest, rows - before);
  }
  if (lane == 0 && rows) {
    atomicAdd(&a.stats[1], (unsigned long long)rows);
    atomicAdd(&a.stats[2], (unsigned long long)cells);
    atomicMax(&a.stats[3], (unsigned long long)longest);
  }
}

}  // namespace

// tgt, qry: u8 blobs; tgt_off, qry_off: int64[n + 1]; g0, band: int32[n];
// ids: int32[n_ids], the jobs to run; matrix: 25 int32 on the host (copied
// into the launch's arguments); eh: u32 scratch of tgt_off[n] + 2n; out:
// int32[n, 3]; stats: u64[4], zeroed; max_blocks > 0 caps the grid below
// the card's resident blocks (the tests' small grids), 0 leaves it to the
// card.
extern "C" int ibwa_extend_dp_first(const void* tgt, const void* tgt_off,
                                    const void* qry, const void* qry_off,
                                    const void* g0, const void* band,
                                    const void* ids, int n_ids,
                                    const void* matrix, int gap_open,
                                    int gap_ext, void* eh, void* out,
                                    void* stats, int max_blocks,
                                    void* stream) {
  if (n_ids <= 0) return 0;
  ExtendArgs a;
  a.tgt = static_cast<const uint8_t*>(tgt);
  a.tgt_off = static_cast<const int64_t*>(tgt_off);
  a.qry = static_cast<const uint8_t*>(qry);
  a.qry_off = static_cast<const int64_t*>(qry_off);
  a.g0 = static_cast<const int32_t*>(g0);
  a.band = static_cast<const int32_t*>(band);
  a.ids = static_cast<const int32_t*>(ids);
  a.eh = static_cast<uint32_t*>(eh);
  a.out = static_cast<int32_t*>(out);
  a.stats = static_cast<unsigned long long*>(stats);
  a.n_ids = n_ids;
  a.q = gap_open;
  a.r = gap_ext;
  const int32_t* m = static_cast<const int32_t*>(matrix);
  for (int k = 0; k < 25; ++k) a.matrix[k] = m[k];
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, extend_dp_first_kernel, kThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int64_t grid = (int64_t)per_sm * sms;
  // no more warps than jobs
  const int64_t need = ((int64_t)n_ids + kWarps - 1) / kWarps;
  if (grid > need) grid = need;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  extend_dp_first_kernel<<<(int)grid, kThreads, 0, static_cast<cudaStream_t>(
                                                  stream)>>>(a);
  return (int)cudaGetLastError();
}
