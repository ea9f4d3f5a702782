// K9 `extend_dp`: the seed extensions of one `bwasw` batch, a warp a job,
// the band's window in shared memory, four cells a lane.
//
// Replaces: ibwa_tpu/ops/dp.py::_extend_scan, the XLA lax.scan over query
// rows behind `extend_jobs` / `extend_batch`: the reference's one-sided
// banded Smith-Waterman seed extension (aln_extend_core,
// stdaln.c:862-1008), held bitwise to the port's host kernel
// `ibwa_extend_aln` (native/src/core.cpp): seeded with G0 at cell 1 of row
// 0, per query row j the cells [start, end) of the adaptive band, the
// score and the endpoint of its first maximum, no traceback.
//
// Contract of `ibwa_extend_dp`: the batch as bsw2.cpp's ExtBatch holds it,
// uploaded as it comes: the targets in one u8 blob with int64 offsets
// tgt_off[n + 1], the queries likewise, g0 and band int32[n], one 5x5
// matrix and one (gap_open, gap_ext) pair.  The launch runs the n_ids jobs
// listed in ids (each non-empty, each admitted by the gate: G0 + qlen x
// max(matrix) < 30000, so no value leaves 16 bits and the host kernel's
// rescale never fires) and writes (score - 1, end_i, end_j) to
// out[3 * job]; other rows of out are left as they are.  stats u64[6],
// zeroed by the caller: [0] the job queue, [1] rows run, [2] cells
// computed, [3] the longest job's rows, [4] jobs run on a ring in shared
// memory, [5] jobs run on a row in global memory.
//
// The mode is chosen per launch by eh.  eh null: every job's cells live on
// its warp's ring of kRing cells in shared memory (2 KB a warp), which
// holds a band of up to kRingBand (ops/dp.py's RING_BAND; the stand-in test
// holds the two equal).  eh not null: the caller's scratch of tgt_off[n] +
// 12n + 4 u32, job i's row of cells at the first multiple of 4 from
// tgt_off[i] + 12i (len1 + 7 cells), for a batch with a wider band;
// nothing else differs.  The C contract carries no widest band and the card
// cannot give one without a wait, so the ring is not sized per launch: the
// caller, who holds the bands, picks the mode.
//
// The grid is kBlocksPerSm = 3 blocks (24 warps) an SM, or as many as
// the batch has whole blocks an SM (at least one), and no more blocks than
// the jobs need; the grid alone sets the blocks an SM runs.  chip_smoke.py
// (phase 4e) times grids of 1 to 6 blocks an SM on a bwasw run's first
// left batch (~14,000 jobs) and right batch (~1,400), PERF.md section 6
// has the readings: the left batch is fastest at 3, slower with fewer
// warps to issue from and with more; the right batch, whose longest jobs
// set its time, is fastest at one block an SM, its longest jobs then with
// 7 other warps on their SM.
//
// Design.  One warp a job, jobs taken from an atomic queue (stats[0]) by
// that persistent grid, 8 warps a block;
// the queue's order is the caller's (ops/dp.py lists the longest queries
// first).  The first version (extend_dp_first.cu: the job's whole row in
// global memory, 32 cells a stride, 8 collectives a stride) was bound by
// its warps' instructions; this one spends fewer on a cell:
//  * the ring.  At row j the cells read and written lie in [start, end]
//    with start >= j - band, end <= j + band, and start never decreases,
//    so cell i lives at slot i mod kRing: a cell that leaves the ring lies
//    below every later start.  A slot must read 0 the first time its cell
//    is touched, and holds a cell kRing below or an earlier job's: the
//    frontier's slots are zeroed ahead.  A row's end is at most the end
//    before + 2, so each row writes 0 into the two cells past its end (row
//    0, at the job's start, into cells 2 and 3), and every cell a row
//    reads above the cells written before has been zeroed by the row
//    before.  Cells between a shrunk end and the highest cell written hold
//    0 as well, as in the host's whole row (a row leaves every cell past
//    its last positive one + 1 at 0), so cell end, which is written but
//    not read, reads 0 too and is written as the row's cells are.
//  * four consecutive cells a lane, from a pass base aligned to 4, so a
//    lane's cells are one 16-byte load and store and a pass is 128 cells:
//    a band-50 row (at most 101 cells, 3 of alignment and 2 zeroed past
//    its end) is one pass.  The gap chain
//      F_i = max_{i' < i} (max(de_i' - qr, 0) - (i - i' - 1) r)
//          = (exclusive prefix max of max(de - qr, 0) + (i - start + 1) r)
//            - (i - start) r
//    (offsets from the row's start keep it in 32 bits) is a serial max in
//    the lane and one warp scan of the lanes' maxima shifted by a lane (6
//    shuffles); one more brings the h of the cell before a lane's first.
//    Rows wider than a pass carry both to the next.
//  * per pass one __reduce_max_sync of h << 16 | (0xFFFF - offset in the
//    pass) gives the pass's maximum and its FIRST cell (h < 2^15 by the
//    gate); the score moves only on a greater one, so across passes and
//    rows the first maximum is the host's (the first i within a row,
//    strictly greater across rows).  The first and last positive cells are
//    two reductions a row (four ballots, one per cell of a lane, would
//    cost more).  The matrix stays in shared memory: one load a cell is no
//    more instructions than a select among five registers.
//
// Bound on an H100.  Bytes: the blobs, offsets and outputs, a few MB a
// batch.  Operations: the recurrence's 18 integer operations a cell (the
// host loop's body) at 64 a clock an SM.  Issue: the SASS of the rings'
// entry (cuobjdump -sass; chip_smoke.py counts it) has 256 warp
// instructions in the row loop, of them 204 in the pass loop, so a row of
// a band up to 61 (one pass) issues ~256: a band-50 row of ~90 cells ~2.8
// a cell, where the recurrence needs 18 operations on 32 lanes (0.56).  A
// left batch's rows issue for ~1.2 ms at one warp instruction a clock per
// scheduler, against the 0.48 ms of its operations: the count of
// instructions, not the integer pipe's rate on the recurrence, sets how
// fast the kernel can go.  The instructions go to a pass's 128 lanes for
// ~90 cells, to each cell's masks of the row's edges and its score's
// load, to the scan (6 shuffles) and to the row's 3 reductions.  A right
// batch (~1,400 jobs) is as long as its longest job's chain of rows.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kCells = 4, kPass = 32 * kCells;
constexpr int kRing = 512;
// the cells a row touches, from start & ~3 (>= start - 3) to the end of
// the quad that holds end + 2 (<= end + 5), lie within 2 band + 9 cells
constexpr int kRingBand = (kRing - 9) / 2;
constexpr int kNeg = -(1 << 29);
// the most blocks of the grid an SM (see the note)
constexpr int kBlocksPerSm = 3;

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

// One job by one warp on `row` (its ring, or its row in global memory);
// adds the rows it ran and the cells it computed.
template <bool kShared>
__device__ __forceinline__ void extend_job(const ExtendArgs& a,
                                           const int* mat, uint32_t* row,
                                           int job, int lane,
                                           long long& rows,
                                           long long& cells) {
  const int64_t t0 = a.tgt_off[job], q0 = a.qry_off[job];
  const int len1 = (int)(a.tgt_off[job + 1] - t0);
  const int len2 = (int)(a.qry_off[job + 1] - q0);
  const int band = a.band[job], r = a.r, qr = a.q + a.r;
  const unsigned slot_mask = kShared ? kRing - 1 : kFull;
  if (!kShared) row += (t0 + 12 * (int64_t)job + 3) & ~(int64_t)3;
  const uint8_t* s1 = a.tgt + t0 - 1;  // 1-based cell i -> target[i - 1]
  // row 0: G0 at cell 1, and cells 2 and 3 zeroed ahead of row 1
  if (lane == 0)
    *reinterpret_cast<uint4*>(row) =
        make_uint4(0u, (uint32_t)a.g0[job] << 16, 0u, 0u);
  __syncwarp();

  int start = 1, end = 2, score = 0, end_i = 0, end_j = 0;
  int qbase = a.qry[q0];   // the next row's query base, fetched a row ahead
  for (int j = 1; j <= len2; ++j) {
    const int* srow = mat + 5 * qbase;
    if (j < len2) qbase = a.qry[q0 + j];
    start = max(start, max(j - band, 1));
    end = min(end, min(j + band, len1 + 1));
    if (start == end) break;
    ++rows;
    cells += end - start;
    const unsigned width = (unsigned)(end - start);
    int fcarry = kNeg, hcarry = 0;   // from the pass before
    int first_pos = INT_MAX, last_pos = 0;
    for (int base = start & ~3; base <= end + 2; base += kPass) {
      const int i0 = base + kCells * lane;
      const bool touch = i0 <= end + 2;
      uint32_t* quad = row + ((unsigned)i0 & slot_mask);
      uint4 raw = {0u, 0u, 0u, 0u};
      if (touch) raw = *reinterpret_cast<const uint4*>(quad);
      const uint32_t c[kCells] = {raw.x, raw.y, raw.z, raw.w};
      // in: the row's cells [start, end); every load before any use
      bool in[kCells];
      int sc[kCells];
      const uint8_t* t = s1 + i0;
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        in[k] = (unsigned)(i0 + k - start) < width;
        sc[k] = in[k] ? __ldg(t + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kCells; ++k) sc[k] = srow[sc[k]];
      // key offset of cell i: (i - start + 1) r
      const int off0 = (i0 - start + 1) * r;
      int e[kCells], de[kCells], key[kCells];
      int lane_max = kNeg;
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const int h = (int)(c[k] >> 16);
        e[k] = (int)(c[k] & 0xFFFFu);
        de[k] = max(h + (h ? sc[k] : kNeg), e[k]);   // an empty cell stays so
        key[k] = in[k] ? max(de[k] - qr, 0) + off0 + k * r : kNeg;
        lane_max = max(lane_max, key[k]);
      }
      // the lanes before this one: an inclusive scan of the maxima shifted
      // by a lane (a lane below d gets its own value back, which the max
      // leaves as it is)
      int f = __shfl_up_sync(kFull, lane_max, 1);
      f = lane == 0 ? fcarry : max(f, fcarry);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1)
        f = max(f, __shfl_up_sync(kFull, f, d));
      const int chain = max(f, lane_max);   // the pass's, in lane 31
      int hn[kCells];
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        hn[k] = in[k] ? max(f - off0 - (k - 1) * r, de[k]) : 0;
        f = max(f, key[k]);
        if (hn[k] > 0) {   // the lane's first and last positive cells
          first_pos = min(first_pos, i0 + k);
          last_pos = i0 + k;
        }
      }
      int hprev = __shfl_up_sync(kFull, hn[kCells - 1], 1);
      if (lane == 0) hprev = hcarry;
      // cell end reads 0 (see the note), so it is written as the row's
      // cells are: hprev << 16 | max(0 - r, 0); the two past it get 0
      uint32_t w[kCells];
      int best = 0;
      const int rank0 = 0xFFFF - kCells * lane;   // 0xFFFF - (i - base)
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        const uint32_t cell =
            ((uint32_t)hprev << 16) +
            (uint32_t)max(e[k] - r, max(hn[k] - qr, 0));
        w[k] = i0 + k <= end ? cell : 0u;
        best = max(best, (hn[k] << 16) + rank0 - k);
        hprev = hn[k];
      }
      if (touch)
        *reinterpret_cast<uint4*>(quad) = make_uint4(w[0], w[1], w[2], w[3]);
      // the pass's maximum and its first cell; greater moves the score
      const int pmax = __reduce_max_sync(kFull, best);
      if ((pmax >> 16) > score) {
        score = pmax >> 16;
        end_i = base + 0xFFFF - (pmax & 0xFFFF);
        end_j = j;
      }
      if (base + kPass <= end) {   // a next pass: carry the chain and h
        fcarry = __shfl_sync(kFull, chain, 31);
        hcarry = __shfl_sync(kFull, hn[kCells - 1], 31);
      }
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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    extend_dp_kernel(const ExtendArgs a) {
  __shared__ uint32_t rings[kShared ? kWarps * kRing : 1];
  __shared__ int mat[25];
  if (threadIdx.x < 25) mat[threadIdx.x] = a.matrix[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t* row = kShared ? rings + (threadIdx.x >> 5) * kRing : a.eh;
  long long rows = 0, cells = 0, longest = 0, jobs = 0;
  for (;;) {
    unsigned long long x = 0;
    if (lane == 0) x = atomicAdd(&a.stats[0], 1ULL);
    x = __shfl_sync(kFull, x, 0);
    if (x >= (unsigned long long)a.n_ids) break;
    const long long before = rows;
    extend_job<kShared>(a, mat, row, a.ids[x], lane, rows, cells);
    longest = max(longest, rows - before);
    ++jobs;
  }
  if (lane == 0 && jobs) {
    atomicAdd(&a.stats[1], (unsigned long long)rows);
    atomicAdd(&a.stats[2], (unsigned long long)cells);
    atomicMax(&a.stats[3], (unsigned long long)longest);
    atomicAdd(&a.stats[kShared ? 4 : 5], (unsigned long long)jobs);
  }
}

// The launch's grid for a batch of n_ids jobs: kBlocksPerSm blocks an SM,
// or one where the batch has fewer blocks than kBlocksPerSm an SM, and no
// more than the jobs need.
cudaError_t launch_shape(int64_t n_ids, int& per_sm, int64_t& grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (sms <= 0) return cudaErrorInvalidValue;
  const int64_t need = (n_ids + kWarps - 1) / kWarps;
  per_sm = (int)max(min(need / sms, (int64_t)kBlocksPerSm), (int64_t)1);
  grid = min((int64_t)per_sm * sms, need);
  return cudaSuccess;
}

}  // namespace

// out[0..6]: warps a block, cells a lane, ring cells, the widest band a
// ring holds, and for a batch of n_ids jobs the blocks an SM and the grid;
// the static shared bytes a block of the rings' mode.
extern "C" int ibwa_extend_dp_info(long long n_ids, int* out) {
  int per_sm = 0;
  int64_t grid = 0;
  const cudaError_t e = launch_shape(n_ids, per_sm, grid);
  out[0] = kWarps;
  out[1] = kCells;
  out[2] = kRing;
  out[3] = kRingBand;
  out[4] = per_sm;
  out[5] = (int)grid;
  out[6] = (kWarps * kRing + 25) * (int)sizeof(uint32_t);
  return (int)e;
}

// tgt, qry: u8 blobs; tgt_off, qry_off: int64[n + 1]; g0, band: int32[n];
// ids: int32[n_ids], the jobs to run; matrix: 25 int32 on the host (copied
// into the launch's arguments); eh: null (the rings; every listed job's
// band <= kRingBand) or u32 scratch of tgt_off[n] + 12n + 4; out:
// int32[n, 3]; stats: u64[6], zeroed; max_blocks > 0 sets the grid (no
// more blocks than the jobs need) in place of the launch's own: the tests'
// small grids, the smoke's other blocks an SM.
extern "C" int ibwa_extend_dp(const void* tgt, const void* tgt_off,
                              const void* qry, const void* qry_off,
                              const void* g0, const void* band,
                              const void* ids, int n_ids, const void* matrix,
                              int gap_open, int gap_ext, void* eh, void* out,
                              void* stats, int max_blocks, void* stream) {
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
  int per_sm = 0;
  int64_t grid = 0;
  const cudaError_t e = launch_shape(n_ids, per_sm, grid);
  if (e != cudaSuccess) return (int)e;
  if (max_blocks > 0)
    grid = min((int64_t)max_blocks, ((int64_t)n_ids + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eh)
    extend_dp_kernel<false><<<(int)grid, kThreads, 0, s>>>(a);
  else
    extend_dp_kernel<true><<<(int)grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
