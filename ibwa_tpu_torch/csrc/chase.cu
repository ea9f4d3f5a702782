// K3 `chase` and K4 `chase_mw`: the dependent row-fetch probe.
//
// Replaces: scripts/bench_chase.py::chase_pallas (_chase_kernel) and
// ::chase_pallas_mw (_chase_mw_kernel), the two Pallas kernels that measure
// what a chain of dependent table-row fetches costs.
//
// What they compute: B independent lanes each follow
//     row = table[idx];  idx = (row[0] ^ it) % n_rows;  acc ^= row[1]
// for it = 0 .. steps-1, fetching the WHOLE roww-word row into fast memory
// each step (the row fetch is the thing being measured; words 0 and 1 are
// then read from shared memory).  Outputs: idx, acc as int32[B].
//
// Bound on an H100: the latency of dependent fetches.  A lane cannot ask
// for its next row before the last one has arrived, so a launch takes at
// least steps x (one row fetch's round trip: L2 for a table under 50 MB,
// HBM beyond).  Only with very many lanes does the byte rate of scattered
// rows (32 B sectors) take over.  The arithmetic (two xors and a remainder
// per row) is nothing.
//
// Design.  The TPU kernel keeps all B lanes in one invocation (one core,
// VMEM holds [1024, 128] words).  Here a block has at most 227 KB of shared
// memory and lanes are independent, so lanes are partitioned over blocks
// (`lpb` lanes a block, a constant of the wrapper), the step loop runs
// inside the kernel and nothing crosses blocks.  Rows come in with
// cp.async in 16-byte chunks, spread over the block's threads so that the
// chunks of one row sit in neighbouring threads.
//   K3 is the unpipelined shape: start every lane's row, wait for all,
//   __syncthreads(), compute, repeat.
//   K4 is the pipelined shape: the block's lanes form W waves, each wave's
//   copies are one cp.async commit group (the counterpart of the TPU
//   kernel's per-wave DMA semaphore), and the block waits only for the
//   oldest group while the W-1 younger ones fly.  cp.async.wait_group takes
//   an immediate, so at most 8 groups are left in flight: a larger W is
//   still right, it just overlaps no deeper.  Results equal K3's.
// The TPU kernel's `unroll` knob (the loop of its scalar core that starts
// the copies) has no counterpart here and is dropped.  The TPU multi-wave
// kernel starts one
// more round of fetches after the last step and drains it unused; here the
// last step starts none, so a launch fetches exactly B x steps rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's newest commit groups are
// still in flight (capped at 7: waiting for more than asked is still right).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Start the row fetches of lanes [first, first + count) of this block:
// chunk c of the count * cpr 16-byte chunks goes to thread c % blockDim.
__device__ __forceinline__ void fetch_rows(const uint32_t* __restrict__ table,
                                           uint32_t* rows, const int* s_idx,
                                           int first, int count, int roww) {
  const int cpr = roww >> 2;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < count * cpr; c += blockDim.x) {
    const int lane = first + c / cpr;
    const int j = (c % cpr) << 2;
    // 64-bit offset: 64 M rows x 32 B passes 2^31
    const uint64_t off = (uint64_t)(uint32_t)s_idx[lane] * (uint32_t)roww + j;
    cp_async16(rows + (size_t)lane * roww + j, table + off);
  }
}

// Dynamic shared memory: rows[lpb][roww] (16-byte aligned), then idx[lpb].
// Thread t < n owns lane t of the block: it keeps acc in a register and
// writes the lane's next index.

__global__ void chase_kernel(const uint32_t* __restrict__ table,
                             const int* __restrict__ idx0,
                             int* __restrict__ out_idx,
                             int* __restrict__ out_acc, int lanes, int lpb,
                             int roww, int steps, uint32_t n_rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rows = smem;
  int* s_idx = reinterpret_cast<int*>(smem + (size_t)lpb * roww);
  const int base = blockIdx.x * lpb;
  const int n = min(lpb, lanes - base);
  const int t = threadIdx.x;
  uint32_t acc = 0;
  if (t < n) s_idx[t] = idx0[base + t];
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    fetch_rows(table, rows, s_idx, 0, n, roww);
    cp_async_commit();
    cp_async_wait_pending(0);
    __syncthreads();  // every thread's chunks have landed
    if (t < n) {
      const uint32_t* r = rows + (size_t)t * roww;
      s_idx[t] = (int)((r[0] ^ (uint32_t)it) % n_rows);
      acc ^= r[1];
    }
    __syncthreads();  // next indices written, rows free to overwrite
  }
  if (t < n) {
    out_idx[base + t] = s_idx[t];
    out_acc[base + t] = (int)acc;
  }
}

__global__ void chase_mw_kernel(const uint32_t* __restrict__ table,
                                const int* __restrict__ idx0,
                                int* __restrict__ out_idx,
                                int* __restrict__ out_acc, int lanes, int lpb,
                                int roww, int steps, uint32_t n_rows,
                                int waves) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rows = smem;
  int* s_idx = reinterpret_cast<int*>(smem + (size_t)lpb * roww);
  const int base = blockIdx.x * lpb;
  const int n = min(lpb, lanes - base);
  const int lw = lpb / waves;  // lanes per wave
  const int t = threadIdx.x;
  uint32_t acc = 0;
  if (t < n) s_idx[t] = idx0[base + t];
  __syncthreads();
  // Wave w holds lanes [w * lw, (w + 1) * lw), cut at n.  Every thread
  // commits one group per wave and step, empty or not, so the count of
  // younger groups at each wait is the same everywhere: waves - 1.
  if (steps > 0) {
    for (int w = 0; w < waves; ++w) {
      const int first = w * lw;
      fetch_rows(table, rows, s_idx, first, max(0, min(lw, n - first)), roww);
      cp_async_commit();
    }
  }
  for (int it = 0; it < steps; ++it) {
    for (int w = 0; w < waves; ++w) {
      const int first = w * lw;
      const int count = max(0, min(lw, n - first));
      cp_async_wait_pending(waves - 1);  // the oldest group: wave w's
      __syncthreads();
      if (t >= first && t < first + count) {
        const uint32_t* r = rows + (size_t)t * roww;
        s_idx[t] = (int)((r[0] ^ (uint32_t)it) % n_rows);
        acc ^= r[1];
      }
      __syncthreads();
      // the next step's fetch of this wave flies while the others are
      // waited on and computed
      if (it + 1 < steps) fetch_rows(table, rows, s_idx, first, count, roww);
      cp_async_commit();
    }
  }
  cp_async_wait_pending(0);
  if (t < n) {
    out_idx[base + t] = s_idx[t];
    out_acc[base + t] = (int)acc;
  }
}

// Shared checks and launch geometry.  Returns 0 or a cudaError.
int geometry(int lanes, int lpb, int roww, int steps, int64_t n_rows,
             int* grid, size_t* smem) {
  if (lanes <= 0 || lpb <= 0 || lpb > kThreads || roww < 4 || roww % 4 ||
      steps < 0 || n_rows <= 0 || n_rows >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  *grid = (lanes + lpb - 1) / lpb;
  *smem = (size_t)lpb * roww * sizeof(uint32_t) + (size_t)lpb * sizeof(int);
  return 0;
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int ibwa_chase(const void* table, const void* idx0, void* out_idx,
                          void* out_acc, int lanes, int lpb, int roww,
                          int steps, int64_t n_rows, void* stream) {
  int grid;
  size_t smem;
  int rc = geometry(lanes, lpb, roww, steps, n_rows, &grid, &smem);
  if (rc) return rc;
  rc = allow_smem(chase_kernel, smem);
  if (rc) return rc;
  chase_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int*>(idx0),
      static_cast<int*>(out_idx), static_cast<int*>(out_acc), lanes, lpb,
      roww, steps, (uint32_t)n_rows);
  return (int)cudaGetLastError();
}

extern "C" int ibwa_chase_mw(const void* table, const void* idx0,
                             void* out_idx, void* out_acc, int lanes, int lpb,
                             int roww, int steps, int64_t n_rows, int waves,
                             void* stream) {
  int grid;
  size_t smem;
  int rc = geometry(lanes, lpb, roww, steps, n_rows, &grid, &smem);
  if (rc) return rc;
  if (waves <= 0 || lpb % waves) return (int)cudaErrorInvalidValue;
  rc = allow_smem(chase_mw_kernel, smem);
  if (rc) return rc;
  chase_mw_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const int*>(idx0),
      static_cast<int*>(out_idx), static_cast<int*>(out_acc), lanes, lpb,
      roww, steps, (uint32_t)n_rows, waves);
  return (int)cudaGetLastError();
}
