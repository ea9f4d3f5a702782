// A stand-in for the CUDA runtime, enough of it to compile the kernels of
// ibwa_tpu_torch/csrc with g++ and run them on the CPU, so that a source can
// be rehearsed against its plain version where there is no nvcc and no card.
//
// How a kernel runs here: blocks one after another; the threads of a block
// as cooperative fibers (ucontext) of one OS thread, switched only at a
// collective.  Every warp collective (__ballot_sync, __any_sync, the
// shuffles, __syncwarp) is a barrier of the 32 threads of its warp that
// exchanges one value per thread; __syncthreads() is a barrier of the block.
// A collective that not all of its threads reach (divergence, an early
// return of part of a warp) ends the process with a message instead of
// hanging.  Dynamic shared memory is one buffer per block, filled with a
// pattern, static __shared__ arrays are function statics (blocks do not
// overlap).  It finds wrong arithmetic, wrong indexing and divergent
// collectives; it does not find what nvcc refuses, races between threads
// that miss a barrier, or anything about speed.
//
// The sources need two rewrites before they compile (tests/test_torch_chunk
// .py::standin_source does both):
//   kernel<<<grid, block, smem, stream>>>(args);
//     -> cuda_standin::launch(grid, block, smem, stream,
//                             [&] { kernel(args); });
//   extern __shared__ T name[];
//     -> T* name = (T*)cuda_standin::dynamic_smem();
#ifndef IBWA_CUDA_STANDIN_RUNTIME_H
#define IBWA_CUDA_STANDIN_RUNTIME_H

#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct uint2 {
  unsigned x, y;
};
struct uint3 {
  unsigned x, y, z;
};
struct uint4 {
  unsigned x, y, z, w;
};

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace cuda_standin {

constexpr size_t kStackBytes = 256 * 1024;

struct Fiber {
  ucontext_t ctx;
  uint3 tid;
  int warp, lane;
  long warp_gen, block_gen;  // collectives this thread has arrived at
  bool finished;
};

struct Warp {
  uint64_t slot[2][32];
  long arrivals;
};

struct Block {
  std::vector<Fiber> fibers;
  std::vector<Warp> warps;
  std::vector<char> stacks, smem;
  const std::function<void()>* body;
  ucontext_t scheduler;
  Fiber* cur;
  long sync_arrivals;
  bool progress;
  uint3 bid, bdim, gdim;
};

inline Block& block() {
  static Block b;
  return b;
}

inline void* dynamic_smem() { return block().smem.data(); }

inline void yield() {
  Block& b = block();
  swapcontext(&b.cur->ctx, &b.scheduler);
}

// Deposit one value for this thread's next warp collective, wait for the
// other 31, and return the 32 deposited values.  Two sets of slots: a thread
// can be one collective ahead of the slowest of its warp, not two.
inline const uint64_t* exchange(uint64_t mine) {
  Block& b = block();
  Fiber& f = *b.cur;
  Warp& w = b.warps[f.warp];
  const long gen = f.warp_gen++;
  w.slot[gen & 1][f.lane] = mine;
  ++w.arrivals;
  while (w.arrivals < (gen + 1) * 32) yield();
  b.progress = true;
  return w.slot[gen & 1];
}

inline void trampoline() {
  Block& b = block();
  (*b.body)();
  b.cur->finished = true;
  b.progress = true;
}

inline void launch(int grid, int threads, size_t smem_bytes, cudaStream_t,
                   const std::function<void()>& body) {
  Block& b = block();
  if (grid <= 0 || threads <= 0 || threads % 32) {
    std::fprintf(stderr, "cuda_standin: launch of %d x %d threads\n", grid,
                 threads);
    std::abort();
  }
  b.body = &body;
  b.bdim = {(unsigned)threads, 1, 1};
  b.gdim = {(unsigned)grid, 1, 1};
  b.fibers.resize(threads);
  b.warps.resize(threads / 32);
  b.stacks.resize((size_t)threads * kStackBytes);
  for (int g = 0; g < grid; ++g) {
    b.bid = {(unsigned)g, 0, 0};
    b.smem.assign(smem_bytes + 16, (char)0xCD);
    b.sync_arrivals = 0;
    for (Warp& w : b.warps) w.arrivals = 0;
    for (int t = 0; t < threads; ++t) {
      Fiber& f = b.fibers[t];
      f.tid = {(unsigned)t, 0, 0};
      f.warp = t / 32;
      f.lane = t % 32;
      f.warp_gen = f.block_gen = 0;
      f.finished = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = b.stacks.data() + (size_t)t * kStackBytes;
      f.ctx.uc_stack.ss_size = kStackBytes;
      f.ctx.uc_link = &b.scheduler;
      makecontext(&f.ctx, trampoline, 0);
    }
    for (;;) {
      int live = 0;
      b.progress = false;
      for (Fiber& f : b.fibers) {
        if (f.finished) continue;
        ++live;
        b.cur = &f;
        swapcontext(&b.scheduler, &f.ctx);
      }
      if (!live) break;
      if (!b.progress) {
        std::fprintf(stderr,
                     "cuda_standin: block %d hangs: %d threads wait at a "
                     "collective the others never reach\n", g, live);
        std::abort();
      }
    }
  }
}

template <class T>
inline uint64_t to_bits(T v) {
  static_assert(sizeof(T) <= 8, "a collective exchanges at most 8 bytes");
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}

template <class T>
inline T from_bits(uint64_t u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}

}  // namespace cuda_standin

#define threadIdx (cuda_standin::block().cur->tid)
#define blockIdx (cuda_standin::block().bid)
#define blockDim (cuda_standin::block().bdim)
#define gridDim (cuda_standin::block().gdim)

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline void __syncwarp(unsigned = 0xFFFFFFFFu) { cuda_standin::exchange(0); }

inline void __syncthreads() {
  cuda_standin::Block& b = cuda_standin::block();
  const long gen = b.cur->block_gen++;
  ++b.sync_arrivals;
  while (b.sync_arrivals < (gen + 1) * (long)b.fibers.size())
    cuda_standin::yield();
  b.progress = true;
}

inline unsigned __ballot_sync(unsigned, int pred) {
  const uint64_t* s = cuda_standin::exchange(pred ? 1 : 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)(s[i] & 1) << i;
  return m;
}

inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  const uint64_t* s = cuda_standin::exchange(cuda_standin::to_bits(v));
  return cuda_standin::from_bits<T>(s[src & 31]);
}

template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const int lane = cuda_standin::block().cur->lane;
  const uint64_t* s = cuda_standin::exchange(cuda_standin::to_bits(v));
  const int src = lane - (int)delta;
  return cuda_standin::from_bits<T>(s[src < 0 ? lane : src]);
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int lane = cuda_standin::block().cur->lane;
  const uint64_t* s = cuda_standin::exchange(cuda_standin::to_bits(v));
  return cuda_standin::from_bits<T>(s[(lane ^ lane_mask) & 31]);
}

inline int __reduce_min_sync(unsigned, int v) {
  const uint64_t* s = cuda_standin::exchange(cuda_standin::to_bits(v));
  int least = cuda_standin::from_bits<int>(s[0]);
  for (int i = 1; i < 32; ++i) {
    const int other = cuda_standin::from_bits<int>(s[i]);
    if (other < least) least = other;
  }
  return least;
}

inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

template <class A, class B>
inline typename std::common_type<A, B>::type min(A a, B b) {
  typedef typename std::common_type<A, B>::type C;
  return (C)a < (C)b ? (C)a : (C)b;
}

template <class A, class B>
inline typename std::common_type<A, B>::type max(A a, B b) {
  typedef typename std::common_type<A, B>::type C;
  return (C)a > (C)b ? (C)a : (C)b;
}

// threads never run at the same time here, so an atomic is its plain form
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}

inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  if (v > old) *p = v;
  return old;
}

#endif  // IBWA_CUDA_STANDIN_RUNTIME_H
