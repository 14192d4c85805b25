// Host stand-in for <cuda_runtime.h>: lets a host C++ compiler build
// gphocs_tpu_torch/csrc/*.cu for tests/test_torch_csrc_host.py.
//
// The loci run one after another, chain after chain (the grid's second
// axis).  Every sweep kernel runs a warp per locus (the draw kernel of
// counter_draw.cu is a plain grid, SWEEP_LAUNCH_GRID, whose threads run
// one after another):
// the stand-in runs each locus as one "warp" of a block of a->block loci,
// with the block's dynamic shared memory an ordinary buffer (filled with
// 0xA5, not zeros) carved up by the kernel as on the card.  That warp is a
// single lane which runs every index of a LANES section in a plain loop, so
// the warp reductions return their argument and the barriers do nothing;
// with -DSWEEP_REVERSE_LANES the loops run backwards, which changes the
// result of a section whose body reads what another index of it writes.
// The block's static shared memory (the population tables) is a static that
// every warp fills again; the size the runtime reports for it is set by the
// test.  Build with -ffp-contract=off, the host twin of
// the kernels' -fmad=false.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define SWEEP_HOST 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static

typedef void* cudaStream_t;

struct HostDim3 {
  unsigned x, y;
};
static HostDim3 blockIdx, blockDim, threadIdx;
static unsigned char* sweep_smem;

#ifdef SWEEP_REVERSE_LANES
#define LANES(j, n) for (int j = (n) - 1; j >= 0; --j)
#else
#define LANES(j, n) for (int j = 0; j < (n); ++j)
#endif
#define ONE_LANE if (true)
#define BLOCK_THREADS(j, n) LANES(j, n)

inline void __syncthreads() {}
inline int __reduce_add_sync(unsigned, int x) { return x; }
inline int __reduce_min_sync(unsigned, int x) { return x; }
inline int atomicAdd(int* p, int x) { int old = *p; *p += x; return old; }
inline int atomicMax(int* p, int x) {
  int old = *p;
  if (x > old) *p = x;
  return old;
}
inline float __uint_as_float(uint32_t x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int cudaGetLastError() { return 0; }

// A kernel's attributes: its static shared memory is what the test set
// (host_set_static_smem in pop_tables_probe.cu, 0 unless set), and each
// read is counted; the last opt-in to more dynamic shared memory is kept.
extern int host_static_smem, host_attr_reads, host_opt_in_bytes;
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K>
inline int cudaFuncGetAttributes(cudaFuncAttributes* f, K) {
  ++host_attr_reads;
  f->sharedSizeBytes = (size_t)host_static_smem;
  return 0;
}
template <typename K>
inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  host_opt_in_bytes = bytes;
  return 0;
}
using std::isfinite;

#define SWEEP_LAUNCH_WARP(K, a, stream)                                   \
  do {                                                                    \
    (void)(stream);                                                       \
    const int lpb_ = (a)->block;                                          \
    std::vector<unsigned char> buf_((a)->smem_bytes + 16, 0xA5);          \
    sweep_smem = buf_.data() + (16 - (uintptr_t)buf_.data() % 16) % 16;   \
    for (int c_ = 0; c_ < (a)->C; ++c_)                                   \
      for (int b_ = 0; b_ * lpb_ < (a)->Lc; ++b_)                         \
        for (int w_ = 0; w_ < lpb_; ++w_) {                               \
          blockIdx.x = b_;                                                \
          blockIdx.y = c_;                                                \
          blockDim.x = 32 * lpb_;                                         \
          threadIdx.x = 32 * w_;                                          \
          K(*(a));                                                        \
        }                                                                 \
  } while (0)

// A plain grid (counter_draw.cu): every thread of every block in turn.
#define SWEEP_LAUNCH_GRID(K, blocks, threads, stream, ...)                \
  do {                                                                    \
    (void)(stream);                                                       \
    for (unsigned b_ = 0; b_ < (unsigned)(blocks); ++b_)                  \
      for (unsigned t_ = 0; t_ < (unsigned)(threads); ++t_) {             \
        blockIdx.x = b_;                                                  \
        blockIdx.y = 0;                                                   \
        blockDim.x = (threads);                                           \
        threadIdx.x = t_;                                                 \
        K(__VA_ARGS__);                                                   \
      }                                                                   \
  } while (0)
