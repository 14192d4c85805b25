// Host stand-in for <cuda_runtime.h>: lets a host C++ compiler build
// gphocs_tpu_torch/csrc/*.cu for tests/test_torch_csrc_host.py.
//
// Every locus runs as a one-thread block, one after another, so
// __syncthreads_or(p) is p and the SPR kernel's trip schedule is that of
// kernels/spr.update_spr(sync_group=1).  Build with -ffp-contract=off, the
// host twin of the kernels' -fmad=false.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __forceinline__ inline

typedef void* cudaStream_t;

struct HostDim3 {
  unsigned x;
};
static HostDim3 blockIdx, blockDim, threadIdx;

inline int __syncthreads_or(int p) { return p; }
inline float __uint_as_float(uint32_t x) {
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int cudaGetLastError() { return 0; }
using std::isfinite;

#define SWEEP_LAUNCH(K, a, stream)                 \
  do {                                             \
    (void)(stream);                                \
    for (int b_ = 0; b_ < (a)->L; ++b_) {          \
      blockIdx.x = b_;                             \
      blockDim.x = 1;                              \
      threadIdx.x = 0;                             \
      K(*(a));                                     \
    }                                              \
  } while (0)
