// Uniform draws of the counter-based streams (rng_fast.py) in one launch.
//
// Replaces no TPU kernel: the JAX package leaves its draws outside the
// Pallas kernels to XLA, which fuses the hash into one loop.  In eager
// PyTorch the same hash, fmix32(key ^ fmix32(ctr * GOLDEN)) carried in
// int64 under a 32-bit mask, is ~54 small integer operations, and the
// conversion to a real and the counter arithmetic ~6 more: ~60 launches
// for a batch of 1 to 3n uniforms.  This kernel computes the same bits
// (`uniform<T>` of sweeps_common.cuh, which the sweep kernels draw with)
// in one launch.  Caller: rng_fast.py `_uniforms`, through
// ops/cuda_lib.py launch_draw.
//
// out[l, j] (row-major [K, n]) is the uniform of lane l at counter
// position ctr[l / (K / C)] + base + offs[l] + j, mod 2^32.  ctr holds C
// counters (C = 1 for the 0-d counter of one chain); offs is null or a
// per-lane int64 offset [K].  The counter is read on the device, so nothing
// waits for the host.
//
// What bounds it on an H100: the launch.  A batch is at most a few
// thousand values (K = L lanes, or 3n values of the general stream), ~10
// bytes and ~20 integer operations each; one thread per value.
#include "sweeps_common.cuh"

// returned for a layout the kernel does not take
#define DRAW_ERR_SHAPE 9003
#define DRAW_THREADS 256

template <typename T>
__global__ void counter_draw_kernel(const i64* key, const i64* ctr,
                                    const i64* offs, i64 base,
                                    int lanes_per_chain, int K, int n,
                                    T* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * n) return;
  const int l = i / n, j = i - l * n;
  uint32_t c = (uint32_t)ctr[l / lanes_per_chain] + (uint32_t)base +
               (uint32_t)j;
  if (offs != nullptr) c += (uint32_t)offs[l];
  out[i] = uniform<T>((uint32_t)key[l], c);
}

template <typename T>
static int launch_counter_draw(const void* key, const void* ctr,
                               const void* offs, long long base, int K, int C,
                               int n, void* out, void* stream) {
  if (K < 1 || C < 1 || K % C != 0 || n < 1 ||
      (long long)K * n > 0x7FFFFFFF)
    return DRAW_ERR_SHAPE;
  const int total = K * n;
  SWEEP_LAUNCH_GRID(counter_draw_kernel<T>,
                    (total + DRAW_THREADS - 1) / DRAW_THREADS, DRAW_THREADS,
                    stream, (const i64*)key, (const i64*)ctr,
                    (const i64*)offs, (i64)base, K / C, K, n, (T*)out);
  return (int)cudaGetLastError();
}

#define COUNTER_DRAW_ENTRY(suffix, T)                                     \
  extern "C" int counter_draw_##suffix(const void* key, const void* ctr,  \
                                       const void* offs, long long base,  \
                                       int K, int C, int n, void* out,    \
                                       void* stream) {                    \
    return launch_counter_draw<T>(key, ctr, offs, base, K, C, n, out,     \
                                  stream);                                \
  }

COUNTER_DRAW_ENTRY(f32, float)
COUNTER_DRAW_ENTRY(f64, double)
