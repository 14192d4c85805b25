// Shared device code of the sweep kernels (node_age.cu, mig_age.cu,
// rubber_band.cu, spr.cu): the argument struct, the counter-based RNG,
// reflect, the Jukes-Cantor pruning combine with its x4 rescale, the
// root-path refresh and the root log-likelihood reduce.
//
// Device twins of the helpers of gphocs_tpu/ops/sweeps_pallas.py
// (_fmix32, _uniform, _rnd2normal8, _reflect, _edge_p, _combine_block,
// _refresh_path, _root_lnld) and of their plain PyTorch versions in
// gphocs_tpu_torch (rng_fast.py, utils.py, ops/pruning.py,
// ops/likelihood_cache.py).
//
// Layout: every per-locus array is row-major [L, ...] as in the PyTorch
// state (index arrays int64, masks bool, reals T = float or double); the
// conditionals are [L, N, P, 4].  One thread owns one locus.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

// Compile-time bounds of the per-thread scratch arrays (checked by the
// Python wrappers): nodes, migration slots, populations, bands, and the
// SPR boundary grid.
#define MAXN 63
#define MAXM 32
#define MAXPP 16
#define MAXB 8
#define MAXK (MAXN + MAXM + MAXPP + 2 * MAXB + 1)

// Must match gphocs_tpu_torch/ops/cuda_lib.py (PTR_FIELDS, INT_FIELDS).
struct SweepArgs {
  // state inputs
  const void* age; const void* lson; const void* rson; const void* father;
  const void* node_pop; const void* root;
  const void* mig_branch; const void* mig_band; const void* mig_age;
  const void* mut_rate; const void* valid;
  // sequence data
  const void* group_id; const void* group_count; const void* group_nphases;
  const void* pattern_valid;
  // popf = [theta, tau, pop_end (PP each), band start, end, rate (B each)]
  // popi = [father_pop (PP), band source, target (B each), anc (PP*PP)]
  const void* popf; const void* popi;
  const void* key; const void* ctr; const void* finetune;
  const void* rscal;  // rubber band: taub0, taub1, tauold, taunew
  const void* lnld_in; const void* lnp_in; const void* cond_in;
  // outputs and scratch
  void* cond_out; void* prop; void* gsum;
  void* age_out; void* lson_out; void* rson_out; void* father_out;
  void* node_pop_out; void* root_out;
  void* mig_branch_out; void* mig_band_out; void* mig_age_out;
  void* lnld_out; void* lnp_out; void* acc_out;
  void* aux0_out; void* aux1_out; void* aux2_out;
  // sample_age: rubber band in its sample-age mode (pop is a current pop)
  int L, N, M, B, PP, P, root_pop, pop, is_root, block, sample_age;
  double oldage;
};

template <typename T>
struct PopTables {
  const T* theta; const T* tau; const T* pend;
  const T* bs; const T* be; const T* rate;
  const i64* father_pop; const i64* bsrc; const i64* btgt;
  const i64* anc;  // anc[i * PP + j]: i ancestor-or-self of j
  int PP, B;
  __device__ PopTables(const SweepArgs& a) : PP(a.PP), B(a.B) {
    const T* f = (const T*)a.popf;
    theta = f; tau = f + PP; pend = f + 2 * PP;
    bs = f + 3 * PP; be = bs + B; rate = be + B;
    const i64* p = (const i64*)a.popi;
    father_pop = p; bsrc = p + PP; btgt = bsrc + B; anc = btgt + B;
  }
  __device__ bool is_anc(int i, int j) const { return anc[i * PP + j] != 0; }
};

// ---- math overloads ------------------------------------------------------
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_floor(float x) { return floorf(x); }
__device__ __forceinline__ double d_floor(double x) { return floor(x); }
template <typename T> __device__ __forceinline__ T d_min(T a, T b) {
  return a < b ? a : b;
}
template <typename T> __device__ __forceinline__ T d_max(T a, T b) {
  return a > b ? a : b;
}
template <typename T> __device__ __forceinline__ T d_abs(T a) {
  return a < (T)0 ? -a : a;
}
template <typename T> __device__ __forceinline__ T d_inf() {
  return (T)INFINITY;
}

// ---- counter-based RNG (rng_fast.py) -------------------------------------
#define GOLDEN 0x9E3779B9u

__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

template <typename T> __device__ T bits_to_unit(uint32_t x);
// f32: exponent bitcast into [1, 2), shifted to (0, 1) by an exact
// subtraction (rng_fast.bits_to_unit)
template <> __device__ __forceinline__ float bits_to_unit<float>(uint32_t x) {
  return __uint_as_float((x >> 9) | 0x3F800000u) - 0.99999994039535522f;
}
// f64: midpoint lattice (x + 0.5) / 2^32
template <> __device__ __forceinline__ double bits_to_unit<double>(
    uint32_t x) {
  return ((double)x + 0.5) * 2.3283064365386963e-10;
}

// U(0,1) of lane `key` at absolute counter position c
template <typename T>
__device__ __forceinline__ T uniform(uint32_t key, uint32_t c) {
  return bits_to_unit<T>(fmix32(key ^ fmix32(c * GOLDEN)));
}

// mixture-of-two-normals proposal from draws c+1, c+2, c+3
template <typename T>
__device__ T rnd2normal8(uint32_t key, uint32_t c) {
  const T m2n = (T)sqrt(8.0 / 9.0);
  const T s2n = (T)sqrt(1.0 / 9.0);
  T u1 = uniform<T>(key, c + 1);
  T u2 = uniform<T>(key, c + 2);
  T u3 = uniform<T>(key, c + 3);
  T nrm = d_sqrt((T)-2.0 * d_log(u1)) *
          d_cos((T)(2.0 * 3.141592653589793) * u2);
  T zval = m2n + nrm * s2n;
  return u3 < (T)0.5 ? zval : -zval;
}

template <typename T>
__device__ __forceinline__ bool mh(T lnacc, T u) {
  return lnacc >= (T)0 || u < d_exp(d_min(lnacc, (T)0));
}

// ---- reflect into (a, b) with the 1e-9 slack (utils.reflect) ------------
// The fixup loop is bounded at 3 alternating steps (a no-op once inside).
template <typename T>
__device__ T reflect(T x, T a, T b) {
  a = a + (T)1e-9;
  b = b - (T)1e-9;
  bool empty = b <= a;
  T a_s = empty ? (T)0 : a;
  T b_s = empty ? (T)1 : b;
  bool inside = (x < b_s) && (x > a_s);
  T xnew = x <= a_s ? (T)2 * a_s - x : x;
  T dbl = (T)2 * (b_s - a_s);
  xnew = xnew - dbl * d_floor((xnew - a_s) / dbl);
  xnew = xnew >= b_s ? (T)2 * b_s - xnew : xnew;
  for (int k = 0; k < 3; ++k) {
    xnew = xnew >= b_s ? (T)2 * b_s - xnew : xnew;
    xnew = xnew <= a_s ? (T)2 * a_s - xnew : xnew;
  }
  return empty ? (a + b) / (T)2 : (inside ? x : xnew);
}

// ---- Jukes-Cantor pruning ------------------------------------------------
// Edge probability, p = 0 below an edge length of 1e-100: the XLA value of
// gphocs_tpu/ops/pruning.py, shared with the plain versions (the Pallas
// kernels used 1e-30).  In f32 the constant rounds to 0.
template <typename T>
__device__ __forceinline__ T edge_p(T len) {
  T p = ((T)1 - d_exp((T)-4 * len / (T)3)) / (T)4;
  return len < (T)1e-100 ? (T)0 : p;
}

// out[P, 4] = 4 * JC(ca, pa) * JC(cb, pb) (the x4 Felsenstein rescale)
template <typename T>
__device__ void jc_combine(T* out, const T* ca, const T* cb, T pa, T pb,
                           int P) {
  const T qa = (T)1 - (T)4 * pa, qb = (T)1 - (T)4 * pb;
  for (int p = 0; p < P; ++p) {
    const T* x = ca + 4 * p;
    const T* y = cb + 4 * p;
    T sa = ((x[0] + x[1]) + x[2]) + x[3];
    T sb = ((y[0] + y[1]) + y[2]) + y[3];
    for (int k = 0; k < 4; ++k) {
      T fa = pa * sa + qa * x[k];
      T fb = pb * sb + qb * y[k];
      out[4 * p + k] = (T)4 * fa * fb;
    }
  }
}

// recompute internal node n of `cond` ([N, P, 4] of one locus)
template <typename T>
__device__ __forceinline__ void recompute_node(T* cond, int n,
                                               const int* lson,
                                               const int* rson, const T* age,
                                               T mut, int P) {
  int ls = lson[n], rs = rson[n];
  T pa = edge_p(mut * (age[n] - age[ls]));
  T pb = edge_p(mut * (age[n] - age[rs]));
  jc_combine(cond + (size_t)n * P * 4, cond + (size_t)ls * P * 4,
             cond + (size_t)rs * P * 4, pa, pb, P);
}

// recompute the path start -> root in `cond`; returns the dirty-row mask
template <typename T>
__device__ uint64_t refresh_path(T* cond, int start, const int* lson,
                                 const int* rson, const int* father,
                                 const T* age, T mut, int N, int S, int P) {
  uint64_t dirty = 0;
  int cur = start;
  for (int step = 0; cur >= 0 && step < N; ++step) {
    if (cur >= S) {
      recompute_node(cond, cur, lson, rson, age, mut, P);
      dirty |= 1ull << cur;
    }
    cur = father[cur];
  }
  return dirty;
}

// copy the rows of `mask` from src to dst ([N, P, 4] of one locus)
template <typename T>
__device__ void copy_rows(T* dst, const T* src, uint64_t mask, int P) {
  while (mask) {
    int n = __ffsll((long long)mask) - 1;
    mask &= mask - 1;
    const T* s = src + (size_t)n * P * 4;
    T* d = dst + (size_t)n * P * 4;
    for (int j = 0; j < 4 * P; ++j) d[j] = s[j];
  }
}

// per-locus data log-likelihood from the root conditional
// (ops/likelihood_cache.lnld_from_cond); gsum: [P] scratch
template <typename T>
__device__ T root_lnld(const T* cond, int root, const i64* gid,
                       const T* gcount, const T* gnph, const bool* pvalid,
                       T* gsum, int S, int P) {
  const T* rc = cond + (size_t)root * P * 4;
  for (int g = 0; g < P; ++g) gsum[g] = (T)0;
  for (int p = 0; p < P; ++p) {
    if (pvalid[p]) {
      const T* x = rc + 4 * p;
      gsum[gid[p]] += ((x[0] + x[1]) + x[2]) + x[3];
    }
  }
  const T c = (T)((S - 1) * 1.3862943611198906);  // (S-1) log 4
  T lnl = (T)0;
  for (int g = 0; g < P; ++g) {
    T safe = gcount[g] > (T)0 ? gsum[g] : (T)1;
    lnl += gcount[g] * (d_log(safe) - d_log((T)4 * gnph[g]) - c);
  }
  return lnl;
}

// first (min) and last (max) active migration age on edge n; +-inf if none
template <typename T>
__device__ __forceinline__ T first_mig_on(int n, const int* mbr,
                                          const T* mag, int M) {
  T best = d_inf<T>();
  for (int m = 0; m < M; ++m)
    if (mbr[m] >= 0 && mbr[m] == n) best = d_min(best, mag[m]);
  return best;
}

template <typename T>
__device__ __forceinline__ T last_mig_on(int n, const int* mbr, const T* mag,
                                         int M) {
  T best = -d_inf<T>();
  for (int m = 0; m < M; ++m)
    if (mbr[m] >= 0 && mbr[m] == n) best = d_max(best, mag[m]);
  return best;
}

// age of the next active migration above slot m on its branch (ties by
// slot id), +inf if none (ops/coalstats.segments)
template <typename T>
__device__ __forceinline__ T next_mig_above(int m, const int* mbr,
                                            const T* mag, int M) {
  T best = d_inf<T>();
  if (mbr[m] < 0) return best;
  for (int m2 = 0; m2 < M; ++m2) {
    if (m2 == m || mbr[m2] < 0 || mbr[m2] != mbr[m]) continue;
    if (mag[m2] > mag[m] || (mag[m2] == mag[m] && m2 > m))
      best = d_min(best, mag[m2]);
  }
  return best;
}

// Segment set of one locus (ops/coalstats.segments): N edge segments,
// then M migration segments.  root_top: the root's virtual edge top.
template <typename T>
struct Segs {
  T start[MAXN + MAXM], end[MAXN + MAXM];
  int base[MAXN + MAXM];
  bool valid[MAXN + MAXM];
  int n;
  __device__ void build(const T* age, const int* father, const int* npop,
                        const int* mbr, const int* mbd, const T* mag,
                        const PopTables<T>& pt, T root_top, int N, int M) {
    T top[MAXN];
    for (int v = 0; v < N; ++v)
      top[v] = father[v] < 0 ? root_top : age[father[v]];
    for (int v = 0; v < N; ++v) {
      start[v] = age[v];
      end[v] = d_min(top[v], first_mig_on(v, mbr, mag, M));
      base[v] = npop[v];
      valid[v] = true;
    }
    for (int m = 0; m < M; ++m) {
      bool act = mbr[m] >= 0;
      start[N + m] = act ? mag[m] : (T)0;
      end[N + m] = act ? d_min(next_mig_above(m, mbr, mag, M), top[mbr[m]])
                       : (T)0;
      base[N + m] = (act && pt.B > 0) ? (int)pt.bsrc[mbd[m]] : 0;
      valid[N + m] = act;
    }
    n = N + M;
  }
};

__device__ __forceinline__ void load_int(int* dst, const i64* src, int n) {
  for (int j = 0; j < n; ++j) dst[j] = (int)src[j];
}

template <typename T>
__device__ __forceinline__ void copy_real(T* dst, const T* src, size_t n) {
  for (size_t j = 0; j < n; ++j) dst[j] = src[j];
}

// One C entry point per kernel and real type: launch on `stream`, return
// cudaGetLastError().  SWEEP_LAUNCH is the launch itself; the CPU tests
// (tests/test_torch_csrc_host.py) compile these sources with a host C++
// compiler and define it to run every locus as a one-thread block in turn.
#ifndef SWEEP_LAUNCH
#define SWEEP_LAUNCH(K, a, stream)                                         \
  K<<<(a->L + a->block - 1) / a->block, a->block, 0,                        \
      (cudaStream_t)stream>>>(*a)
#endif

#define SWEEP_ENTRY(name, kernel)                                          \
  extern "C" int name##_f32(const SweepArgs* a, void* stream) {            \
    SWEEP_LAUNCH(kernel<float>, a, stream);                                \
    return (int)cudaGetLastError();                                        \
  }                                                                        \
  extern "C" int name##_f64(const SweepArgs* a, void* stream) {            \
    SWEEP_LAUNCH(kernel<double>, a, stream);                               \
    return (int)cudaGetLastError();                                        \
  }
