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
// conditionals are [L, N, P, 4].  A state of C chains is chain-major: its
// L = C * Lc loci are chain 0's Lc loci, then chain 1's, ...; theta and tau
// are [C, PP], the migration rates [C, B], the per-locus streams' counter
// [C] (one chain: C = 1, Lc = L).  The grid's second axis is the chain, so
// a block's loci are one chain's and its population tables are that
// chain's.
//
// One launch shape: every kernel runs one warp per locus, `block` loci per
// block, with every per-locus table in dynamic shared memory
// (SWEEP_LAUNCH_WARP): the lanes take the axes that are parallel inside a
// locus, through the LANES / ONE_LANE sections below.  All four keep the
// population tables in static shared memory, filled by the block from the
// state's theta, tau and migration rates (PopTables::load).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

// Compile-time bounds (checked by the Python wrappers): nodes (a locus's
// dirty rows are a 64-bit mask), populations and bands (the population
// tables, and the ancestor relation as 32-bit rows).  The per-locus tables
// are sized from the run's N, M, P.
#define MAXN 63
#define MAXPP 16
#define MAXB 8

// what a block may use of an SM's shared memory, static part included
#define SMEM_LIMIT 232448
// returned by a warp-per-locus entry point whose caller's shared-memory
// size (SweepArgs.smem_bytes) is not what the kernel's layout needs
#define SWEEP_ERR_SMEM 9001
// returned for a chain layout that does not cover the loci (C * Lc != L)
#define SWEEP_ERR_CHAINS 9002

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
  // population parameters as the state holds them: theta [C, PP], tau
  // [C, PP], mig_rate [C, B]; popi = [father_pop (PP), band source, target
  // (B each), anc (PP*PP), admixed leaf, its first pop, its second pop (A
  // each)], int64, constant for a run.  ctr: [C].
  const void* theta; const void* tau; const void* mig_rate; const void* popi;
  const void* key; const void* ctr; const void* finetune;
  // rubber band: the proposal's four reals, one per chain ([C])
  const void* taub0; const void* taub1; const void* tauold;
  const void* taunew;
  const void* lnld_in; const void* lnp_in; const void* cond_in;
  // outputs and scratch
  void* cond_out; void* prop;
  void* age_out; void* lson_out; void* rson_out; void* father_out;
  void* node_pop_out; void* root_out;
  void* mig_branch_out; void* mig_band_out; void* mig_age_out;
  // acc_out: node age, migration age: int64 [L] accepts per locus
  void* lnld_out; void* lnp_out; void* acc_out;
  // node age, migration age: each chain's counter after the sweep,
  // (ctr[c] + advance) mod 2^32, written by the kernel (advance_counter)
  void* ctr_out;
  // int32 sums over each chain's valid loci, zeroed by the wrapper.  Rubber
  // band: [C, 3] = [ntj0, ntj1, conflicts]; SPR: [C, 2] = [accepts,
  // largest draw offset].
  void* stat;
  // a kernel built with -DSWEEP_PROFILE: [L, 16] int64 cycle counts, or
  // null
  void* prof;
  // the admixture coefficients [C, A] (null where A = 0)
  const void* admix_coeff;
  // sample_age: rubber band in its sample-age mode (pop is a current pop).
  // block: loci per block.  cond_smem: the locus's conditionals live in
  // shared memory (else in cond_out / prop).
  // smem_bytes: dynamic shared memory of one block.
  // advance: the draws a sweep of fixed length takes from the counter.
  // C: chains; Lc: loci per chain (L = C * Lc).  A: admixed leaves.
  int L, N, M, B, PP, P, root_pop, pop, is_root, block, sample_age,
      cond_smem, smem_bytes, advance, C, Lc, A;
  double oldage;
};

// ---- lanes ----------------------------------------------------------------
// A kernel is written in sections.  LANES(j, n) { ... } runs
// its body for every j < n, strided over the warp's lanes; ONE_LANE { ... }
// runs its body on lane 0.  Both are fenced by __syncwarp() before and
// after, so a section sees everything written before it, and shared memory
// is written only inside sections.  A body must not read what another
// index of the same section writes.  Outside sections every lane computes
// the same scalars from the same shared data (warp-uniform control flow).
// The host build of the tests (tests/cuda_host) defines SWEEP_HOST: one
// "lane" runs every index in a plain loop, forwards or (to catch a body
// that depends on another index of its section) backwards.
#ifndef SWEEP_HOST
#define LANES(j, n)                                                     \
  for (int s_ = (__syncwarp(), 0); s_ < 1; ++s_, __syncwarp())            \
    for (int j = lane; j < (n); j += 32)
#define ONE_LANE                                                         \
  for (int s_ = (__syncwarp(), 0); s_ < 1; ++s_, __syncwarp())            \
    if (lane == 0)
#define BLOCK_THREADS(j, n)                                              \
  for (int j = threadIdx.x; j < (n); j += blockDim.x)
extern __shared__ __align__(16) unsigned char sweep_smem[];
#endif

// integer reductions over the warp (any order gives the same result)
__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(0xffffffffu, x);
}
__device__ __forceinline__ int warp_min(int x) {
  return __reduce_min_sync(0xffffffffu, x);
}

template <typename T>
struct PopTables {
  T theta[MAXPP], tau[MAXPP], pend[MAXPP];
  T bs[MAXB], be[MAXB], rate[MAXB];
  int father_pop[MAXPP], bsrc[MAXB], btgt[MAXB];
  // i ancestor-or-self of j: bit j of ancrow[i] and bit i of anccol[j]
  unsigned ancrow[MAXPP], anccol[MAXPP];
  int PP, B;
  __device__ bool is_anc(int i, int j) const {
    return (ancrow[i] >> j) & 1u;
  }

  // Fill the tables of a __shared__ instance with chain c's parameters,
  // all threads of the block together (two block barriers inside).  With
  // `proposal`, tau[a.pop] is the chain's a.taunew: the rubber band's
  // proposed tau.  pop_end and the band windows follow from tau as
  // kernels/common.py pop_end and band_windows compute them (a collapsed
  // band, start >= end, sits at its target's tau): max, min and compare
  // only, so the same bits.
  __device__ void load(const SweepArgs& a, bool proposal, int c) {
    const int np = a.PP, nb = a.B;
    const i64* pi = (const i64*)a.popi;
    const T* th = (const T*)a.theta + (size_t)c * np;
    const T* ta = (const T*)a.tau + (size_t)c * np;
    const T* mr = (const T*)a.mig_rate + (size_t)c * nb;
    BLOCK_THREADS(j, np) {
      theta[j] = th[j];
      tau[j] = (proposal && j == a.pop) ? ((const T*)a.taunew)[c] : ta[j];
      father_pop[j] = (int)pi[j];
    }
    BLOCK_THREADS(b, nb) {
      rate[b] = mr[b];
      bsrc[b] = (int)pi[np + b];
      btgt[b] = (int)pi[np + nb + b];
    }
    BLOCK_THREADS(i, np) {
      const i64* anc = pi + np + 2 * nb;
      unsigned row = 0, col = 0;
      for (int j = 0; j < np; ++j) {
        row |= (anc[i * np + j] != 0 ? 1u : 0u) << j;
        col |= (anc[j * np + i] != 0 ? 1u : 0u) << j;
      }
      ancrow[i] = row;
      anccol[i] = col;
    }
    BLOCK_THREADS(j, 1) { PP = np; B = nb; }
    __syncthreads();
    BLOCK_THREADS(j, np)
      pend[j] = father_pop[j] < 0 ? (T)a.oldage : tau[father_pop[j]];
    BLOCK_THREADS(b, nb) {
      const int s = bsrc[b], t = btgt[b];
      int fs = father_pop[s], ft = father_pop[t];
      fs = fs < 0 ? fs + np : fs;  // a negative index counts from the end
      ft = ft < 0 ? ft + np : ft;
      const T st = tau[s] > tau[t] ? tau[s] : tau[t];
      const T en = tau[fs] < tau[ft] ? tau[fs] : tau[ft];
      const bool collapsed = st >= en;
      bs[b] = collapsed ? tau[t] : st;
      be[b] = collapsed ? tau[t] : en;
    }
    __syncthreads();
  }
};

// ---- math overloads ------------------------------------------------------
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double d_log1p(double x) { return log1p(x); }
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

// Chain c's counter after a sweep whose length does not depend on the
// data (rng_fast: ctr + n mod 2^32), written by the first lane of the
// chain's first locus (li, its index within the chain), so that the wrapper
// launches no tensor operation for it.
__device__ __forceinline__ void advance_counter(const SweepArgs& a, int c,
                                                int li, int lane) {
  if (li == 0 && lane == 0)
    ((i64*)a.ctr_out)[c] = (i64)(((uint64_t)((const i64*)a.ctr)[c] +
                                  (uint64_t)a.advance) & 0xFFFFFFFFull);
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

// ---- the conditionals of one locus ---------------------------------------
// `cond` is one locus's [N, P, 4] conditionals, in shared memory or (where
// a locus does not fit) in device memory; a row is contiguous either way.
// Every lane passes the same arguments.

// recompute internal node n, out[P, 4] = 4 * JC(ca, pa) * JC(cb, pb) (the
// x4 Felsenstein rescale): the P x 4 outputs over the lanes
template <typename T>
__device__ __forceinline__ void recompute_node_w(T* cond, int n,
                                                 const int* lson,
                                                 const int* rson,
                                                 const T* age, T mut, int P,
                                                 int lane) {
  const int ls = lson[n], rs = rson[n];
  const T pa = edge_p(mut * (age[n] - age[ls]));
  const T pb = edge_p(mut * (age[n] - age[rs]));
  const T qa = (T)1 - (T)4 * pa, qb = (T)1 - (T)4 * pb;
  T* out = cond + (size_t)n * P * 4;
  const T* ca = cond + (size_t)ls * P * 4;
  const T* cb = cond + (size_t)rs * P * 4;
  LANES(j, 4 * P) {
    const T* x = ca + (j & ~3);
    const T* y = cb + (j & ~3);
    const T sa = ((x[0] + x[1]) + x[2]) + x[3];
    const T sb = ((y[0] + y[1]) + y[2]) + y[3];
    const T fa = pa * sa + qa * ca[j];
    const T fb = pb * sb + qb * cb[j];
    out[j] = (T)4 * fa * fb;
  }
}

// recompute the path start -> root, one node after another; returns the
// dirty-row mask
template <typename T>
__device__ uint64_t refresh_path_w(T* cond, int start, const int* lson,
                                   const int* rson, const int* father,
                                   const T* age, T mut, int N, int S, int P,
                                   int lane) {
  uint64_t dirty = 0;
  int cur = start;
  for (int step = 0; cur >= 0 && step < N; ++step) {
    if (cur >= S) {
      recompute_node_w(cond, cur, lson, rson, age, mut, P, lane);
      dirty |= 1ull << cur;
    }
    cur = father[cur];
  }
  return dirty;
}

// copy the rows of `mask` from src to dst, all in one section
template <typename T>
__device__ void copy_rows_w(T* dst, const T* src, uint64_t mask, int P,
                            int lane) {
  const int w = 4 * P;
  LANES(j, __popcll(mask) * w) {
    uint64_t m = mask;  // drop the j / w lowest rows of the mask
    for (int r = j / w; r > 0; --r) m &= m - 1;
    const size_t at = (size_t)(__ffsll((long long)m) - 1) * w + j % w;
    dst[at] = src[at];
  }
}

// Per-locus sequence tables in shared memory: gid[p] is the pattern's
// group, -1 for an invalid pattern; lg4[g] = log(4 nphases[g]).
template <typename T>
__device__ void load_seq_w(const SweepArgs& a, int l, int* gid, T* gcount,
                           T* lg4, int lane) {
  const int P = a.P;
  const i64* g_id = (const i64*)a.group_id + (size_t)l * P;
  const T* g_count = (const T*)a.group_count + (size_t)l * P;
  const T* g_nph = (const T*)a.group_nphases + (size_t)l * P;
  const bool* pvalid = (const bool*)a.pattern_valid + (size_t)l * P;
  LANES(p, P) {
    gid[p] = pvalid[p] ? (int)g_id[p] : -1;
    gcount[p] = g_count[p];
    lg4[p] = d_log((T)4 * g_nph[p]);
  }
}

// Per-locus data log-likelihood from the root conditional
// (ops/likelihood_cache.lnld_from_cond) with the tables of load_seq_w.
// Lane g adds up the patterns of group g in pattern order (the bits of one
// serial pass over the patterns that adds each into its group's cell) and
// takes the group's logarithm; every lane then adds the groups in index
// order.  Returns the same value on every lane; gsum: [P] scratch of the
// locus.
template <typename T>
__device__ T root_lnld_w(const T* cond, int root, const int* gid,
                         const T* gcount, const T* lg4, T* gsum, int S,
                         int P, int lane) {
  const T* rc = cond + (size_t)root * P * 4;
  const T c = (T)((S - 1) * 1.3862943611198906);  // (S-1) log 4
  LANES(g, P) {
    T sum = (T)0;
    if (gcount[g] > (T)0)
      for (int p = 0; p < P; ++p) {
        const T* x = rc + 4 * p;
        const T v = ((x[0] + x[1]) + x[2]) + x[3];
        sum = gid[p] == g ? sum + v : sum;
      }
    const T safe = gcount[g] > (T)0 ? sum : (T)1;
    gsum[g] = gcount[g] * (d_log(safe) - lg4[g] - c);
  }
  T lnl = (T)0;
  for (int g = 0; g < P; ++g) lnl += gsum[g];
  return lnl;
}

// ---- admixture -------------------------------------------------------
// The admixed leaves' table in popi: leaf q is adm[q], its first and
// second populations adm[A + q] and adm[2A + q].
__device__ __forceinline__ const i64* admix_table(const SweepArgs& a) {
  return (const i64*)a.popi + a.PP + 2 * a.B + a.PP * a.PP;
}

// The prior's admixture terms of one locus (kernels/common.py
// gen_log_prior_from_stats): log c where leaf q sits in its second
// population, log(1 - c) in its first, added over q in index order.
template <typename T>
__device__ T admix_lnp(const SweepArgs& a, const int* npop, int c) {
  const i64* adm = admix_table(a);
  const T* cf = (const T*)a.admix_coeff + (size_t)c * a.A;
  T s = (T)0;
  for (int q = 0; q < a.A; ++q) {
    const T x = npop[adm[q]] == (int)adm[2 * a.A + q] ? d_log(cf[q])
                                                      : d_log1p(-cf[q]);
    s = q == 0 ? x : s + x;
  }
  return s;
}

// Bytes of one locus's shared-memory region: `reals` T's, then `ints`
// ints, rounded up to 16.  ops/sweeps.py smem_plan computes the same.
template <typename T>
__host__ __device__ inline int locus_bytes(int reals, int ints) {
  return (reals * (int)sizeof(T) + ints * 4 + 15) / 16 * 16;
}

// Built with -DSWEEP_PROFILE (tools/sweep_phases.py), a kernel adds up the
// clock cycles between its SWEEP_TICK marks, per locus, and writes them to
// a.prof ([L, 16] int64: up to 12 phases, then the whole chain and one
// number of the kernel's own); otherwise the three macros are nothing.
#ifdef SWEEP_PROFILE
#define SWEEP_PROF_BEGIN                                                \
  const long long t_start = clock64();                                  \
  long long t_last = t_start;                                           \
  long long prof[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#define SWEEP_TICK(ph)                        \
  {                                           \
    const long long t_ = clock64();           \
    prof[ph] += t_ - t_last;                  \
    t_last = t_;                              \
  }
#define SWEEP_PROF_END(extra)                                           \
  if (lane == 0 && a.prof) {                                            \
    long long* o_ = (long long*)a.prof + (size_t)l * 16;                \
    for (int q_ = 0; q_ < 12; ++q_) o_[q_] = prof[q_];                  \
    o_[12] = clock64() - t_start;                                       \
    o_[13] = (extra);                                                   \
  }
#else
#define SWEEP_PROF_BEGIN
#define SWEEP_TICK(ph)
#define SWEEP_PROF_END(extra)
#endif

// One C entry point per kernel and real type: hold the caller's
// shared-memory size against the kernel's layout, launch on `stream` with
// a->smem_bytes of dynamic shared memory, return cudaGetLastError().  The
// CPU tests (tests/test_torch_csrc_host.py) compile these sources with a
// host C++ compiler and define SWEEP_LAUNCH_WARP to run the loci one after
// another.
#ifndef SWEEP_LAUNCH_WARP
#define SWEEP_LAUNCH_WARP(K, a, stream)                                    \
  K<<<dim3((a->Lc + a->block - 1) / a->block, a->C), 32 * a->block,         \
      a->smem_bytes, (cudaStream_t)stream>>>(*a)
#endif

// bytes_fn<T>(a): the dynamic shared memory the kernel's layout needs.
// A size above 48 KB has to be allowed for the kernel first; a size the
// card refuses comes back as the error of that call or of the launch.
template <typename K, typename F>
static int launch_warp_kernel(K kernel, F bytes_fn, const SweepArgs* a,
                              void* stream) {
  if (a->block < 1 || bytes_fn(*a) != a->smem_bytes) return SWEEP_ERR_SMEM;
  if (a->C < 1 || a->Lc < 1 || a->C * a->Lc != a->L) return SWEEP_ERR_CHAINS;
  if (a->smem_bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (err != 0) return err;
  }
  SWEEP_LAUNCH_WARP(kernel, a, stream);
  return (int)cudaGetLastError();
}

#define SWEEP_ENTRY_WARP(name, kernel, bytes_fn)                           \
  extern "C" int name##_f32(const SweepArgs* a, void* stream) {            \
    return launch_warp_kernel(kernel<float>, bytes_fn<float>, a, stream);  \
  }                                                                        \
  extern "C" int name##_f64(const SweepArgs* a, void* stream) {            \
    return launch_warp_kernel(kernel<double>, bytes_fn<double>, a,         \
                              stream);                                     \
  }
