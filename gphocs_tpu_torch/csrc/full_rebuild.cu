// Full rebuild of the conditionals and the per-locus data log-likelihood
// on given node ages, for NVIDIA Hopper.
//
// Replaces no TPU kernel (no pl.pallas_call): the JAX package leaves this
// rebuild to XLA (gphocs_tpu/ops/likelihood_cache.py full_rebuild_and_lnld),
// which fuses its S - 1 Jacobi trips over all N nodes and the root reduce.
// In eager PyTorch the same plain version (ops/likelihood_cache.py
// full_rebuild_and_lnld) is ~380 small ATen launches a call at S = 8: the
// gathers, edge probabilities and combines of every trip, then the root's
// group sums.  This kernel computes the same bits in one launch.  Wrapper:
// ops/sweeps.py full_rebuild; caller: kernels/mixing.py, on the proposal's
// scaled ages, once per pattern bucket.
//
// For each locus: the leaf rows copied from the carried conditionals
// (cond_in; the leaves' rows depend on the data alone), the internal nodes
// in post-order from the root, each combined once from its sons' final rows
// (recompute_node_w: the x4 rescale, the plain version's order of
// arithmetic), and the root log-likelihood (root_lnld_w: the groups' sums
// in pattern order, the groups in index order).  A Jacobi trip of the plain
// version that finalizes a node computes exactly that combine from exactly
// those rows, so the two agree bit for bit.  Every locus is rebuilt,
// padding loci included, as the plain version does.  No RNG, no population
// tables: the chains' loci are one grid axis (C = 1, Lc = L).
//
// What bounds it on this card: the chain of N - S dependent combines per
// locus (each waits for its sons), then P logarithms and two ordered sums,
// not bytes (~2.6 MB at L = 1000, N = 15, P = 6, f32: under 1 us at 3.35
// TB/s) or arithmetic.  The design is the rubber band's rebuild on its own:
//   * a warp per locus, a.block loci per block; the lanes take the P x 4
//     outputs of a combine, the row copies and the P groups of the reduce;
//   * the locus's ages, sons, walk order and sequence tables in dynamic
//     shared memory, and its conditionals too where a locus fits
//     (a.cond_smem: staged out with coalesced row stores), else the same
//     code works on cond_out in device memory, where a warp reads a row
//     contiguously.  The plan entry (full_rebuild_plan_f32/_f64) decides.
#include "sweeps_common.cuh"

// reals and ints of one locus's tables, without the conditionals
__host__ __device__ inline int full_rebuild_reals(int N, int P) {
  return N + 3 * P;
}
__host__ __device__ inline int full_rebuild_ints(int N, int P) {
  return 4 * N + P;
}

template <typename T>
int full_rebuild_smem_bytes(const SweepArgs& a) {
  const int cn = a.cond_smem ? a.N * a.P * 4 : 0;
  return a.block * locus_bytes<T>(full_rebuild_reals(a.N, a.P) + cn,
                                  full_rebuild_ints(a.N, a.P));
}

template <typename T>
__global__ void full_rebuild_kernel(const SweepArgs a) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  (void)lane;
  const int li = blockIdx.x * a.block + w;  // the locus within its chain
  if (li >= a.Lc) return;
  const int l = blockIdx.y * a.Lc + li;
  const int N = a.N, S = (N + 1) / 2, P = a.P;
  const size_t cn = (size_t)N * P * 4;

  // ---- this locus's tables in shared memory ----
  const int nreal = full_rebuild_reals(N, P) + (a.cond_smem ? (int)cn : 0);
  unsigned char* region =
      sweep_smem + (size_t)w * locus_bytes<T>(nreal, full_rebuild_ints(N, P));
  T* age = (T*)region;
  T* gcount = age + N;       T* lg4 = gcount + P;     T* gsum = lg4 + P;
  T* cond_s = gsum + P;
  int* lson = (int*)((T*)region + nreal);
  int* rson = lson + N;      int* order = rson + N;   int* stack = order + N;
  int* gid = stack + N;
  T* cond = a.cond_smem ? cond_s : (T*)a.cond_out + (size_t)l * cn;

  {
    const T* g_age = (const T*)a.age + (size_t)l * N;
    const i64* g_ls = (const i64*)a.lson + (size_t)l * N;
    const i64* g_rs = (const i64*)a.rson + (size_t)l * N;
    LANES(v, N) {
      age[v] = g_age[v];
      lson[v] = (int)g_ls[v];
      rson[v] = (int)g_rs[v];
    }
    // the leaf rows of the conditionals
    const T* cin = (const T*)a.cond_in + (size_t)l * cn;
    LANES(j, S * P * 4) cond[j] = cin[j];
  }
  load_seq_w(a, l, gid, gcount, lg4, lane);
  const int root = (int)((const i64*)a.root)[l];
  const T mut = ((const T*)a.mut_rate)[l];

  // ---- the internal nodes in post-order ----
  ONE_LANE {
    int sp = 0, cnt = 0;
    stack[sp++] = root;
    while (sp > 0) {  // reversed pre-order (node, right, left) ...
      const int v = stack[--sp];
      if (v < S) continue;
      order[cnt++] = v;
      stack[sp++] = lson[v];
      stack[sp++] = rson[v];
    }
    stack[0] = cnt;
  }
  const int no = stack[0];
  for (int j = no - 1; j >= 0; --j)  // ... read backwards: sons first
    recompute_node_w(cond, order[j], lson, rson, age, mut, P, lane);
  const T lnld = root_lnld_w(cond, root, gid, gcount, lg4, gsum, S, P, lane);
  if (a.cond_smem) {
    T* o_cond = (T*)a.cond_out + (size_t)l * cn;
    LANES(j, (int)cn) o_cond[j] = cond[j];
  }
  ONE_LANE { ((T*)a.lnld_out)[l] = lnld; }
}

SWEEP_ENTRY_WARP(full_rebuild, full_rebuild_kernel, full_rebuild_smem_bytes)
