// Node-age sweep (UpdateGB_InternalNode) for NVIDIA Hopper.
//
// Replaces: gphocs_tpu/ops/sweeps_pallas.py _node_age_kernel (via
// node_age_sweep_pallas).  Plain version: kernels/node_age.py
// update_internal_node_ages; wrapper: ops/sweeps.py node_age_sweep.
//
// For each locus, S-1 sequential internal-node MH steps: bounds from the
// population window, the sons and the adjacent migrations; a mixture-normal
// proposal reflected into the bounds; the closed-form genealogy-prior delta
// (ops/coalstats.node_age_move_delta); a refresh of the conditionals along
// the path to the root; the root log-likelihood; the MH select.  4 draws
// per step at counter positions ctr + 4i + 1..4.
//
// What bounds it on this card: a chain of S - 1 dependent steps per locus,
// not bytes or arithmetic.  A step is a proposal (a logarithm, a square
// root, a cosine and the division of reflect, one after another), the
// overlap of the move window with N + M segments, a root path of ~log S
// combines each waiting for the one below, the root reduce with its
// logarithms, and the exponential of the MH test.  The serial-chain floor,
// reckoned: per step ~8 fenced sections of ~100 cycles and ~900 cycles of
// dependent transcendentals, divisions and ordered sums, ~1,800 cycles;
// 7 steps of S = 8 and ~3,000 cycles of loads and stores: ~16,000 cycles,
// ~0.009 ms at the 1.75 GHz the phase counters imply.  Measured with them
// (tools/sweep_phases.py; L = 1000, N = 15, M = 10, P = 6, f32, NVIDIA H100
// 80GB HBM3 at 700 W): ~52,000 cycles a locus, 0.033 ms a launch, with two
// warps per scheduler to hide each other's latencies.  The card can only
// run many loci side by side and keep each step short.  The design:
//   * a warp per locus, a.block loci per block (125 blocks at L = 1000),
//     every per-locus table in dynamic shared memory, sized from N, M, P;
//   * what a node-age move cannot change is made once, before the node
//     loop: each edge's first and last migration age, each slot's next
//     event above it on its branch and its base population.  A step's
//     segment ends are then min(edge top, first migration) and min(next
//     event, edge top of the branch) from tables; the edge tops are read
//     through father[] from the ages, so an accepted or rejected move has
//     no second table to keep in step.  A locus without migration events
//     takes the N edge segments alone (the slots would add zeros);
//   * bounds, proposal and MH test are scalar work that every lane does
//     alike from shared data; the lanes take the N + M overlap terms into a
//     shared row, which every lane then adds up in index order (the bits
//     of a serial sum, whatever the block size), and the P x 4 outputs of
//     every combine;
//   * the conditionals in place, with the old rows of the step's root path
//     kept for a reject: a step dirties at most the N - S internal rows,
//     so a locus holds [N, P, 4] and [N - S, P, 4] values instead of two
//     whole copies (23 KB instead of 28 KB for 8 loci of the standard
//     workload at f32, 43 KB at f64: under the 48 KB that need no opt-in),
//     is staged in once instead of twice, and an accepted step copies
//     nothing.  The save rides in the combine's own section.  Where a
//     locus does not fit in shared memory (a.cond_smem == 0) the same body
//     works on cond_out and on a.prop ([L, N - S, P, 4]) in device memory.
//     Chosen over two whole copies (SPR's form) on the card: that form,
//     built from this file, took 0.0364 ms a launch where this one takes
//     0.0333 ms (in turns in one run, the card above);
//   * the accept count stays per locus (acc_out, int64 so that the
//     wrapper's sum is one reduction without a cast before it): a sum on
//     the card would need a zeroed cell, one device operation for one.
//     The advanced counter is written here (advance_counter), so the
//     wrapper launches that sum and nothing else besides the kernel.
#include "sweeps_common.cuh"

// reals and ints of one locus's tables, without the conditionals
__host__ __device__ inline int node_age_reals(int N, int M, int P) {
  return 3 * N + 2 * M + (N + M) + 3 * P;
}
__host__ __device__ inline int node_age_ints(int N, int M, int P) {
  return 4 * N + 2 * M + P;
}
// the locus's conditionals and the kept rows of a root path
__host__ __device__ inline int node_age_cond_reals(int N, int P) {
  return (N + (N - (N + 1) / 2)) * P * 4;
}

template <typename T>
int node_age_smem_bytes(const SweepArgs& a) {
  const int cn = a.cond_smem ? node_age_cond_reals(a.N, a.P) : 0;
  return a.block * locus_bytes<T>(node_age_reals(a.N, a.M, a.P) + cn,
                                  node_age_ints(a.N, a.M, a.P));
}

// refresh_path_w in place: before a node's row is overwritten it goes to
// row (node - S) of `kept`, in the section that computes the new one
template <typename T>
__device__ uint64_t refresh_path_keep_w(T* cond, T* kept, int start,
                                        const int* lson, const int* rson,
                                        const int* father, const T* age,
                                        T mut, int N, int S, int P,
                                        int lane) {
  uint64_t dirty = 0;
  int cur = start;
  for (int step = 0; cur >= 0 && step < N; ++step) {
    if (cur >= S) {
      const int ls = lson[cur], rs = rson[cur];
      const T pa = edge_p(mut * (age[cur] - age[ls]));
      const T pb = edge_p(mut * (age[cur] - age[rs]));
      const T qa = (T)1 - (T)4 * pa, qb = (T)1 - (T)4 * pb;
      T* out = cond + (size_t)cur * P * 4;
      T* old = kept + (size_t)(cur - S) * P * 4;
      const T* ca = cond + (size_t)ls * P * 4;
      const T* cb = cond + (size_t)rs * P * 4;
      LANES(j, 4 * P) {
        const T* x = ca + (j & ~3);
        const T* y = cb + (j & ~3);
        const T sa = ((x[0] + x[1]) + x[2]) + x[3];
        const T sb = ((y[0] + y[1]) + y[2]) + y[3];
        const T fa = pa * sa + qa * ca[j];
        const T fb = pb * sb + qb * cb[j];
        old[j] = out[j];
        out[j] = (T)4 * fa * fb;
      }
      dirty |= 1ull << cur;
    }
    cur = father[cur];
  }
  return dirty;
}

// The SWEEP_TICK marks below end the phases that tools/sweep_phases.py
// names (NODE_AGE_PHASES there); the number of the kernel's own is the
// accept count.
template <typename T>
__global__ void node_age_kernel(const SweepArgs a) {
  __shared__ PopTables<T> pt;  // filled by the whole block
  const int c = blockIdx.y;  // the chain of this block
  pt.load(a, false, c);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  (void)lane;
  const int li = blockIdx.x * a.block + w;  // the locus within its chain
  if (li >= a.Lc) return;
  const int l = c * a.Lc + li;
  advance_counter(a, c, li, lane);
  SWEEP_PROF_BEGIN
  const int N = a.N, S = (N + 1) / 2, M = a.M, B = a.B, P = a.P;
  const int NS = N + M;
  const size_t cn = (size_t)N * P * 4;
  const size_t kn = (size_t)(N - S) * P * 4;
  const T oldage = (T)a.oldage;

  // ---- this locus's tables in shared memory ----
  const int nreal = node_age_reals(N, M, P) +
                    (a.cond_smem ? node_age_cond_reals(N, P) : 0);
  unsigned char* region =
      sweep_smem + (size_t)w * locus_bytes<T>(nreal, node_age_ints(N, M, P));
  T* age = (T*)region;
  T* fmig = age + N;       // first (lowest) migration age on the edge
  T* lmig = fmig + N;      // last (highest) migration age on the edge
  T* mag = lmig + N;
  T* mnext = mag + M;      // next event above slot m on its branch
  T* term = mnext + M;     // a step's overlap terms
  T* gcount = term + NS;   T* lg4 = gcount + P;     T* gsum = lg4 + P;
  T* cond_s = gsum + P;
  int* lson = (int*)((T*)region + nreal);
  int* rson = lson + N;    int* father = rson + N;  int* npop = father + N;
  int* mbr = npop + N;
  int* base = mbr + M;     // base pop of slot m's segment, -1 for none
  int* gid = base + M;
  T* cond = a.cond_smem ? cond_s : (T*)a.cond_out + (size_t)l * cn;
  T* kept = a.cond_smem ? cond_s + cn : (T*)a.prop + (size_t)l * kn;

  {
    const T* g_age = (const T*)a.age + (size_t)l * N;
    const i64* g_ls = (const i64*)a.lson + (size_t)l * N;
    const i64* g_rs = (const i64*)a.rson + (size_t)l * N;
    const i64* g_fa = (const i64*)a.father + (size_t)l * N;
    const i64* g_np = (const i64*)a.node_pop + (size_t)l * N;
    LANES(v, N) {
      age[v] = g_age[v];
      lson[v] = (int)g_ls[v];
      rson[v] = (int)g_rs[v];
      father[v] = (int)g_fa[v];
      npop[v] = (int)g_np[v];
    }
    const i64* g_mb = (const i64*)a.mig_branch + (size_t)l * M;
    const T* g_ma = (const T*)a.mig_age + (size_t)l * M;
    LANES(m, M) {
      mbr[m] = (int)g_mb[m];
      mag[m] = g_ma[m];
    }
    const T* cin = (const T*)a.cond_in + (size_t)l * cn;
    LANES(j, (int)cn) cond[j] = cin[j];
  }
  load_seq_w(a, l, gid, gcount, lg4, lane);
  const int root = (int)((const i64*)a.root)[l];
  const T mut = ((const T*)a.mut_rate)[l];
  const bool real = ((const bool*)a.valid)[l];
  const uint32_t key = (uint32_t)((const i64*)a.key)[l];
  const uint32_t ctr0 = (uint32_t)((const i64*)a.ctr)[c];
  const T ft = *(const T*)a.finetune;

  // ---- what no node-age move changes ----
  int nact = 0;
  {
    const i64* g_md = (const i64*)a.mig_band + (size_t)l * M;
    LANES(s, NS) {
      if (s < N) {
        fmig[s] = first_mig_on(s, mbr, mag, M);
        lmig[s] = last_mig_on(s, mbr, mag, M);
      } else {
        const int m = s - N;
        const bool act = mbr[m] >= 0;
        nact += act ? 1 : 0;
        mnext[m] = next_mig_above(m, mbr, mag, M);
        base[m] = act ? (B > 0 ? pt.bsrc[g_md[m]] : 0) : -1;
      }
    }
  }
  // a locus without migration events: the edge segments alone
  const int ns = warp_sum(nact) > 0 ? NS : N;

  T lnld = ((const T*)a.lnld_in)[l];
  T lnp = ((const T*)a.lnp_in)[l];
  int acc = 0;
  SWEEP_TICK(0)

  for (int i = 0; i < S - 1; ++i) {
    const int inode = S + i;
    const T t = age[inode];
    const int pop = npop[inode];
    // -- bounds (reference src/GPhoCS.c:2320-2353) --
    T tb0 = pt.tau[pop];
    T tb1 = pop == a.root_pop ? oldage : pt.tau[pt.father_pop[pop]];
    const T fm = fmig[inode];
    const int fa = father[inode];
    const T upper2 = isfinite(fm) ? fm
                     : (root == inode ? d_inf<T>() : age[fa < 0 ? 0 : fa]);
    tb1 = d_min(tb1, upper2);
    const int ls = lson[inode], rs = rson[inode];
    const T lm0 = lmig[ls], lm1 = lmig[rs];
    tb0 = d_max(tb0, isfinite(lm0) ? lm0 : age[ls]);
    tb0 = d_max(tb0, isfinite(lm1) ? lm1 : age[rs]);
    // -- proposal --
    const uint32_t c = ctr0 + 4u * (uint32_t)i;
    const T z = rnd2normal8<T>(key, c);
    const T tnew = reflect(t + ft * z, tb0, tb1);
    const bool tiny = d_abs(tnew - t) < (T)1e-15;
    SWEEP_TICK(1)

    // -- closed-form genealogy-prior delta on the current state: the
    // overlap of the move window with every segment (N edges, then M
    // slots) whose base pop lies under `pop` --
    const T w0 = d_min(t, tnew), w1 = d_max(t, tnew);
    const bool raising = tnew > t;
    const unsigned under = pt.ancrow[pop];
    LANES(s, ns) {
      T lo, hi;
      int bp;
      if (s < N) {
        const int f = father[s];
        lo = age[s];
        hi = d_min(f < 0 ? oldage : age[f], fmig[s]);
        bp = npop[s];
      } else {
        const int m = s - N;
        const int f = father[mbr[m] < 0 ? 0 : mbr[m]];
        lo = mag[m];
        hi = d_min(mnext[m], f < 0 ? oldage : age[f]);
        bp = base[m];
      }
      const bool in = bp >= 0 && ((under >> bp) & 1u);
      term[s] = in ? d_max(d_min(hi, w1) - d_max(lo, w0), (T)0) : (T)0;
    }
    T integral = (T)0;
    for (int s = 0; s < ns; ++s) integral += term[s];
    const T dcoal = raising ? (T)2 * integral
                            : (T)-2 * (integral - (w1 - w0));
    T dlnp = -dcoal / pt.theta[pop];
    if (B > 0) {
      T sm = (T)0;
      for (int b = 0; b < B; ++b) {
        const T ov = d_max(d_min(w1, pt.be[b]) - d_max(w0, pt.bs[b]), (T)0);
        const T dmig = pt.btgt[b] == pop ? (raising ? ov : -ov) : (T)0;
        sm += dmig * pt.rate[b];
      }
      dlnp = dlnp - sm;
    }
    SWEEP_TICK(2)

    // -- data delta: root-path refresh in place, the old rows kept --
    ONE_LANE { age[inode] = tnew; }
    const uint64_t dirty = refresh_path_keep_w(cond, kept, inode, lson, rson,
                                               father, age, mut, N, S, P,
                                               lane);
    SWEEP_TICK(3)
    const T lnld_new = root_lnld_w(cond, root, gid, gcount, lg4, gsum, S, P,
                                   lane);
    SWEEP_TICK(4)
    const T lnacc = dlnp + (lnld_new - lnld);
    const T u = uniform<T>(key, c + 4);
    const bool accept = real && !tiny && mh(lnacc, u);
#ifdef SWEEP_PROBE
    // built with -DSWEEP_PROBE (tools/node_age_probe.py): the step's
    // values into a.prof, [L, MAXN, 8] doubles, where it is given
    if (a.prof) ONE_LANE {
      double* o_ = (double*)a.prof + ((size_t)l * MAXN + i) * 8;
      o_[0] = (double)tnew;
      o_[1] = (double)dlnp;
      o_[2] = (double)(lnld_new - lnld);
      o_[3] = (double)u;
      o_[4] = (double)lnacc;
      o_[5] = accept ? 1.0 : 0.0;
      o_[6] = (double)lnld_new;
      o_[7] = (double)integral;
    }
#endif
    if (accept) {
      lnld = lnld_new;
      lnp = lnp + dlnp;
    } else {
      ONE_LANE { age[inode] = t; }
      copy_rows_w(cond + (size_t)S * P * 4, kept, dirty >> S, P, lane);
    }
    acc += (real && (accept || tiny)) ? 1 : 0;
    SWEEP_TICK(5)
  }

  {
    T* o_age = (T*)a.age_out + (size_t)l * N;
    LANES(v, N) o_age[v] = age[v];
    if (a.cond_smem) {
      T* o_cond = (T*)a.cond_out + (size_t)l * cn;
      LANES(j, (int)cn) o_cond[j] = cond[j];
    }
    ONE_LANE {
      ((T*)a.lnld_out)[l] = lnld;
      ((T*)a.lnp_out)[l] = lnp;
      ((i64*)a.acc_out)[l] = acc;
    }
    SWEEP_TICK(6)
    SWEEP_PROF_END(acc)
  }
}

SWEEP_ENTRY_WARP(node_age, node_age_kernel, node_age_smem_bytes)
