// Migration-age sweep (UpdateGB_MigrationNode) for NVIDIA Hopper.
//
// Replaces: gphocs_tpu/ops/sweeps_pallas.py _mig_age_kernel (via
// mig_age_sweep_pallas).  Plain version: kernels/mig_age.py
// update_mig_ages; wrapper: ops/sweeps.py mig_age_sweep.
//
// For each locus, M sequential migration-slot MH moves on prior arithmetic
// only: bounds from the band window and the neighbouring events on the
// branch, a mixture-normal proposal reflected into them, and the
// closed-form prior delta of ops/coalstats.mig_age_move_delta (one lineage
// changes between the ancestor sets of the band's target and source during
// the move window).  4 draws per slot at ctr + 4m + 1..4.
//
// What bounds it on this card: the launch, and behind it a chain of
// dependent steps per active event; neither bytes nor arithmetic.  Most
// loci of an unheated state hold no event and have nothing to do.  An
// active slot is a proposal (a logarithm, a square root, a cosine, the
// division of reflect), three fenced sections and the exponential of the
// MH test, ~2,000 cycles; a locus with m events takes m of them
// (~0.001 ms each at 2 GHz).  The design:
//   * a warp per locus, a.block loci per block, the per-locus tables in
//     dynamic shared memory (a few hundred reals), sized from N, M, PP;
//   * a locus without an active event, or an invalid one, is tested once
//     per warp before any table is made and only copies its migration
//     ages, its log-prior and a zero count out; an inactive slot is
//     skipped (the draws are functions of (key, counter), so a skipped
//     draw changes nothing);
//   * the segment table (N edges, then M slots: start, end, base pop) is
//     made once per locus and again after each accepted move, lanes over
//     the segments: ages and topology do not change in this sweep, and an
//     accepted move changes the ends of its neighbours on the branch and
//     of the branch's edge segment, which one section over all segments
//     redoes as fast as a patch would;
//   * lanes over the (population, segment) products of the prior delta,
//     for the populations whose lineage set changes only (ancestors of the
//     band's target or of its source but not of both, from the ancestor
//     relation's bit columns: 1-3 of the 7 populations of the standard
//     workload); one lane per such population then adds its row in index
//     order, and every lane adds the rows in index order.  A population
//     that does not change contributed 0 / theta = +0 to the serial sum of
//     the plain version, so leaving it out keeps the bits.
#include "sweeps_common.cuh"

// reals and ints of one locus's tables
__host__ __device__ inline int mig_age_reals(int N, int M, int PP) {
  return 2 * N + M + 2 * (N + M) + PP * (N + M) + PP;
}
__host__ __device__ inline int mig_age_ints(int N, int M) {
  return 2 * M + (N + M);
}

template <typename T>
int mig_age_smem_bytes(const SweepArgs& a) {
  return a.block * locus_bytes<T>(mig_age_reals(a.N, a.M, a.PP),
                                  mig_age_ints(a.N, a.M));
}

// the k-th lowest set bit of mask (k < its population count)
__device__ __forceinline__ int kth_bit(unsigned mask, int k) {
  for (; k > 0; --k) mask &= mask - 1;
  return __ffs((int)mask) - 1;
}

template <typename T>
__global__ void mig_age_kernel(const SweepArgs a) {
  __shared__ PopTables<T> pt;  // filled by the whole block
  const int c = blockIdx.y;  // the chain of this block
  pt.load(a, false, c);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  (void)lane;
  const int li = blockIdx.x * a.block + w;  // the locus within its chain
  if (li >= a.Lc) return;
  const int l = c * a.Lc + li;
  advance_counter(a, c, li, lane);
  const int N = a.N, M = a.M, B = a.B, PP = a.PP;
  const int NS = N + M;
  const T oldage = (T)a.oldage;
  const i64* g_mb = (const i64*)a.mig_branch + (size_t)l * M;
  const T* g_ma = (const T*)a.mig_age + (size_t)l * M;
  T* o_mag = (T*)a.mig_age_out + (size_t)l * M;
  const bool real = ((const bool*)a.valid)[l];
  T lnp = ((const T*)a.lnp_in)[l];

  // ---- nothing to move: copy out and leave ----
  int nact = 0;
  LANES(m, M) nact += g_mb[m] >= 0 ? 1 : 0;
  nact = warp_sum(nact);
  if (!real || nact == 0) {
    LANES(m, M) o_mag[m] = g_ma[m];
    ONE_LANE {
      ((T*)a.lnp_out)[l] = lnp;
      ((i64*)a.acc_out)[l] = 0;
    }
    return;
  }

  // ---- this locus's tables in shared memory ----
  const int nreal = mig_age_reals(N, M, PP);
  unsigned char* region =
      sweep_smem + (size_t)w * locus_bytes<T>(nreal, mig_age_ints(N, M));
  T* age = (T*)region;
  T* top = age + N;        // edge tops
  T* mag = top + N;
  T* sstart = mag + M;     T* send = sstart + NS;   // the segments
  T* term = send + NS;     // [populations that change, NS] overlap terms
  T* rowsum = term + (size_t)PP * NS;
  int* mbr = (int*)((T*)region + nreal);
  int* mbd = mbr + M;
  int* base = mbd + M;     // segment's base pop, -1 for no segment
  {
    const T* g_age = (const T*)a.age + (size_t)l * N;
    const i64* g_fa = (const i64*)a.father + (size_t)l * N;
    const i64* g_np = (const i64*)a.node_pop + (size_t)l * N;
    const i64* g_md = (const i64*)a.mig_band + (size_t)l * M;
    LANES(s, NS) {
      if (s < N) {
        const i64 f = g_fa[s];
        age[s] = g_age[s];
        top[s] = f < 0 ? oldage : g_age[f];
        base[s] = (int)g_np[s];
      } else {
        const int m = s - N;
        const bool act = g_mb[m] >= 0;
        mbr[m] = (int)g_mb[m];
        mbd[m] = (int)g_md[m];
        mag[m] = g_ma[m];
        base[s] = act ? (B > 0 ? pt.bsrc[g_md[m]] : 0) : -1;
      }
    }
  }
  const uint32_t key = (uint32_t)((const i64*)a.key)[l];
  const uint32_t ctr0 = (uint32_t)((const i64*)a.ctr)[c];
  const T ft = *(const T*)a.finetune;
  int acc = 0;

  bool stale = true;  // the segment table is behind the migration ages
  for (int m = 0; m < M; ++m) {
    const int branch = mbr[m];
    if (branch < 0) continue;
    if (stale) {  // ops/coalstats.segments: the ends of every segment
      LANES(s, NS) {
        if (s < N) {
          sstart[s] = age[s];
          send[s] = d_min(top[s], first_mig_on(s, mbr, mag, M));
        } else {
          const int m2 = s - N;
          const bool act = mbr[m2] >= 0;
          sstart[s] = act ? mag[m2] : (T)0;
          send[s] = act ? d_min(next_mig_above(m2, mbr, mag, M),
                                top[mbr[m2]])
                        : (T)0;
        }
      }
      stale = false;
    }
    const int band = mbd[m];
    const T t = mag[m];
    // -- bounds: band window and neighbouring events on the branch --
    T tb0 = pt.bs[band], tb1 = pt.be[band];
    T lm = -d_inf<T>(), fm = d_inf<T>();
    for (int m2 = 0; m2 < M; ++m2) {
      const T x = mag[m2];
      const bool on = (m2 != m) & (mbr[m2] == branch);
      lm = (on & (x < t)) ? d_max(lm, x) : lm;
      fm = (on & (x > t)) ? d_min(fm, x) : fm;
    }
    tb0 = d_max(tb0, isfinite(lm) ? lm : age[branch]);
    tb1 = d_min(tb1, isfinite(fm) ? fm : top[branch]);

    const uint32_t c = ctr0 + 4u * (uint32_t)m;
    const T z = rnd2normal8<T>(key, c);
    const T tnew = reflect(t + ft * z, tb0, tb1);
    const bool tiny = d_abs(tnew - t) < (T)1e-15;

    // -- closed-form prior delta (mig_age_move_delta) --
    const int s_pop = pt.bsrc[band], p_pop = pt.btgt[band];
    const bool up = tnew > t;
    const int A = up ? p_pop : s_pop;    // pop gaining the lineage in W
    const int R = up ? s_pop : p_pop;    // pop losing it
    const T w0 = d_min(t, tnew), w1 = d_max(t, tnew);
    // the populations above A only (they gain) and above R only (they lose)
    const unsigned addm = pt.anccol[A] & ~pt.anccol[R];
    const unsigned remm = pt.anccol[R] & ~pt.anccol[A];
    const unsigned chg = addm | remm;
    const int nchg = __popc(chg);
    LANES(j, nchg * NS) {
      const int k = j / NS, s = j - k * NS;
      const int r = kth_bit(chg, k);
      const int bp = base[s];
      const bool in = bp >= 0 && pt.is_anc(r, bp);
      const T lo = d_max(d_max(sstart[s], pt.tau[r]), w0);
      const T hi = d_min(d_min(send[s], pt.pend[r]), w1);
      term[j] = in ? d_max(hi - lo, (T)0) : (T)0;
    }
    LANES(k, nchg) {
      const int r = kth_bit(chg, k);
      const T* row = term + (size_t)k * NS;
      T integ = (T)0;
      for (int s = 0; s < NS; ++s) integ += row[s];
      const T wlen = d_max(d_min(w1, pt.pend[r]) - d_max(w0, pt.tau[r]),
                           (T)0);
      const T dcoal = ((addm >> r) & 1u) ? (T)2 * integ
                                         : (T)-2 * (integ - wlen);
      rowsum[k] = dcoal / pt.theta[r];
    }
    T sum_r = (T)0;
    for (int k = 0; k < nchg; ++k) sum_r += rowsum[k];
    T dlnp = -sum_r;
    if (B > 0) {
      T sm = (T)0;
      for (int b = 0; b < B; ++b) {
        const T ov = d_max(d_min(w1, pt.be[b]) - d_max(w0, pt.bs[b]), (T)0);
        const int tb = pt.btgt[b];
        const T dmig = ((addm >> tb) & 1u) ? ov
                       : (((remm >> tb) & 1u) ? -ov : (T)0);
        sm += dmig * pt.rate[b];
      }
      dlnp = dlnp - sm;
    }
    const T u = uniform<T>(key, c + 4);
    const bool accept = !tiny && mh(dlnp, u);
    if (accept) {
      ONE_LANE { mag[m] = tnew; }
      lnp = lnp + dlnp;
      stale = true;
    }
    acc += (accept || tiny) ? 1 : 0;
  }
  LANES(m, M) o_mag[m] = mag[m];
  ONE_LANE {
    ((T*)a.lnp_out)[l] = lnp;
    ((i64*)a.acc_out)[l] = acc;
  }
}

SWEEP_ENTRY_WARP(mig_age, mig_age_kernel, mig_age_smem_bytes)
