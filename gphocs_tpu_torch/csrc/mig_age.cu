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
// What bounds it on this card: arithmetic and latency.  No conditionals
// are touched; each slot rebuilds the (N + M)-segment table and overlaps it
// with every population, O(PP (N + M) + M^2) per slot, in registers and
// local memory.  One thread owns one locus, so L = 1000 loci fill only 16
// blocks of 64 threads (16 of 132 SMs) and each thread runs M slots in
// sequence; one warp per locus over the (population, segment) products is
// work for later PRs.
#include "sweeps_common.cuh"

template <typename T>
__global__ void mig_age_kernel(const SweepArgs a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= a.L) return;
  const int N = a.N, M = a.M, B = a.B, PP = a.PP;
  const PopTables<T> pt(a);
  T age[MAXN], mag[MAXM];
  int father[MAXN], npop[MAXN], mbr[MAXM], mbd[MAXM];
  copy_real(age, (const T*)a.age + (size_t)l * N, N);
  load_int(father, (const i64*)a.father + (size_t)l * N, N);
  load_int(npop, (const i64*)a.node_pop + (size_t)l * N, N);
  load_int(mbr, (const i64*)a.mig_branch + (size_t)l * M, M);
  load_int(mbd, (const i64*)a.mig_band + (size_t)l * M, M);
  copy_real(mag, (const T*)a.mig_age + (size_t)l * M, M);
  const bool real = ((const bool*)a.valid)[l];
  const uint32_t key = (uint32_t)((const i64*)a.key)[l];
  const uint32_t ctr0 = (uint32_t)*(const i64*)a.ctr;
  const T ft = *(const T*)a.finetune;
  const T oldage = (T)a.oldage;
  T lnp = ((const T*)a.lnp_in)[l];
  int acc = 0;
  Segs<T> sg;

  for (int m = 0; m < M; ++m) {
    const bool active = mbr[m] >= 0 && real;
    const int band = active ? mbd[m] : 0;
    const T t = mag[m];
    const int branch = active ? mbr[m] : 0;
    // -- bounds: band window and neighbouring events on the branch --
    T tb0 = pt.bs[band], tb1 = pt.be[band];
    T lm = -d_inf<T>(), fm = d_inf<T>();
    for (int m2 = 0; m2 < M; ++m2) {
      if (m2 == m || mbr[m2] < 0 || mbr[m2] != branch) continue;
      if (mag[m2] < t) lm = d_max(lm, mag[m2]);
      if (mag[m2] > t) fm = d_min(fm, mag[m2]);
    }
    const int fa = father[branch];
    const T fa_age = fa < 0 ? oldage : age[fa];
    tb0 = d_max(tb0, isfinite(lm) ? lm : age[branch]);
    tb1 = d_min(tb1, isfinite(fm) ? fm : fa_age);

    const uint32_t c = ctr0 + 4u * (uint32_t)m;
    const T z = rnd2normal8<T>(key, c);
    const T tnew = reflect(t + ft * z, tb0, tb1);
    const bool tiny = d_abs(tnew - t) < (T)1e-15;

    // -- closed-form prior delta (mig_age_move_delta) --
    T dlnp = (T)0;
    if (mbr[m] >= 0) {
      const int s_pop = (int)pt.bsrc[band], p_pop = (int)pt.btgt[band];
      const bool up = tnew > t;
      const int A = up ? p_pop : s_pop;    // pop gaining the lineage in W
      const int R = up ? s_pop : p_pop;    // pop losing it
      const T w0 = d_min(t, tnew), w1 = d_max(t, tnew);
      sg.build(age, father, npop, mbr, mbd, mag, pt, oldage, N, M);
      T sum_r = (T)0;
      for (int r = 0; r < PP; ++r) {
        const bool inA = pt.is_anc(r, A), inR = pt.is_anc(r, R);
        const bool addm = inA && !inR, remm = inR && !inA;
        T dcoal = (T)0;
        if (addm || remm) {
          T integ = (T)0;
          for (int s = 0; s < sg.n; ++s) {
            if (!sg.valid[s] || !pt.is_anc(r, sg.base[s])) continue;
            const T lo = d_max(d_max(sg.start[s], pt.tau[r]), w0);
            const T hi = d_min(d_min(sg.end[s], pt.pend[r]), w1);
            integ += d_max(hi - lo, (T)0);
          }
          const T wlen = d_max(d_min(w1, pt.pend[r]) - d_max(w0, pt.tau[r]),
                               (T)0);
          dcoal = addm ? (T)2 * integ : (T)-2 * (integ - wlen);
        }
        sum_r += dcoal / pt.theta[r];
      }
      dlnp = -sum_r;
      if (B > 0) {
        T sm = (T)0;
        for (int b = 0; b < B; ++b) {
          const T ov = d_max(d_min(w1, pt.be[b]) - d_max(w0, pt.bs[b]),
                             (T)0);
          const int tb = (int)pt.btgt[b];
          const bool add_b = pt.is_anc(tb, A) && !pt.is_anc(tb, R);
          const bool rem_b = pt.is_anc(tb, R) && !pt.is_anc(tb, A);
          const T dmig = add_b ? ov : (rem_b ? -ov : (T)0);
          sm += dmig * pt.rate[b];
        }
        dlnp = dlnp - sm;
      }
    }
    const T u = uniform<T>(key, c + 4);
    const bool accept = active && !tiny && mh(dlnp, u);
    if (accept) {
      mag[m] = tnew;
      lnp = lnp + dlnp;
    }
    acc += (accept || (active && tiny)) ? 1 : 0;
  }
  copy_real((T*)a.mig_age_out + (size_t)l * M, mag, M);
  ((T*)a.lnp_out)[l] = lnp;
  ((int*)a.acc_out)[l] = acc;
}

SWEEP_ENTRY(mig_age, mig_age_kernel)
