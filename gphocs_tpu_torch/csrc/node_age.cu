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
// the path to the root on a proposal copy; the root log-likelihood; the MH
// select.  4 draws per step at counter positions ctr + 4i + 1..4.
//
// What bounds it on this card: the conditionals.  Each step reads and
// writes the root path (~log S rows of P x 4 values) of a proposal copy
// that lives in device memory, and one thread owns one locus, so a warp's
// loads are 4 N P sizeof(T) bytes apart and do not coalesce.  At L = 1000
// loci and 64-locus blocks the launch has 16 blocks: 16 of the 132 SMs are
// busy.  Both are given up for a straight transcription of the plain
// version; a warp per locus with its tables in shared memory, as in
// rubber_band.cu and spr.cu, is work for a later PR.  The population tables
// are filled by the block into static shared memory (PopTables::load).
#include "sweeps_common.cuh"

template <typename T>
__global__ void node_age_kernel(const SweepArgs a) {
  __shared__ PopTables<T> pt;  // filled by the whole block
  pt.load(a, false);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= a.L) return;
  const int N = a.N, S = (N + 1) / 2, M = a.M, B = a.B, P = a.P;
  const size_t cn = (size_t)N * P * 4;

  T age[MAXN], mag[MAXM];
  int lson[MAXN], rson[MAXN], father[MAXN], npop[MAXN], mbr[MAXM];
  copy_real(age, (const T*)a.age + (size_t)l * N, N);
  load_int(lson, (const i64*)a.lson + (size_t)l * N, N);
  load_int(rson, (const i64*)a.rson + (size_t)l * N, N);
  load_int(father, (const i64*)a.father + (size_t)l * N, N);
  load_int(npop, (const i64*)a.node_pop + (size_t)l * N, N);
  load_int(mbr, (const i64*)a.mig_branch + (size_t)l * M, M);
  copy_real(mag, (const T*)a.mig_age + (size_t)l * M, M);
  int mbd[MAXM];
  load_int(mbd, (const i64*)a.mig_band + (size_t)l * M, M);
  const int root = (int)((const i64*)a.root)[l];
  const T mut = ((const T*)a.mut_rate)[l];
  const bool real = ((const bool*)a.valid)[l];
  const i64* gid = (const i64*)a.group_id + (size_t)l * P;
  const T* gcount = (const T*)a.group_count + (size_t)l * P;
  const T* gnph = (const T*)a.group_nphases + (size_t)l * P;
  const bool* pvalid = (const bool*)a.pattern_valid + (size_t)l * P;
  T* gsum = (T*)a.gsum + (size_t)l * P;

  const uint32_t key = (uint32_t)((const i64*)a.key)[l];
  const uint32_t ctr0 = (uint32_t)*(const i64*)a.ctr;
  const T ft = *(const T*)a.finetune;
  const T oldage = (T)a.oldage;

  T* cond = (T*)a.cond_out + (size_t)l * cn;
  T* prop = (T*)a.prop + (size_t)l * cn;
  const T* cin = (const T*)a.cond_in + (size_t)l * cn;
  copy_real(cond, cin, cn);
  copy_real(prop, cin, cn);  // invariant: prop == cond between steps

  T lnld = ((const T*)a.lnld_in)[l];
  T lnp = ((const T*)a.lnp_in)[l];
  int acc = 0;
  Segs<T> sg;

  for (int i = 0; i < S - 1; ++i) {
    const int inode = S + i;
    const T t = age[inode];
    const int pop = npop[inode];
    // -- bounds (reference src/GPhoCS.c:2320-2353) --
    T tb0 = pt.tau[pop];
    T tb1 = pop == a.root_pop ? oldage : pt.tau[pt.father_pop[pop]];
    const T fm = first_mig_on(inode, mbr, mag, M);
    const int fa = father[inode];
    const T upper2 = isfinite(fm) ? fm
                     : (root == inode ? d_inf<T>() : age[fa < 0 ? 0 : fa]);
    tb1 = d_min(tb1, upper2);
    const int sons[2] = {lson[inode], rson[inode]};
    for (int k = 0; k < 2; ++k) {
      const T lm = last_mig_on(sons[k], mbr, mag, M);
      tb0 = d_max(tb0, isfinite(lm) ? lm : age[sons[k]]);
    }
    // -- proposal --
    const uint32_t c = ctr0 + 4u * (uint32_t)i;
    const T z = rnd2normal8<T>(key, c);
    const T tnew = reflect(t + ft * z, tb0, tb1);
    const bool tiny = d_abs(tnew - t) < (T)1e-15;

    // -- closed-form genealogy-prior delta on the current state --
    const T w0 = d_min(t, tnew), w1 = d_max(t, tnew);
    const bool raising = tnew > t;
    sg.build(age, father, npop, mbr, mbd, mag, pt, oldage, N, M);
    T integral = (T)0;
    for (int s = 0; s < sg.n; ++s) {
      if (!sg.valid[s] || !pt.is_anc(pop, sg.base[s])) continue;
      integral += d_max(d_min(sg.end[s], w1) - d_max(sg.start[s], w0),
                        (T)0);
    }
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

    // -- data delta: root-path refresh on the proposal copy --
    age[inode] = tnew;
    const uint64_t dirty = refresh_path(prop, inode, lson, rson, father, age,
                                        mut, N, S, P);
    const T lnld_new = root_lnld(prop, root, gid, gcount, gnph, pvalid,
                                 gsum, S, P);
    const T lnacc = dlnp + (lnld_new - lnld);
    const T u = uniform<T>(key, c + 4);
    const bool accept = real && !tiny && mh(lnacc, u);
    if (accept) {
      copy_rows(cond, prop, dirty, P);
      lnld = lnld_new;
      lnp = lnp + dlnp;
    } else {
      age[inode] = t;
      copy_rows(prop, cond, dirty, P);
    }
    acc += (real && (accept || tiny)) ? 1 : 0;
  }
  copy_real((T*)a.age_out + (size_t)l * N, age, N);
  ((T*)a.lnld_out)[l] = lnld;
  ((T*)a.lnp_out)[l] = lnp;
  ((int*)a.acc_out)[l] = acc;
}

SWEEP_ENTRY(node_age, node_age_kernel)
