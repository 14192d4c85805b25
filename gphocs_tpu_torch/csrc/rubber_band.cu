// Rubber-band proposal evaluation (UpdateTau and UpdateSampleAge) for
// NVIDIA Hopper.
//
// Replaces: gphocs_tpu/ops/sweeps_pallas.py _rubber_kernel (via
// rubber_band_eval_pallas), both of its modes, with its _full_rebuild.
// Plain version: kernels/tau.py rubber_band_eval_plain; wrapper:
// ops/sweeps.py rubber_band_eval.
//
// For each locus, one population's proposed tau: the affine remap of node
// and migration ages (f0 below, f1 above), the conflict scan against the
// new band windows and the neighbouring events, a full bottom-up rebuild
// of the conditionals (post-order, one combine per internal node) with the
// root log-likelihood, and the genealogy log-prior from scratch (pairwise
// overlaps of the segment set with the tight root cap).  Writes per-locus
// Jacobian counts and conflicts for the wrapper's reduction.  No RNG.
//
// Sample-age mode (a.sample_age != 0): `pop` is a current population whose
// sample age moves from tauold to taunew inside (taub0, taub1) = (0, its
// father's tau).  Its coalescent nodes and the migration events that touch
// it scale around taub0 by f0 when below the old age and around taub1 by f1
// when above; its leaves move to taunew; every such event is conflict-
// checked and only events of `pop` itself exempt a neighbour.  The
// population tables are those of the unchanged tau.  The rebuild and the
// prior read the moved leaf ages from new_age like any other node's.
//
// What bounds it on this card: the rebuild writes all N x P x 4 conditionals
// of every locus, and with one thread per locus a warp's accesses are
// N P 4 sizeof(T) bytes apart (uncoalesced); the pairwise prior is
// O(PP (N + M)^2) per locus in registers.  It runs 3 times an iteration
// (once per ancestral population) with 16 blocks at L = 1000.  Spreading a
// locus's patterns over a warp is work for later PRs.
#include "sweeps_common.cuh"

template <typename T>
__global__ void rubber_band_kernel(const SweepArgs a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= a.L) return;
  const int N = a.N, S = (N + 1) / 2, M = a.M, B = a.B, PP = a.PP, P = a.P;
  const PopTables<T> pt(a);  // tau/pop_end/band windows of the PROPOSAL
  const size_t cn = (size_t)N * P * 4;
  const T* rs = (const T*)a.rscal;
  const T taub0 = rs[0], taub1 = rs[1], tauold = rs[2], taunew = rs[3];
  const int pop = a.pop;
  const bool is_root = a.is_root != 0;
  const bool sample_age = a.sample_age != 0;

  T age[MAXN], mag[MAXM], new_age[MAXN], new_mag[MAXM];
  int lson[MAXN], rson[MAXN], father[MAXN], npop[MAXN], mbr[MAXM],
      mbd[MAXM];
  copy_real(age, (const T*)a.age + (size_t)l * N, N);
  load_int(lson, (const i64*)a.lson + (size_t)l * N, N);
  load_int(rson, (const i64*)a.rson + (size_t)l * N, N);
  load_int(father, (const i64*)a.father + (size_t)l * N, N);
  load_int(npop, (const i64*)a.node_pop + (size_t)l * N, N);
  load_int(mbr, (const i64*)a.mig_branch + (size_t)l * M, M);
  load_int(mbd, (const i64*)a.mig_band + (size_t)l * M, M);
  copy_real(mag, (const T*)a.mig_age + (size_t)l * M, M);
  const int root = (int)((const i64*)a.root)[l];
  const T mut = ((const T*)a.mut_rate)[l];
  const bool real = ((const bool*)a.valid)[l];

  // sons of the rubber-banded population: the two pops whose father it is
  // (none for the current population of the sample-age mode: -1 matches no
  // population below)
  int son0 = -1, son1 = -1;
  for (int q = 0; q < PP; ++q)
    if (pt.father_pop[q] == pop) {
      if (son0 < 0) son0 = q; else if (son1 < 0) son1 = q;
    }

  const T f0 = (taunew - taub0) / (tauold - taub0);
  const T f1 = is_root ? f0 : (taunew - taub1) / (tauold - taub1);

  // ---- node-age remap ----
  int ntj0 = 0, ntj1 = 0;
  for (int n = 0; n < N; ++n) {
    const T x = age[n];
    const bool internal = n >= S;
    const bool in_pop = npop[n] == pop;
    bool moved0, moved1;  // scaled around taub0 by f0 / around taub1 by f1
    if (sample_age) {
      moved0 = in_pop && internal && x > taub0 && x < tauold;
      moved1 = in_pop && internal && x >= tauold && x < taub1;
    } else {
      const bool in_sons = npop[n] == son0 || npop[n] == son1;
      moved1 = in_pop && internal && (is_root || x < taub1);
      moved0 = in_sons && x > taub0 && x < tauold && internal;
    }
    T y = x;
    if (moved1) y = is_root ? taub0 + f0 * (x - taub0)
                            : taub1 + f1 * (x - taub1);
    if (moved0) y = taub0 + f0 * (x - taub0);
    if (sample_age && in_pop && !internal) y = taunew;  // the pop's leaves
    new_age[n] = y;
    ntj0 += moved0 ? 1 : 0;
    ntj1 += moved1 ? 1 : 0;
  }

  // ---- migration-age remap + conflicts ----
  int conflicts = 0;
  for (int m = 0; m < M; ++m) new_mag[m] = mag[m];
  if (B > 0) {
    int msrc[MAXM], mtgt[MAXM];
    bool checked[MAXM], kind_out[MAXM];
    for (int m = 0; m < M; ++m) {
      const bool act = mbr[m] >= 0;
      const int band = act ? mbd[m] : 0;
      msrc[m] = (int)pt.bsrc[band];
      mtgt[m] = (int)pt.btgt[band];
      const T x = mag[m];
      const bool in_window = act && x >= taub0 && x <= taub1;
      bool f0_sel, f1_sel;
      if (sample_age) {
        const bool touches = in_window && (msrc[m] == pop || mtgt[m] == pop);
        f1_sel = touches && x > tauold;
        f0_sel = touches && x <= tauold;
        checked[m] = touches;
        kind_out[m] = msrc[m] == pop;
      } else {
        const bool both_sons = in_window &&
            ((msrc[m] == son0 && mtgt[m] == son1) ||
             (msrc[m] == son1 && mtgt[m] == son0));
        const bool src_anc = in_window && !both_sons && msrc[m] == pop;
        const bool tgt_anc = in_window && !both_sons && !src_anc &&
                             mtgt[m] == pop;
        const bool src_son = in_window && !both_sons && !src_anc &&
                             !tgt_anc &&
                             (msrc[m] == son0 || msrc[m] == son1) &&
                             x > taub0;
        const bool tgt_son = in_window && !both_sons && !src_anc &&
                             !tgt_anc && !src_son &&
                             (mtgt[m] == son0 || mtgt[m] == son1) &&
                             x > taub0;
        f1_sel = src_anc || tgt_anc;
        f0_sel = both_sons || src_son || tgt_son;
        checked[m] = src_anc || tgt_anc || src_son || tgt_son;
        kind_out[m] = src_anc || src_son;
      }
      T y = x;
      if (f1_sel) y = taub1 + f1 * (x - taub1);
      if (f0_sel) y = taub0 + f0 * (x - taub0);
      new_mag[m] = act ? y : x;
      ntj0 += f0_sel ? 1 : 0;
      ntj1 += f1_sel ? 1 : 0;
    }
    // against the NEW band windows, OLD node ages, OLD neighbour mig ages
    for (int m = 0; m < M; ++m) {
      if (!checked[m]) continue;
      const int band = mbd[m];
      const T y = new_mag[m];
      bool c = y >= pt.be[band] || y <= pt.bs[band];
      // nearest events above/below on the same branch (ties by slot id)
      T up_age = d_inf<T>(), dn_age = -d_inf<T>();
      int up_slot = 0, dn_slot = 0;
      for (int m2 = 0; m2 < M; ++m2) {
        if (m2 == m || mbr[m2] < 0 || mbr[m2] != mbr[m]) continue;
        const T a2 = mag[m2];
        const bool abv = a2 > mag[m] || (a2 == mag[m] && m2 > m);
        const bool blw = a2 < mag[m] || (a2 == mag[m] && m2 < m);
        if (abv && a2 < up_age) { up_age = a2; up_slot = m2; }
        if (blw && a2 > dn_age) { dn_age = a2; dn_slot = m2; }
      }
      const int branch = mbr[m];
      const int fa = father[branch];
      if (!kind_out[m] && y > mag[m]) {          // in-migration moving up
        const int up_src = msrc[up_slot];
        const bool exempt = up_src == pop || up_src == son0 ||
                            up_src == son1;
        c = c || (isfinite(up_age) && !exempt && y >= up_age);
        c = c || (fa >= 0 && y >= age[fa]);
      }
      if (kind_out[m] && y < mag[m]) {           // out-migration moving down
        const int dn_tgt = mtgt[dn_slot];
        const bool exempt = dn_tgt == pop || dn_tgt == son0 ||
                            dn_tgt == son1;
        c = c || (isfinite(dn_age) && !exempt && y <= dn_age);
        c = c || (y <= age[branch]);
      }
      conflicts += c ? 1 : 0;
    }
  }
  copy_real((T*)a.age_out + (size_t)l * N, new_age, N);
  copy_real((T*)a.mig_age_out + (size_t)l * M, new_mag, M);

  // ---- full conditional rebuild on the proposed ages (post-order) ----
  T* cond = (T*)a.cond_out + (size_t)l * cn;
  const T* cin = (const T*)a.cond_in + (size_t)l * cn;
  copy_real(cond, cin, (size_t)S * P * 4);  // leaf rows
  {
    int stack[MAXN], order[MAXN];
    int sp = 0, no = 0;
    stack[sp++] = root;
    while (sp > 0) {  // reversed pre-order (node, right, left) ...
      const int v = stack[--sp];
      if (v < S) continue;
      order[no++] = v;
      stack[sp++] = lson[v];
      stack[sp++] = rson[v];
    }
    for (int j = no - 1; j >= 0; --j)  // ... read backwards: sons first
      recompute_node(cond, order[j], lson, rson, new_age, mut, P);
  }
  const i64* gid = (const i64*)a.group_id + (size_t)l * P;
  const T* gcount = (const T*)a.group_count + (size_t)l * P;
  const T* gnph = (const T*)a.group_nphases + (size_t)l * P;
  const bool* pvalid = (const bool*)a.pattern_valid + (size_t)l * P;
  T* gsum = (T*)a.gsum + (size_t)l * P;
  ((T*)a.lnld_out)[l] = root_lnld(cond, root, gid, gcount, gnph, pvalid,
                                  gsum, S, P);

  // ---- genealogy log-prior from scratch on the proposal ----
  T cap = new_age[0];
  for (int n = 1; n < N; ++n) cap = d_max(cap, new_age[n]);
  for (int r = 0; r < PP; ++r) cap = d_max(cap, pt.tau[r]);
  for (int b = 0; b < B; ++b) cap = d_max(cap, pt.be[b]);
  Segs<T> sg;
  sg.build(new_age, father, npop, mbr, mbd, new_mag, pt, cap, N, M);
  T lo[MAXN + MAXM], hi[MAXN + MAXM];
  bool pres[MAXN + MAXM];
  T lnp = (T)0;
  for (int r = 0; r < PP; ++r) {
    for (int s = 0; s < sg.n; ++s) {
      lo[s] = d_max(sg.start[s], pt.tau[r]);
      hi[s] = d_min(sg.end[s], pt.pend[r]);
      pres[s] = sg.valid[s] && pt.is_anc(r, sg.base[s]) && hi[s] > lo[s];
    }
    T pair = (T)0, length = (T)0;
    for (int s = 0; s < sg.n; ++s) {
      if (!pres[s]) continue;
      for (int s2 = 0; s2 < sg.n; ++s2)
        if (pres[s2])
          pair += d_max(d_min(hi[s], hi[s2]) - d_max(lo[s], lo[s2]), (T)0);
      length += d_max(hi[s] - lo[s], (T)0);
    }
    const T coal = pair - length;
    int ncoal = 0;
    for (int n = S; n < N; ++n) ncoal += npop[n] == r ? 1 : 0;
    lnp += (T)ncoal * d_log((T)2 / pt.theta[r]) - coal / pt.theta[r];
  }
  if (B > 0) {
    T sm = (T)0;
    for (int b = 0; b < B; ++b) {
      const int tb = (int)pt.btgt[b];
      T mig = (T)0;
      for (int s = 0; s < sg.n; ++s) {
        const T l0 = d_max(sg.start[s], pt.tau[tb]);
        const T h0 = d_min(sg.end[s], pt.pend[tb]);
        const bool p0 = sg.valid[s] && pt.is_anc(tb, sg.base[s]) && h0 > l0;
        const T lt = d_max(l0, pt.bs[b]), ht = d_min(h0, pt.be[b]);
        if (p0 && ht > lt) mig += d_max(ht - lt, (T)0);
      }
      int nmig = 0;
      for (int m = 0; m < M; ++m) nmig += (mbr[m] >= 0 && mbd[m] == b);
      const T mr = pt.rate[b];
      if (mr > (T)0) sm += (T)nmig * d_log(mr) - mig * mr;
    }
    lnp += sm;
  }
  ((T*)a.lnp_out)[l] = real ? lnp : (T)0;
  ((int*)a.aux0_out)[l] = ntj0;
  ((int*)a.aux1_out)[l] = ntj1;
  ((int*)a.aux2_out)[l] = conflicts;
}

SWEEP_ENTRY(rubber_band, rubber_band_kernel)
