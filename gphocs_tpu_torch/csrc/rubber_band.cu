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
// overlaps of the segment set with the tight root cap).  No RNG.
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
// What bounds it on this card: a chain of dependent steps per locus (the
// post-order rebuild, N - S combines each waiting for its sons, then PP
// rounds of the pairwise prior), not bytes or arithmetic; the card can
// only run many loci side by side and keep each step short.  The design:
//   * a warp per locus, a.block loci per block (125 blocks at L = 1000
//     instead of 16).  Lanes take the remaps over nodes and migration
//     slots, the conflict scan over slots, the P x 4 outputs of a combine,
//     the segment build, and the rows of the pairwise prior;
//   * every per-locus table in dynamic shared memory, sized from N, M, P;
//     the conditionals too where a locus fits (a.cond_smem), staged in and
//     out with coalesced row loads, else the same code works on cond_out in
//     device memory, where a warp reads a row contiguously;
//   * the population tables (with taunew in tau[pop], pop_end and the new
//     band windows) are made by the block's prologue from the state's own
//     tensors, and the Jacobian counts and the conflict count of the valid
//     loci are added up here (integers: warp reduce, one atomicAdd per warp
//     and count), so the wrapper launches next to nothing besides this;
//   * sums in a fixed order: the pairwise overlap of population r is summed
//     row by row (row s over s2 in index order, by the lane that owns the
//     row), then the rows in index order.  The plain version and the
//     thread-per-locus kernel before this one added all (s, s2) terms in
//     one running sum, so lnp differs from theirs by rounding (~1e-13
//     relative), and is equal for every number of loci per block.
#include "sweeps_common.cuh"

// reals and ints of one locus's tables, without the conditionals
__host__ __device__ inline int rubber_reals(int N, int M, int P) {
  return 3 * N + 2 * M + 5 * (N + M) + 3 * P;
}
__host__ __device__ inline int rubber_ints(int N, int M, int P) {
  return 6 * N + 5 * M + 2 * (N + M) + P;
}

template <typename T>
int rubber_smem_bytes(const SweepArgs& a) {
  const int cn = a.cond_smem ? a.N * a.P * 4 : 0;
  return a.block * locus_bytes<T>(rubber_reals(a.N, a.M, a.P) + cn,
                                  rubber_ints(a.N, a.M, a.P));
}

template <typename T>
__global__ void rubber_band_kernel(const SweepArgs a) {
  __shared__ PopTables<T> pt;  // tau/pop_end/band windows of the PROPOSAL
  const int c = blockIdx.y;  // the chain of this block
  pt.load(a, a.sample_age == 0, c);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  (void)lane;
  const int li = blockIdx.x * a.block + w;  // the locus within its chain
  if (li >= a.Lc) return;
  const int l = c * a.Lc + li;
  const int N = a.N, S = (N + 1) / 2, M = a.M, B = a.B, PP = a.PP, P = a.P;
  const int NS = N + M;
  const size_t cn = (size_t)N * P * 4;
  const T taub0 = ((const T*)a.taub0)[c];
  const T taub1 = ((const T*)a.taub1)[c];
  const T tauold = ((const T*)a.tauold)[c];
  const T taunew = ((const T*)a.taunew)[c];
  const int pop = a.pop;
  const bool is_root = a.is_root != 0;
  const bool sample_age = a.sample_age != 0;

  // ---- this locus's tables in shared memory ----
  const int nreal = rubber_reals(N, M, P) + (a.cond_smem ? (int)cn : 0);
  unsigned char* region =
      sweep_smem + (size_t)w * locus_bytes<T>(nreal, rubber_ints(N, M, P));
  T* age = (T*)region;       T* mag = age + N;
  T* new_age = mag + M;      T* new_mag = new_age + N;
  T* top = new_mag + M;
  T* sstart = top + N;       T* send = sstart + NS;
  T* lo = send + NS;         T* hi = lo + NS;
  T* rowp = hi + NS;
  T* gcount = rowp + NS;     T* lg4 = gcount + P;     T* gsum = lg4 + P;
  T* cond_s = gsum + P;
  int* lson = (int*)((T*)region + nreal);
  int* rson = lson + N;      int* father = rson + N;  int* npop = father + N;
  int* order = npop + N;     int* stack = order + N;
  int* mbr = stack + N;      int* mbd = mbr + M;
  int* msrc = mbd + M;       int* mtgt = msrc + M;
  int* mflag = mtgt + M;     // bit 0: conflict-checked, bit 1: out-migration
  int* base = mflag + M;     // segment's base pop, -1 for no segment
  int* pres = base + NS;
  int* gid = pres + NS;
  T* cond = a.cond_smem ? cond_s : (T*)a.cond_out + (size_t)l * cn;

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
    const i64* g_md = (const i64*)a.mig_band + (size_t)l * M;
    const T* g_ma = (const T*)a.mig_age + (size_t)l * M;
    LANES(m, M) {
      mbr[m] = (int)g_mb[m];
      mbd[m] = (int)g_md[m];
      mag[m] = g_ma[m];
    }
    // the leaf rows of the conditionals
    const T* cin = (const T*)a.cond_in + (size_t)l * cn;
    LANES(j, S * P * 4) cond[j] = cin[j];
  }
  load_seq_w(a, l, gid, gcount, lg4, lane);
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
  int ntj0 = 0, ntj1 = 0;  // this lane's share; reduced at the end
  LANES(n, N) {
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
  if (B == 0) {
    LANES(m, M) new_mag[m] = mag[m];
  } else {
    LANES(m, M) {
      const bool act = mbr[m] >= 0;
      const int band = act ? mbd[m] : 0;
      const int src = pt.bsrc[band], tgt = pt.btgt[band];
      msrc[m] = src;
      mtgt[m] = tgt;
      const T x = mag[m];
      const bool in_window = act && x >= taub0 && x <= taub1;
      bool f0_sel, f1_sel, checked, kind_out;
      if (sample_age) {
        const bool touches = in_window && (src == pop || tgt == pop);
        f1_sel = touches && x > tauold;
        f0_sel = touches && x <= tauold;
        checked = touches;
        kind_out = src == pop;
      } else {
        const bool both_sons = in_window &&
            ((src == son0 && tgt == son1) || (src == son1 && tgt == son0));
        const bool src_anc = in_window && !both_sons && src == pop;
        const bool tgt_anc = in_window && !both_sons && !src_anc &&
                             tgt == pop;
        const bool src_son = in_window && !both_sons && !src_anc &&
                             !tgt_anc && (src == son0 || src == son1) &&
                             x > taub0;
        const bool tgt_son = in_window && !both_sons && !src_anc &&
                             !tgt_anc && !src_son &&
                             (tgt == son0 || tgt == son1) && x > taub0;
        f1_sel = src_anc || tgt_anc;
        f0_sel = both_sons || src_son || tgt_son;
        checked = src_anc || tgt_anc || src_son || tgt_son;
        kind_out = src_anc || src_son;
      }
      T y = x;
      if (f1_sel) y = taub1 + f1 * (x - taub1);
      if (f0_sel) y = taub0 + f0 * (x - taub0);
      new_mag[m] = act ? y : x;
      mflag[m] = (checked ? 1 : 0) | (kind_out ? 2 : 0);
      ntj0 += f0_sel ? 1 : 0;
      ntj1 += f1_sel ? 1 : 0;
    }
    // against the NEW band windows, OLD node ages, OLD neighbour mig ages
    LANES(m, M) {
      if (!(mflag[m] & 1)) continue;
      const bool kind_out = (mflag[m] & 2) != 0;
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
      if (!kind_out && y > mag[m]) {             // in-migration moving up
        const int up_src = msrc[up_slot];
        const bool exempt = up_src == pop || up_src == son0 ||
                            up_src == son1;
        c = c || (isfinite(up_age) && !exempt && y >= up_age);
        c = c || (fa >= 0 && y >= age[fa]);
      }
      if (kind_out && y < mag[m]) {              // out-migration moving down
        const int dn_tgt = mtgt[dn_slot];
        const bool exempt = dn_tgt == pop || dn_tgt == son0 ||
                            dn_tgt == son1;
        c = c || (isfinite(dn_age) && !exempt && y <= dn_age);
        c = c || (y <= age[branch]);
      }
      conflicts += c ? 1 : 0;
    }
  }
  {
    T* o_age = (T*)a.age_out + (size_t)l * N;
    T* o_mag = (T*)a.mig_age_out + (size_t)l * M;
    LANES(v, N) o_age[v] = new_age[v];
    LANES(m, M) o_mag[m] = new_mag[m];
  }

  // ---- full conditional rebuild on the proposed ages (post-order) ----
  int no = 0;
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
  no = stack[0];
  for (int j = no - 1; j >= 0; --j)  // ... read backwards: sons first
    recompute_node_w(cond, order[j], lson, rson, new_age, mut, P, lane);
  const T lnld = root_lnld_w(cond, root, gid, gcount, lg4, gsum, S, P, lane);
  if (a.cond_smem) {
    T* o_cond = (T*)a.cond_out + (size_t)l * cn;
    LANES(j, (int)cn) o_cond[j] = cond[j];
  }

  // ---- genealogy log-prior from scratch on the proposal ----
  // segment set (ops/coalstats.segments) with the tight root cap: N edge
  // segments, then M migration segments
  T cap = new_age[0];
  for (int n = 1; n < N; ++n) cap = d_max(cap, new_age[n]);
  for (int r = 0; r < PP; ++r) cap = d_max(cap, pt.tau[r]);
  for (int b = 0; b < B; ++b) cap = d_max(cap, pt.be[b]);
  LANES(v, N) top[v] = father[v] < 0 ? cap : new_age[father[v]];
  LANES(s, NS) {
    if (s < N) {
      sstart[s] = new_age[s];
      send[s] = d_min(top[s], first_mig_on(s, mbr, new_mag, M));
      base[s] = npop[s];
    } else {
      const int m = s - N;
      const bool act = mbr[m] >= 0;
      sstart[s] = act ? new_mag[m] : (T)0;
      send[s] = act ? d_min(next_mig_above(m, mbr, new_mag, M), top[mbr[m]])
                    : (T)0;
      base[s] = act ? (B > 0 ? pt.bsrc[mbd[m]] : 0) : -1;
    }
  }
  T lnp = (T)0;
  for (int r = 0; r < PP; ++r) {
    LANES(s, NS) {
      lo[s] = d_max(sstart[s], pt.tau[r]);
      hi[s] = d_min(send[s], pt.pend[r]);
      pres[s] = base[s] >= 0 && pt.is_anc(r, base[s]) && hi[s] > lo[s];
    }
    LANES(s, NS) {  // row s of the pairwise overlaps, s2 in index order
      T row = (T)0;
      if (pres[s])
        for (int s2 = 0; s2 < NS; ++s2)
          if (pres[s2])
            row += d_max(d_min(hi[s], hi[s2]) - d_max(lo[s], lo[s2]), (T)0);
      rowp[s] = row;
    }
    T pair = (T)0, length = (T)0;
    for (int s = 0; s < NS; ++s) {
      if (!pres[s]) continue;
      pair += rowp[s];
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
      const int tb = pt.btgt[b];
      LANES(s, NS) {
        const T l0 = d_max(sstart[s], pt.tau[tb]);
        const T h0 = d_min(send[s], pt.pend[tb]);
        const bool p0 = base[s] >= 0 && pt.is_anc(tb, base[s]) && h0 > l0;
        const T lt = d_max(l0, pt.bs[b]), ht = d_min(h0, pt.be[b]);
        rowp[s] = (p0 && ht > lt) ? d_max(ht - lt, (T)0) : (T)0;
        pres[s] = p0 && ht > lt;
      }
      T mig = (T)0;
      for (int s = 0; s < NS; ++s)
        if (pres[s]) mig += rowp[s];
      int nmig = 0;
      for (int m = 0; m < M; ++m) nmig += (mbr[m] >= 0 && mbd[m] == b);
      const T mr = pt.rate[b];
      if (mr > (T)0) sm += (T)nmig * d_log(mr) - mig * mr;
    }
    lnp += sm;
  }
  // integer sums over the valid loci; an invalid locus adds nothing
  ntj0 = warp_sum(ntj0);
  ntj1 = warp_sum(ntj1);
  conflicts = warp_sum(conflicts);
  ONE_LANE {
    ((T*)a.lnld_out)[l] = lnld;
    ((T*)a.lnp_out)[l] = real ? lnp : (T)0;
    if (real) {
      int* stat = (int*)a.stat + 3 * c;  // this chain's counts
      if (ntj0) atomicAdd(stat + 0, ntj0);
      if (ntj1) atomicAdd(stat + 1, ntj1);
      if (conflicts) atomicAdd(stat + 2, conflicts);
    }
  }
}

SWEEP_ENTRY_WARP(rubber_band, rubber_band_kernel, rubber_smem_bytes)
