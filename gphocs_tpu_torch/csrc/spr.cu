// SPR-with-migration sweep (UpdateGB_MigSPR) for NVIDIA Hopper.
//
// Replaces: gphocs_tpu/ops/sweeps_pallas.py _spr_kernel (via
// spr_sweep_pallas).  Plain version: kernels/spr.py update_spr at
// sync_group = 1; wrapper: ops/sweeps.py spr_sweep.
//
// For each locus, N sequential node steps: prune the node's edge;
// re-coalesce it by hazard inversion over the sorted boundary grid of
// K = N + M + PP + 2B + 1 times (only the sorted values flow downstream),
// 2 draws per walk trip, at most M + 3 trips; commit the new topology and
// migration events (the where-chain order of _apply_spr); refresh the
// conditionals along the root paths of f and of the old grandfather on a
// proposal copy; MH on the data likelihood (1 draw).
//
// RNG schedule: a locus walks on its own.  Its trips end when its own
// status leaves 0, it keeps its own draw offset, and the wrapper advances
// the shared counter by the largest offset over the valid and invalid loci
// alike (stat[1]).  Draw k of locus l depends only on (key[l], ctr + k), so
// the result does not depend on the number of loci per block; it equals
// the plain version at sync_group = 1.
//
// What bounds it on this card: a chain of dependent steps per locus, not
// bytes or arithmetic.  N steps, each a sort, 1-2 trips of hazards + scan
// + two dependent logarithms, two root-path refreshes and a root reduce,
// every one waiting for the one before.  The card can only run many loci
// side by side and keep each step short.  The design:
//   * a warp per locus, a.block loci per block (125 blocks at L = 1000
//     instead of 16).  Lanes take the per-segment hazards (each lane its
//     own lineage count, from the top of the grid down), the grid sort
//     (rank counting: a lane counts the elements below its own, index as
//     tie-break, two elements in one pass where K > 32), the prefix scan
//     (Hillis-Steele on two buffers: the shift-add association of
//     kernels/spr.py, same bits), the first crossing (min over lanes), the
//     covering-branch flags, the where-chains of the commit over nodes and
//     slots, and the P x 4 outputs of every combine;
//   * every per-locus table in dynamic shared memory, sized from N, M, K,
//     P: topology as ints, ages, migration tables, the grid, hazards and
//     scan buffers, the proposal copies;
//   * the locus's conditionals and their proposal copy in shared memory
//     where they fit (a.cond_smem), staged in and out with coalesced
//     loads; else the same code works on cond_out and prop in device
//     memory, where a warp reads a row contiguously;
//   * the lineage count of a segment is the count by node population plus
//     one correction per migration window that covers the segment (the
//     plain version's n_by_base): O(N + M) instead of a scan of the slots
//     for every branch, integers, so the same hazard bits; the loops over
//     slots are skipped for a locus without migration events;
//   * with two warps per scheduler nothing hides latency, so the hot loops
//     (lineage count, population hit, ranking) are written without
//     short-circuits and with the ancestor relation as bit masks: their
//     shared-memory loads overlap instead of waiting for each other
//     (0.33 -> 0.21 ms at L = 1000, f32);
//   * accepts and the largest draw offset are reduced here with integer
//     atomics (one per warp), so the wrapper launches next to nothing
//     besides this.
#include "sweeps_common.cuh"

// reals and ints of one locus's tables, without the conditionals
__host__ __device__ inline int spr_reals(int N, int M, int K, int P) {
  return 3 * N + 4 * M + 4 * K + 3 * P;
}
__host__ __device__ inline int spr_ints(int N, int M, int P) {
  return 9 * N + 7 * M + P;
}

template <typename T>
int spr_smem_bytes(const SweepArgs& a) {
  const int K = a.N + a.M + a.PP + 2 * a.B + 1;
  const int cn = a.cond_smem ? 2 * a.N * a.P * 4 : 0;
  return a.block * locus_bytes<T>(spr_reals(a.N, a.M, K, a.P) + cn,
                                  spr_ints(a.N, a.M, a.P));
}

// Lineage count at time `mid` in the pop whose ancestor-or-self bits are
// `row`, the pruned branch `skip` excluded: the branches alive at mid by
// their node's pop, and (any_mig: the locus has migration events) for every
// migration window that covers mid the band's source pop in place of the
// branch's.  (The windows of one branch are disjoint.)  Written without
// short-circuits, so that the loads of the iterations overlap.
template <typename T>
__device__ __forceinline__ int lineages_at(T mid, unsigned row, int skip,
                                           const T* age, const T* top,
                                           const int* npop, const int* mbr,
                                           const T* mag, const T* win_hi,
                                           const int* src_m, int N, int M,
                                           bool any_mig) {
  int n = 0;
#pragma unroll 4
  for (int v = 0; v < N; ++v) {
    const bool alive = (v != skip) & (age[v] <= mid) & (mid < top[v]);
    n += alive ? (int)((row >> npop[v]) & 1u) : 0;
  }
  if (any_mig) {
#pragma unroll 2
    for (int m = 0; m < M; ++m) {
      const int b = mbr[m], bs = b < 0 ? 0 : b;
      const bool on = (b >= 0) & (b != skip) & (mag[m] <= mid) &
                      (mid < win_hi[m]) & (age[bs] <= mid) & (mid < top[bs]);
      n += on ? (int)((row >> src_m[m]) & 1u) - (int)((row >> npop[bs]) & 1u)
              : 0;
    }
  }
  return n;
}

// the pop of the segment at `mid` along the ancestors of pop_c (the first
// in pop order), -1 if none
template <typename T>
__device__ __forceinline__ int hit_pop(T mid, int pop_c,
                                       const PopTables<T>& pt) {
  unsigned hits = 0;
  for (int p = 0; p < pt.PP; ++p)
    hits |= ((pt.tau[p] <= mid) & (mid < pt.pend[p]) ? 1u : 0u) << p;
  hits &= pt.anccol[pop_c];
  return hits ? __ffs((int)hits) - 1 : -1;
}

template <typename T>
__device__ __forceinline__ T mig_into(T mid, int p, const PopTables<T>& pt) {
  T r = (T)0;
  for (int b = 0; b < pt.B; ++b)
    if (pt.bs[b] <= mid && pt.be[b] > mid && pt.btgt[b] == p)
      r += pt.rate[b];
  return r;
}

// The SWEEP_TICK marks below end the phases that tools/sweep_phases.py
// names (SPR_PHASES there); the number of the kernel's own is the draw
// offset.
template <typename T>
__global__ void spr_kernel(const SweepArgs a) {
  __shared__ PopTables<T> pt;
  const int c = blockIdx.y;  // the chain of this block
  pt.load(a, false, c);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  (void)lane;
  const int li = blockIdx.x * a.block + w;  // the locus within its chain
  if (li >= a.Lc) return;
  const int l = c * a.Lc + li;
  SWEEP_PROF_BEGIN
  const int N = a.N, S = (N + 1) / 2, M = a.M, B = a.B, PP = a.PP, P = a.P;
  const int K = N + M + PP + 2 * B + 1;
  const size_t cn = (size_t)N * P * 4;
  const T oldage = (T)a.oldage;

  // ---- this locus's tables in shared memory ----
  const int nreal = spr_reals(N, M, K, P) + (a.cond_smem ? 2 * (int)cn : 0);
  unsigned char* region =
      sweep_smem + (size_t)w * locus_bytes<T>(nreal, spr_ints(N, M, P));
  T* age = (T*)region;     T* mag = age + N;
  T* age_p = mag + M;      T* mag_p = age_p + N;      // proposal copies
  T* top = mag_p + M;      // edge tops
  T* win_hi = top + N;     // top of slot m's window on its branch
  T* new_age = win_hi + M;  // ages of the walk's new migration events
  T* bnd = new_age + M;    // sorted boundary grid
  T* hz = bnd + K;
  T* e0 = hz + K;          T* e1 = e0 + K;            // scan buffers
  T* gcount = e1 + K;      T* lg4 = gcount + P;       T* gsum = lg4 + P;
  T* cond_s = gsum + P;
  int* lson = (int*)((T*)region + nreal);
  int* rson = lson + N;    int* father = rson + N;    int* npop = father + N;
  int* ls_p = npop + N;    int* rs_p = ls_p + N;      int* fa_p = rs_p + N;
  int* pop_p = fa_p + N;
  int* cov = pop_p + N;    // covering-branch flags of the coalescence
  int* mbr = cov + N;      int* mbd = mbr + M;
  int* mbr_p = mbd + M;    int* mbd_p = mbr_p + M;
  int* src_m = mbd_p + M;  // source pop of slot m's band
  int* new_band = src_m + M;
  int* freef = new_band + M;  // slots free after the commit's removals
  int* gid = freef + M;
  T* cond = a.cond_smem ? cond_s : (T*)a.cond_out + (size_t)l * cn;
  T* prop = a.cond_smem ? cond_s + cn : (T*)a.prop + (size_t)l * cn;

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
    const T* cin = (const T*)a.cond_in + (size_t)l * cn;
    LANES(j, (int)cn) {  // invariant: prop == cond between steps
      const T x = cin[j];
      cond[j] = x;
      prop[j] = x;
    }
  }
  load_seq_w(a, l, gid, gcount, lg4, lane);
  int root = (int)((const i64*)a.root)[l];
  const T mut = ((const T*)a.mut_rate)[l];
  const bool real = ((const bool*)a.valid)[l];
  const uint32_t key = (uint32_t)((const i64*)a.key)[l];
  const uint32_t ctr0 = (uint32_t)((const i64*)a.ctr)[c];
  T lnld = ((const T*)a.lnld_in)[l];
  int acc = 0;
  uint32_t doff = 0;
  SWEEP_TICK(0)

  for (int i = 0; i < N; ++i) {
    const bool active0 = real && root != i;
    // ---- per-step tables: edge tops, mig windows, boundary grid ----
    int base_migs = 0;
    bool any_mig = false;  // the locus has migration events
    if (active0) {
      LANES(k, K) {  // edge tops, and the grid, unsorted
        if (k < N) top[k] = father[k] < 0 ? oldage : age[father[k]];
        T x;
        if (k == 0) x = oldage;
        else if (k <= N) x = age[k - 1];
        else if (k <= N + M) x = mbr[k - 1 - N] >= 0 ? mag[k - 1 - N] : (T)0;
        else if (k <= N + M + PP) x = pt.tau[k - 1 - N - M];
        else if (k <= N + M + PP + B) x = pt.bs[k - 1 - N - M - PP];
        else x = pt.be[k - 1 - N - M - PP - B];
        e1[k] = x;
      }
      int nact = 0;
      LANES(m, M) {
        const bool act = mbr[m] >= 0;
        nact += act ? 1 : 0;
        base_migs += (act && mbr[m] != i) ? 1 : 0;
        win_hi[m] = act ? d_min(next_mig_above(m, mbr, mag, M), top[mbr[m]])
                        : (T)0;
        src_m[m] = (act && B > 0) ? pt.bsrc[mbd[m]] : 0;
      }
      base_migs = warp_sum(base_migs);
      any_mig = warp_sum(nact) > 0;
      SWEEP_TICK(1)
      LANES(k, 32) {  // ascending, by rank; a lane ranks two elements
        for (int ka = k; ka < K; ka += 64) {  // in one pass over the grid
          const int kb = ka + 32;
          const bool two = kb < K;
          const T xa = e1[ka], xb = two ? e1[kb] : (T)0;
          int ra = 0, rb = 0;
#pragma unroll 4
          for (int j = 0; j < K; ++j) {
            const T y = e1[j];
            ra += ((y < xa) | ((y == xa) & (j < ka))) ? 1 : 0;
            rb += ((y < xb) | ((y == xb) & (j < kb))) ? 1 : 0;
          }
          bnd[ra] = xa;
          if (two) bnd[rb] = xb;
        }
      }
    }

    SWEEP_TICK(2)
    // ---- the walk ----
    int status = active0 ? 0 : -2;
    int pop_c = npop[i];
    T age_c = age[i];
    int n_new = 0, target = 0;
    T coal_age = (T)0;
    for (int trips = 0; status == 0 && trips < M + 3; ++trips) {
      // hazard of each segment above age_c along pop_c's ancestors; from
      // the top down, so that the segments of zero length at the bottom
      // of the grid fall to the last turn of the lanes
      LANES(j, K) {
        const int k = K - 1 - j;
        const T lo_b = k == 0 ? (T)0 : bnd[k - 1];
        const T lo = d_max(lo_b, age_c), hi = d_max(bnd[k], age_c);
        const T seg_len = d_max(hi - lo, (T)0);
        T h = (T)0;
        if (seg_len > (T)0) {
          const T mid = (T)0.5 * (lo_b + bnd[k]);
          const int p = hit_pop(mid, pop_c, pt);
          if (p >= 0) {
            const T n = (T)lineages_at(mid, pt.ancrow[p], i, age, top, npop,
                                       mbr, mag, win_hi, src_m, N, M,
                                       any_mig);
            const T rate = mig_into(mid, p, pt) +
                           (T)2 * n * ((T)1 / pt.theta[p]);
            h = rate * seg_len;
          }
        }
        hz[k] = h;
      }
      SWEEP_TICK(3)
      // log-depth EXCLUSIVE prefix, additions only (the shift-add
      // association of kernels/spr.py), on two buffers.  The first pass
      // reads hz shifted by one: hz[0] stands for hz[0] + 0.
      LANES(k, K)
        e0[k] = k >= 2 ? hz[k - 1] + hz[k - 2] : (k == 1 ? hz[0] : (T)0);
      T* ea = e0;
      T* eb = e1;
      for (int s = 2; s < K; s *= 2) {
        LANES(k, K) eb[k] = k >= s ? ea[k] + ea[k - s] : ea[k];
        T* t = ea; ea = eb; eb = t;
      }
      const T* ecum = ea;
      SWEEP_TICK(4)
      const T u1 = uniform<T>(key, ctr0 + doff + 1);
      const T E = -d_log(d_max(u1, (T)1e-300));
      int kk = K;  // the first segment whose cumulative hazard reaches E
      LANES(k, K)
        if (ecum[k] + hz[k] >= E && k < kk) kk = k;
      kk = warp_min(kk);
      const bool exits = kk >= K;
      if (exits) kk = 0;
      const T lo_b = kk == 0 ? (T)0 : bnd[kk - 1];
      const T mid = (T)0.5 * (lo_b + bnd[kk]);
      const T lo_k = d_max(lo_b, age_c), hi_k = d_max(bnd[kk], age_c);
      const int hp = hit_pop(mid, pop_c, pt);
      const int pop_k = hp < 0 ? 0 : hp;
      T n_k = (T)0, migr_k = (T)0, theta_k = (T)0, rate_k = (T)0;
      if (hp >= 0) {
        n_k = (T)lineages_at(mid, pt.ancrow[hp], i, age, top, npop, mbr, mag,
                             win_hi, src_m, N, M, any_mig);
        migr_k = mig_into(mid, hp, pt);
        theta_k = pt.theta[hp];
        rate_k = migr_k + (T)2 * n_k * ((T)1 / pt.theta[hp]);
      }
      T t_event = lo_k + (E - ecum[kk]) / d_max(rate_k, (T)1e-300);
      t_event = d_min(d_max(t_event, lo_k), hi_k);

      const bool ev = !exits;
      const T u2 = uniform<T>(key, ctr0 + doff + 2);
      const T esample = u2 * rate_k;
      const bool is_mig = ev && esample < migr_k && B > 0;
      const bool over_cap = is_mig && base_migs + n_new + 1 > M;
      int chosen = 0;
      int src_pop = pop_c;
      if (B > 0) {
        T cumb = (T)0;
        bool found = false;
        for (int b = 0; b < B; ++b) {
          const bool lv = pt.btgt[b] == pop_k && pt.bs[b] <= t_event &&
                          pt.be[b] > t_event;
          cumb += lv ? pt.rate[b] : (T)0;
          if (!found && lv && cumb > esample) { chosen = b; found = true; }
        }
        src_pop = pt.bsrc[chosen];
      }
      const bool do_mig = is_mig && !over_cap;
      if (do_mig) {
        const int slot = n_new < 0 ? 0 : (n_new > M - 1 ? M - 1 : n_new);
        ONE_LANE {
          new_band[slot] = chosen;
          new_age[slot] = t_event;
        }
        ++n_new;
      }
      SWEEP_TICK(5)
      // coalescence: the i_pick-th covering branch in node-id order
      const bool is_coal = ev && !is_mig;
      int tgt = 0;
      if (is_coal) {
        long long i_pick = (long long)d_floor((esample - migr_k) * theta_k /
                                              (T)2);
        const long long nmax = (long long)n_k - 1;
        i_pick = i_pick < 0 ? 0 : i_pick;
        i_pick = i_pick > (nmax < 0 ? 0 : nmax) ? (nmax < 0 ? 0 : nmax)
                                                : i_pick;
        LANES(v, N) {
          // trajectory pop: source of the last migration below t_event
          int traj = npop[v];
          if (any_mig) {
            T best = -d_inf<T>();
            for (int m = 0; m < M; ++m)
              if ((mbr[m] == v) & (mag[m] < t_event) & (mag[m] > best)) {
                best = mag[m];
                traj = pt.bsrc[mbd[m]];
              }
          }
          const bool alive = (v != i) & (age[v] <= t_event) &
                             (t_event < top[v]);
          cov[v] = (alive && pt.is_anc(pop_k, traj)) ? 1 : 0;
        }
        long long csum = 0;
        for (int v = 0; v < N; ++v)
          if (cov[v] && ++csum > i_pick) { tgt = v; break; }
      }
      const bool coal_ok = is_coal && n_k > (T)0;
      if (exits) status = -1;
      if (over_cap) status = -1;
      if (coal_ok) status = 1;
      if (is_coal && n_k <= (T)0) status = -1;
      if (do_mig) { pop_c = src_pop; age_c = t_event; }
      if (coal_ok) { pop_c = pop_k; target = tgt; coal_age = t_event; }
      doff += 2;
      SWEEP_TICK(6)
    }
    if (status == 0) status = -1;
    const bool ok = status == 1;

    // ---- commit (proposed values; the _apply_spr where-chains) ----
    if (active0) {
      const int f = father[i];
      const int fs = f < 0 ? 0 : f;
      const int sib = lson[fs] + rson[fs] - i;
      const int g = father[fs];
      const int tgt_fa = father[target];
      const bool tc = ok && target != sib && target != f;
      LANES(v, N) {
        age_p[v] = (ok && v == f) ? coal_age : age[v];
        pop_p[v] = (ok && v == f) ? pop_c : npop[v];
        int x = father[v];
        if (tc && v == sib) x = g;
        if (tc && v == f) x = tgt_fa;
        if (tc && v == target) x = f;
        fa_p[v] = x;
        int y = (tc && v == g && lson[v] == f) ? sib : lson[v];
        if (tc && v == f) y = i;
        if (tc && v == tgt_fa && y == target) y = f;
        ls_p[v] = y;
        int z = (tc && v == g && rson[v] == f) ? sib : rson[v];
        if (tc && v == f) z = target;
        if (tc && v == tgt_fa && z == target) z = f;
        rs_p[v] = z;
      }
      const int root_p = (tc && tgt_fa < 0) ? f : ((tc && g < 0) ? sib : root);
      const int t_eff = target == f ? sib : target;
      LANES(m, M) {
        const bool act = mbr[m] >= 0;
        const bool keep = act && !(ok && mbr[m] == i);
        int mb2 = (ok && mbr[m] == f) ? sib : mbr[m];
        if (ok && mb2 == t_eff && mag[m] >= coal_age) mb2 = f;
        mbr_p[m] = keep ? mb2 : -1;
        mbd_p[m] = keep ? mbd[m] : 0;
        mag_p[m] = keep ? mag[m] : (T)0;
        freef[m] = keep ? 0 : 1;
      }
      LANES(m, M) {  // the j-th free slot takes the j-th new event
        if (!freef[m]) continue;
        int r = 0;
        for (int m2 = 0; m2 < m; ++m2) r += freef[m2];
        if (ok && r < n_new) {
          mbr_p[m] = i;
          mbd_p[m] = new_band[r];
          mag_p[m] = new_age[r];
        }
      }
      SWEEP_TICK(7)
      // data delta: refresh the root paths of f and of g (new topology)
      uint64_t dirty = refresh_path_w(prop, f, ls_p, rs_p, fa_p, age_p, mut,
                                      N, S, P, lane);
      if (g >= 0)
        dirty |= refresh_path_w(prop, g, ls_p, rs_p, fa_p, age_p, mut, N, S,
                                P, lane);
      SWEEP_TICK(8)
      const T lnld_new = root_lnld_w(prop, root_p, gid, gcount, lg4, gsum, S,
                                     P, lane);
      SWEEP_TICK(9)
      const T u = uniform<T>(key, ctr0 + doff + 1);
      const bool accept = ok && mh(lnld_new - lnld, u);
      if (accept) {
        LANES(j, N > M ? N : M) {
          if (j < N) {
            age[j] = age_p[j]; npop[j] = pop_p[j]; father[j] = fa_p[j];
            lson[j] = ls_p[j]; rson[j] = rs_p[j];
          }
          if (j < M) {
            mbr[j] = mbr_p[j]; mbd[j] = mbd_p[j]; mag[j] = mag_p[j];
          }
        }
        root = root_p;
        copy_rows_w(cond, prop, dirty, P, lane);
        lnld = lnld_new;
        ++acc;
      } else {
        copy_rows_w(prop, cond, dirty, P, lane);
      }
      SWEEP_TICK(10)
    }
    doff += 1;
  }

  {
    T* o_age = (T*)a.age_out + (size_t)l * N;
    i64* o_ls = (i64*)a.lson_out + (size_t)l * N;
    i64* o_rs = (i64*)a.rson_out + (size_t)l * N;
    i64* o_fa = (i64*)a.father_out + (size_t)l * N;
    i64* o_np = (i64*)a.node_pop_out + (size_t)l * N;
    LANES(v, N) {
      o_age[v] = age[v];
      o_ls[v] = lson[v];
      o_rs[v] = rson[v];
      o_fa[v] = father[v];
      o_np[v] = npop[v];
    }
    i64* o_mb = (i64*)a.mig_branch_out + (size_t)l * M;
    i64* o_md = (i64*)a.mig_band_out + (size_t)l * M;
    T* o_ma = (T*)a.mig_age_out + (size_t)l * M;
    LANES(m, M) {
      o_mb[m] = mbr[m];
      o_md[m] = mbd[m];
      o_ma[m] = mag[m];
    }
    if (a.cond_smem) {
      T* o_cond = (T*)a.cond_out + (size_t)l * cn;
      LANES(j, (int)cn) o_cond[j] = cond[j];
    }
    ONE_LANE {
      ((i64*)a.root_out)[l] = root;
      ((T*)a.lnld_out)[l] = lnld;
      int* stat = (int*)a.stat + 2 * c;  // this chain's counts
      if (acc) atomicAdd(stat + 0, acc);
      atomicMax(stat + 1, (int)doff);
    }
    SWEEP_TICK(11)
    SWEEP_PROF_END(doff)
  }
}

SWEEP_ENTRY_WARP(spr, spr_kernel, spr_smem_bytes)
