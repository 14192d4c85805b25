// SPR-with-migration sweep (UpdateGB_MigSPR) for NVIDIA Hopper.
//
// Replaces: gphocs_tpu/ops/sweeps_pallas.py _spr_kernel (via
// spr_sweep_pallas).  Plain version: kernels/spr.py update_spr at
// sync_group = the block size; wrapper: ops/sweeps.py spr_sweep.
//
// For each locus, N sequential node steps: prune the node's edge;
// re-coalesce it by hazard inversion over the sorted boundary grid of
// K = N + M + PP + 2B + 1 times (insertion sort; only the sorted values
// flow downstream), 2 draws per walk trip, at most M + 3 trips; commit the
// new topology and migration events (the where-chain order of _apply_spr);
// refresh the conditionals along the root paths of f and of the old
// grandfather on a proposal copy; MH on the data likelihood (1 draw).
//
// RNG schedule: walk trips are synchronized per block with
// __syncthreads_or(alive), so all loci of a block consume the same draw
// positions; each block keeps its own draw offset, and the wrapper advances
// the shared counter by the largest offset (aux0_out) over blocks.  This
// equals the plain version at sync_group = blockDim.x.
//
// What bounds it on this card: latency of the sequential per-locus walk
// and the uncoalesced conditionals (one thread per locus; a warp's loads
// are N P 4 sizeof(T) bytes apart), with only L / 64 = 16 blocks at
// L = 1000; a block also waits for its slowest walk at every trip.  The
// per-thread grid tables live in local memory.  Warp-per-locus layouts are
// work for later PRs.
#include "sweeps_common.cuh"

template <typename T>
struct Walk {
  T bnd[MAXK];    // sorted boundary grid
  T hz[MAXK];
  T ecum[MAXK];
  T win_hi[MAXM];  // top of migration slot m's window on its branch
  int src_m[MAXM];
  T top[MAXN];
  int K;
};

// lineage count in pop p at time `mid` (pruned branch `skip` excluded) and
// the pop of segment k hit along the ancestors of pop_c
template <typename T>
__device__ T lineages_at(T mid, int p, int skip, const T* age,
                         const int* npop, const int* mbr, const T* mag,
                         const Walk<T>& w, const PopTables<T>& pt, int N,
                         int M) {
  int n = 0;
  for (int v = 0; v < N; ++v) {
    if (v == skip || !(age[v] <= mid && mid < w.top[v])) continue;
    int traj = npop[v];
    for (int m = 0; m < M; ++m)
      if (mbr[m] == v && mag[m] <= mid && mid < w.win_hi[m])
        traj = w.src_m[m];
    n += pt.is_anc(p, traj) ? 1 : 0;
  }
  return (T)n;
}

template <typename T>
__device__ __forceinline__ int hit_pop(T mid, int pop_c,
                                       const PopTables<T>& pt) {
  for (int p = 0; p < pt.PP; ++p)
    if (pt.is_anc(p, pop_c) && pt.tau[p] <= mid && mid < pt.pend[p])
      return p;
  return -1;
}

template <typename T>
__device__ __forceinline__ T mig_into(T mid, int p, const PopTables<T>& pt) {
  T r = (T)0;
  for (int b = 0; b < pt.B; ++b)
    if (pt.bs[b] <= mid && pt.be[b] > mid && pt.btgt[b] == p)
      r += pt.rate[b];
  return r;
}

template <typename T>
__global__ void spr_kernel(const SweepArgs a) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = l < a.L;
  const int lc = live ? l : 0;  // idle threads only join the trip syncs
  const int N = a.N, S = (N + 1) / 2, M = a.M, B = a.B, PP = a.PP, P = a.P;
  const PopTables<T> pt(a);
  const size_t cn = (size_t)N * P * 4;
  const T oldage = (T)a.oldage;

  T age[MAXN], mag[MAXM];
  int lson[MAXN], rson[MAXN], father[MAXN], npop[MAXN], mbr[MAXM],
      mbd[MAXM];
  copy_real(age, (const T*)a.age + (size_t)lc * N, N);
  load_int(lson, (const i64*)a.lson + (size_t)lc * N, N);
  load_int(rson, (const i64*)a.rson + (size_t)lc * N, N);
  load_int(father, (const i64*)a.father + (size_t)lc * N, N);
  load_int(npop, (const i64*)a.node_pop + (size_t)lc * N, N);
  load_int(mbr, (const i64*)a.mig_branch + (size_t)lc * M, M);
  load_int(mbd, (const i64*)a.mig_band + (size_t)lc * M, M);
  copy_real(mag, (const T*)a.mig_age + (size_t)lc * M, M);
  int root = (int)((const i64*)a.root)[lc];
  const T mut = ((const T*)a.mut_rate)[lc];
  const bool real = live && ((const bool*)a.valid)[lc];
  const i64* gid = (const i64*)a.group_id + (size_t)lc * P;
  const T* gcount = (const T*)a.group_count + (size_t)lc * P;
  const T* gnph = (const T*)a.group_nphases + (size_t)lc * P;
  const bool* pvalid = (const bool*)a.pattern_valid + (size_t)lc * P;
  T* gsum = (T*)a.gsum + (size_t)lc * P;
  const uint32_t key = (uint32_t)((const i64*)a.key)[lc];
  const uint32_t ctr0 = (uint32_t)*(const i64*)a.ctr;

  T* cond = (T*)a.cond_out + (size_t)lc * cn;
  T* prop = (T*)a.prop + (size_t)lc * cn;
  if (live) {
    const T* cin = (const T*)a.cond_in + (size_t)lc * cn;
    copy_real(cond, cin, cn);
    copy_real(prop, cin, cn);  // invariant: prop == cond between steps
  }
  T lnld = ((const T*)a.lnld_in)[lc];
  int acc = 0;
  uint32_t doff = 0;
  Walk<T> w;

  for (int i = 0; i < N; ++i) {
    const bool active0 = real && root != i;
    // ---- per-step tables: boundary grid, edge tops, mig windows ----
    int base_migs = 0;
    if (active0) {
      for (int v = 0; v < N; ++v)
        w.top[v] = father[v] < 0 ? oldage : age[father[v]];
      for (int m = 0; m < M; ++m) {
        const bool act = mbr[m] >= 0;
        base_migs += (act && mbr[m] != i) ? 1 : 0;
        w.win_hi[m] = act ? d_min(next_mig_above(m, mbr, mag, M),
                                  w.top[mbr[m]])
                          : (T)0;
        w.src_m[m] = (act && B > 0) ? (int)pt.bsrc[mbd[m]] : 0;
      }
      int K = 0;
      w.bnd[K++] = oldage;
      for (int v = 0; v < N; ++v) w.bnd[K++] = age[v];
      for (int m = 0; m < M; ++m) w.bnd[K++] = mbr[m] >= 0 ? mag[m] : (T)0;
      for (int p = 0; p < PP; ++p) w.bnd[K++] = pt.tau[p];
      for (int b = 0; b < B; ++b) w.bnd[K++] = pt.bs[b];
      for (int b = 0; b < B; ++b) w.bnd[K++] = pt.be[b];
      for (int k = 1; k < K; ++k) {  // insertion sort, ascending
        const T x = w.bnd[k];
        int j = k - 1;
        while (j >= 0 && w.bnd[j] > x) { w.bnd[j + 1] = w.bnd[j]; --j; }
        w.bnd[j + 1] = x;
      }
      w.K = K;
    }

    // ---- the walk: trips synchronized over the block ----
    int status = active0 ? 0 : -2;
    int pop_c = npop[i];
    T age_c = age[i];
    int n_new = 0, target = 0;
    T coal_age = (T)0;
    int new_band[MAXM];
    T new_age[MAXM];
    for (int trips = 0;; ++trips) {
      const int any = __syncthreads_or(status == 0);
      if (!any || trips >= M + 3) break;
      if (status == 0) {
        const int K = w.K;
        // hazard of each segment above age_c along pop_c's ancestors
        for (int k = 0; k < K; ++k) {
          const T lo_b = k == 0 ? (T)0 : w.bnd[k - 1];
          const T lo = d_max(lo_b, age_c), hi = d_max(w.bnd[k], age_c);
          const T seg_len = d_max(hi - lo, (T)0);
          T h = (T)0;
          if (seg_len > (T)0) {
            const T mid = (T)0.5 * (lo_b + w.bnd[k]);
            const int p = hit_pop(mid, pop_c, pt);
            if (p >= 0) {
              const T n = lineages_at(mid, p, i, age, npop, mbr, mag, w, pt,
                                      N, M);
              const T rate = mig_into(mid, p, pt) +
                             (T)2 * n * ((T)1 / pt.theta[p]);
              h = rate * seg_len;
            }
          }
          w.hz[k] = h;
        }
        // log-depth EXCLUSIVE prefix, additions only (the shift-add
        // association of kernels/spr.py; in place, descending)
        w.ecum[0] = (T)0;
        for (int k = 1; k < K; ++k) w.ecum[k] = w.hz[k - 1];
        for (int s = 1; s < K; s *= 2)
          for (int k = K - 1; k >= s; --k) w.ecum[k] += w.ecum[k - s];
        const T u1 = uniform<T>(key, ctr0 + doff + 1);
        const T E = -d_log(d_max(u1, (T)1e-300));
        int kk = -1;
        for (int k = 0; k < K && kk < 0; ++k)
          if (w.ecum[k] + w.hz[k] >= E) kk = k;
        const bool exits = kk < 0;
        if (exits) kk = 0;
        const T lo_b = kk == 0 ? (T)0 : w.bnd[kk - 1];
        const T mid = (T)0.5 * (lo_b + w.bnd[kk]);
        const T lo_k = d_max(lo_b, age_c), hi_k = d_max(w.bnd[kk], age_c);
        const int hp = hit_pop(mid, pop_c, pt);
        const int pop_k = hp < 0 ? 0 : hp;
        T n_k = (T)0, migr_k = (T)0, theta_k = (T)0, rate_k = (T)0;
        if (hp >= 0) {
          n_k = lineages_at(mid, hp, i, age, npop, mbr, mag, w, pt, N, M);
          migr_k = mig_into(mid, hp, pt);
          theta_k = pt.theta[hp];
          rate_k = migr_k + (T)2 * n_k * ((T)1 / pt.theta[hp]);
        }
        T t_event = lo_k + (E - w.ecum[kk]) / d_max(rate_k, (T)1e-300);
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
          src_pop = (int)pt.bsrc[chosen];
        }
        const bool do_mig = is_mig && !over_cap;
        if (do_mig) {
          const int slot = n_new < 0 ? 0 : (n_new > M - 1 ? M - 1 : n_new);
          new_band[slot] = chosen;
          new_age[slot] = t_event;
          ++n_new;
        }
        // coalescence: the i_pick-th covering branch in node-id order
        const bool is_coal = ev && !is_mig;
        long long i_pick = (long long)d_floor((esample - migr_k) * theta_k /
                                              (T)2);
        const long long nmax = (long long)n_k - 1;
        i_pick = i_pick < 0 ? 0 : i_pick;
        i_pick = i_pick > (nmax < 0 ? 0 : nmax) ? (nmax < 0 ? 0 : nmax)
                                                : i_pick;
        int tgt = 0;
        long long csum = 0;
        for (int v = 0; v < N; ++v) {
          if (v == i || !(age[v] <= t_event && t_event < w.top[v])) continue;
          // trajectory pop: source of the last migration below t_event
          int traj = npop[v];
          T best = -d_inf<T>();
          for (int m = 0; m < M; ++m)
            if (mbr[m] == v && mag[m] < t_event && mag[m] > best) {
              best = mag[m];
              traj = (int)pt.bsrc[mbd[m]];
            }
          if (!pt.is_anc(pop_k, traj)) continue;
          if (++csum > i_pick) { tgt = v; break; }
        }
        const bool coal_ok = is_coal && n_k > (T)0;
        if (exits) status = -1;
        if (over_cap) status = -1;
        if (coal_ok) status = 1;
        if (is_coal && n_k <= (T)0) status = -1;
        if (do_mig) { pop_c = src_pop; age_c = t_event; }
        if (coal_ok) { pop_c = pop_k; target = tgt; coal_age = t_event; }
      }
      doff += 2;
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
      T age_p[MAXN], mag_p[MAXM];
      int fa_p[MAXN], ls_p[MAXN], rs_p[MAXN], pop_p[MAXN], mbr_p[MAXM],
          mbd_p[MAXM];
      for (int v = 0; v < N; ++v) {
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
      int nfree = 0;
      for (int m = 0; m < M; ++m) {
        const bool act = mbr[m] >= 0;
        const bool keep = act && !(ok && mbr[m] == i);
        int mb2 = (ok && mbr[m] == f) ? sib : mbr[m];
        if (ok && mb2 == t_eff && mag[m] >= coal_age) mb2 = f;
        mbr_p[m] = keep ? mb2 : -1;
        mbd_p[m] = keep ? mbd[m] : 0;
        mag_p[m] = keep ? mag[m] : (T)0;
        if (mbr_p[m] < 0) {  // the j-th free slot takes the j-th new event
          const int r = nfree++;
          if (ok && r < n_new) {
            mbr_p[m] = i;
            mbd_p[m] = new_band[r];
            mag_p[m] = new_age[r];
          }
        }
      }
      // data delta: refresh the root paths of f and of g (new topology)
      uint64_t dirty = refresh_path(prop, f, ls_p, rs_p, fa_p, age_p, mut, N,
                                    S, P);
      if (g >= 0)
        dirty |= refresh_path(prop, g, ls_p, rs_p, fa_p, age_p, mut, N, S, P);
      const T lnld_new = root_lnld(prop, root_p, gid, gcount, gnph, pvalid,
                                   gsum, S, P);
      const T u = uniform<T>(key, ctr0 + doff + 1);
      const bool accept = ok && mh(lnld_new - lnld, u);
      if (accept) {
        for (int v = 0; v < N; ++v) {
          age[v] = age_p[v]; npop[v] = pop_p[v]; father[v] = fa_p[v];
          lson[v] = ls_p[v]; rson[v] = rs_p[v];
        }
        for (int m = 0; m < M; ++m) {
          mbr[m] = mbr_p[m]; mbd[m] = mbd_p[m]; mag[m] = mag_p[m];
        }
        root = root_p;
        copy_rows(cond, prop, dirty, P);
        lnld = lnld_new;
        ++acc;
      } else {
        copy_rows(prop, cond, dirty, P);
      }
    }
    doff += 1;
  }
  if (!live) return;
  copy_real((T*)a.age_out + (size_t)l * N, age, N);
  i64* o;
  o = (i64*)a.lson_out + (size_t)l * N;
  for (int v = 0; v < N; ++v) o[v] = lson[v];
  o = (i64*)a.rson_out + (size_t)l * N;
  for (int v = 0; v < N; ++v) o[v] = rson[v];
  o = (i64*)a.father_out + (size_t)l * N;
  for (int v = 0; v < N; ++v) o[v] = father[v];
  o = (i64*)a.node_pop_out + (size_t)l * N;
  for (int v = 0; v < N; ++v) o[v] = npop[v];
  ((i64*)a.root_out)[l] = root;
  o = (i64*)a.mig_branch_out + (size_t)l * M;
  for (int m = 0; m < M; ++m) o[m] = mbr[m];
  o = (i64*)a.mig_band_out + (size_t)l * M;
  for (int m = 0; m < M; ++m) o[m] = mbd[m];
  copy_real((T*)a.mig_age_out + (size_t)l * M, mag, M);
  ((T*)a.lnld_out)[l] = lnld;
  ((int*)a.acc_out)[l] = acc;
  ((int*)a.aux0_out)[l] = (int)doff;
}

SWEEP_ENTRY(spr, spr_kernel)
