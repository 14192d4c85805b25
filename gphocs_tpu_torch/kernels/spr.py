"""UpdateGB_MigSPR: subtree-prune-regraft with migration, all loci batched
(twin of gphocs_tpu/kernels/spr.py).

This is the plain PyTorch version of the SPR kernel (csrc/spr.cu), and
the sweep itself with the Wichmann-Hill streams of the conformance mode
(ops/sweeps.spr_sweep_plain).

For each node (sequential sweep, loci parallel):
  1. Detach the edge above `node`; the pruned branch is excluded from
     lineage counts.
  2. Re-coalesce by cumulative-hazard inversion along the ancestral
     population path: every walk trip draws E ~ Exp(1) and u, finds the
     segment of the sorted boundary grid where the hazard reaches E, and
     either migrates (jump to the band's source pop, recording an event)
     or coalesces with the i-th covering branch.  A lane is rejected when
     migration capacity is exhausted or the walk passes OLDAGE.
  3. lnacceptance = data-likelihood delta only (reference
     src/GPhoCS.c:2702-2714).
  4. On accept, rewire topology and migration events (_apply_spr).

Admixture (reference src/GPhoCS.c:2670-2696): where the run has admixed
leaves, every node step first takes one uniform u per locus, whatever the
node (gphocs_tpu's fast rndu consumes it unmasked; a Wichmann-Hill stream
draws it only on an admixed leaf's step, where the leaf is not the
root).  On an admixed leaf
that is not the root, the leaf's population becomes its second one where
u < c (its chain's coefficient), else its first; the walk starts from
that population, an accepted move keeps it, and a rejected one restores
the old population.

RNG schedule (`sync_group`, the repo's deviation 9): loci are split into
consecutive groups of `sync_group` lanes.  Walk trips of a group run while
any lane of the group is still walking, at most M+3 trips; each trip
consumes 2 draws for every lane of the group, and the MH uniform 1 more.
Each group keeps its own draw offset, and the shared counter advances by
the largest offset over groups.  For C chains (chain-major loci, [C, P]
parameters, a counter per chain) the groups lie within a chain, cut from
its loci, and each chain's counter advances by the largest offset over its
own groups.  sync_group = L is gphocs_tpu's XLA
update_spr draw for draw; sync_group = g is spr_sweep_pallas(tile=g);
sync_group = 1, every locus walking on its own, is the CUDA kernel
(csrc/spr.cu, a warp per locus).  Padding loci (gen.valid False) do not
walk, as in the Pallas kernel.

Wichmann-Hill streams (the conformance mode, gphocs_tpu's XLA update_spr
draw for draw): no offsets; each trip draws u on the loci still walking
and the second uniform on those with an event, the MH uniform where the
walk coalesced and lnacc < 0.  A locus consumes only its own stream, so
the trip groups do not change the draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.kernels.common import (Context, band_windows,
                                             chain_count, draw_accept,
                                             maybe_pmax, mh_accept,
                                             per_chain, rows, take)
from gphocs_tpu_torch.ops.likelihood_cache import refresh_and_lnld
from gphocs_tpu_torch.state import GenState, Params, SeqData

INF = float("inf")


def _edge_top(gen: GenState, ctx: Context):
    fa = gen.father
    return torch.where(fa < 0, torch.full_like(gen.age, ctx.oldage),
                       torch.gather(gen.age, 1, fa.clamp(min=0)))


def _branch_pop_at(gen: GenState, ctx: Context, t: torch.Tensor):
    """[L, N] base population of every branch's trajectory at per-locus
    time t: source pop of the last migration event below t on the branch,
    or node_pop if none (reference getEdgesForTimePop, src/patch.c:526)."""
    N = gen.num_nodes
    if ctx.num_bands == 0:
        return gen.node_pop
    below = (gen.mig_branch >= 0) & (gen.mig_age < t[:, None])     # [L, M]
    onb = gen.mig_branch[:, None, :] == torch.arange(
        N, device=t.device)[None, :, None]                         # [L, N, M]
    keyed = torch.where(onb & below[:, None, :], gen.mig_age[:, None, :],
                        torch.full_like(onb, -INF, dtype=t.dtype))
    best = torch.argmax(keyed, dim=2)                               # [L, N]
    has = (keyed > -INF).any(dim=2)
    band = torch.gather(gen.mig_band, 1, best)
    return torch.where(has, ctx.band_source[band], gen.node_pop)


class SimResult(NamedTuple):
    pop: torch.Tensor        # [L] population of the coalescence
    status: torch.Tensor     # [L] 1 coalesced, -1 rejected, -2 inactive
    n_new: torch.Tensor      # [L] number of new migration events
    new_band: torch.Tensor   # [L, M] band of new events
    new_age: torch.Tensor    # [L, M] age of new events
    target: torch.Tensor     # [L] coalescence target branch
    coal_age: torch.Tensor   # [L]
    doff: torch.Tensor       # [L] draw offset after the walk
    rng: object              # the streams after the walk (fast: as given)


def _simulate_reconnect(gen: GenState, params: Params, ctx: Context,
                        node: int, rng, doff: torch.Tensor,
                        active0: torch.Tensor, sync_group: int,
                        loci_axis=None) -> SimResult:
    """Batched traceLineage(reconnect=1) by cumulative-hazard inversion
    (see gphocs_tpu/kernels/spr._simulate_reconnect).  Fast streams: the
    draws of lane l sit at counter positions rng.ctr + doff[l] + 1, + 2
    per trip.  Wichmann-Hill streams: drawn in sequence, on the lanes
    still walking and on those with an event."""
    fast = isinstance(rng, RF.FastRngState)
    L, N = gen.father.shape
    M = gen.max_migs
    Bn = ctx.num_bands
    P = ctx.num_pops
    dt = gen.age.dtype
    dev = gen.age.device
    ar = torch.arange(L, device=dev)
    nid = torch.arange(N, device=dev)
    anc = ctx.is_ancestral
    anc_f = anc.to(dt)

    bs, be = band_windows(ctx, params.tau)
    pe = torch.where(ctx.father_pop < 0, torch.full_like(params.tau,
                                                         ctx.oldage),
                     params.tau[..., ctx.father_pop.clamp(min=0)])
    # each locus's chain's tables, [1 | L, ...]
    tau_l, theta_l, rate_l = (rows(params.tau, L), rows(params.theta, L),
                              rows(params.mig_rate, L))
    bs_l, be_l, pe_l = rows(bs, L), rows(be, L), rows(pe, L)
    act = gen.mig_branch >= 0
    on_pruned = act & (gen.mig_branch == node)
    base_migs = act.sum(dim=1) - on_pruned.sum(dim=1)
    start_pop = gen.node_pop[:, node]
    start_age = gen.age[:, node]

    # static boundary grid [L, K]: node ages, migration events, population
    # bottoms, band window edges and the OLDAGE ceiling
    cand = [torch.full((L, 1), ctx.oldage, dtype=dt, device=dev), gen.age,
            torch.where(act, gen.mig_age, torch.zeros_like(gen.mig_age)),
            tau_l.expand(L, P)]
    if Bn > 0:
        cand += [bs_l.expand(L, Bn), be_l.expand(L, Bn)]
    b_sorted = torch.sort(torch.cat(cand, dim=1), dim=1).values    # [L, K]
    K = b_sorted.shape[1]
    lo_base = torch.cat([torch.zeros((L, 1), dtype=dt, device=dev),
                         b_sorted[:, :-1]], dim=1)
    mids = 0.5 * (lo_base + b_sorted)
    top_all = _edge_top(gen, ctx)                                  # [L, N]

    # lineage counts per (segment, base pop), pruned branch excluded
    alive0 = ((gen.age[:, None, :] <= mids[:, :, None])
              & (mids[:, :, None] < top_all[:, None, :])
              & (nid != node)[None, None, :])                      # [L,K,N]
    pid = torch.arange(P, device=dev)
    n_by_base = (alive0[:, :, :, None]
                 & (gen.node_pop[:, None, :, None] == pid)).sum(dim=2).to(dt)
    if Bn > 0:
        # slot m's window [age_m, next mig above on its branch or branch
        # top) replaces the branch's node pop by the band's source pop
        mig_age_act = torch.where(act, gen.mig_age,
                                  torch.full_like(gen.mig_age, INF))
        same = (act[:, :, None] & act[:, None, :]
                & (gen.mig_branch[:, :, None] == gen.mig_branch[:, None, :]))
        idxm = torch.arange(M, device=dev)
        above = same & ((mig_age_act[:, None, :] > mig_age_act[:, :, None])
                        | ((mig_age_act[:, None, :] == mig_age_act[:, :, None])
                           & (idxm[None, None, :] > idxm[None, :, None])))
        next_age = torch.where(above, mig_age_act[:, None, :],
                               torch.full_like(above, INF, dtype=dt)
                               ).min(dim=2).values
        branch = gen.mig_branch.clamp(min=0)
        win_hi = torch.minimum(next_age, torch.gather(top_all, 1, branch))
        src_pop_m = ctx.band_source[torch.where(act, gen.mig_band, 0)]
        branch_pop_m = torch.gather(gen.node_pop, 1, branch)
        in_win = (act[:, None, :]
                  & (gen.mig_age[:, None, :] <= mids[:, :, None])
                  & (mids[:, :, None] < win_hi[:, None, :]))       # [L,K,M]
        branch_alive = torch.gather(alive0, 2,
                                    branch[:, None, :].expand(L, K, M))
        w = (in_win & branch_alive)[:, :, :, None]
        n_by_base = n_by_base + (
            (w & (src_pop_m[:, None, :, None] == pid)).sum(dim=2)
            - (w & (branch_pop_m[:, None, :, None] == pid)).sum(dim=2)
        ).to(dt)
    # n_all[l,k,p] = sum_q anc[p,q] n_by_base[l,k,q] (exact small counts)
    n_all = (n_by_base[:, :, None, :] * anc_f[None, None]).sum(dim=3)
    inwin0 = ((tau_l[:, None, :] <= mids[:, :, None])
              & (mids[:, :, None] < pe_l[:, None, :]))             # [L,K,P]
    if Bn > 0:
        live0 = ((bs_l[:, None, :] <= mids[:, :, None])
                 & (be_l[:, None, :] > mids[:, :, None]))          # [L,K,B]
        tgt_onehot = (ctx.band_target[None, :] == pid[:, None]).to(dt)
        rates_live = torch.where(live0, rate_l[:, None, :],
                                 torch.zeros_like(live0, dtype=dt))
        migr_all = (rates_live[:, :, None, :]
                    * tgt_onehot[None, None]).sum(dim=3)           # [L,K,P]
    else:
        migr_all = torch.zeros_like(n_all)
    inv_theta = (1.0 / theta_l)[:, None, :]

    # walk state
    pop_c = start_pop.clone()
    age_c = start_age.clone()
    status = torch.where(active0, 0, -2)
    n_new = torch.zeros((L,), dtype=torch.int64, device=dev)
    new_band = torch.zeros((L, M), dtype=torch.int64, device=dev)
    new_age = torch.zeros((L, M), dtype=dt, device=dev)
    target = torch.zeros((L,), dtype=torch.int64, device=dev)
    coal_age = torch.zeros((L,), dtype=dt, device=dev)
    # trip groups of G consecutive loci, cut from each chain's Lc loci
    Cn = chain_count(params) or 1
    Lc = L // Cn
    G = max(1, min(sync_group, Lc))
    gpc = -(-Lc // G)                                   # groups per chain
    ngroups = Cn * gpc
    grp_of = (ar // Lc) * gpc + (ar % Lc) // G
    trips = torch.zeros((ngroups,), dtype=torch.int64, device=dev)

    while True:
        alive_all = status == 0
        padded = torch.zeros((Cn, gpc * G), dtype=torch.bool, device=dev)
        padded[:, :Lc] = alive_all.view(Cn, Lc)
        # a group that spans the ranks of a loci mesh walks while any
        # rank's part of it walks: every rank takes the same trips
        g_alive = maybe_pmax(padded.view(ngroups, G).any(dim=1), loci_axis)
        run_g = g_alive & (trips < M + 3)
        if not bool(run_g.any()):
            break
        run = run_g[grp_of]
        alive = alive_all & run

        lo = torch.maximum(lo_base, age_c[:, None])
        hi = torch.maximum(b_sorted, age_c[:, None])
        seg_len = torch.clamp(hi - lo, min=0.0)
        onpath = anc[:, pop_c].T                                   # [L, P]
        hit = onpath[:, None, :] & inwin0                          # [L,K,P]
        hit_f = hit.to(dt)
        n = (hit_f * n_all).sum(dim=2)
        mig_rate = (hit_f * migr_all).sum(dim=2)
        ith = (hit_f * inv_theta).sum(dim=2)
        onany = hit.any(dim=2)
        rate = torch.where(onany, mig_rate + 2.0 * n * ith,
                           torch.zeros_like(n))
        hz = rate * seg_len
        # log-depth EXCLUSIVE prefix, additions only (the shift-add
        # association of gphocs_tpu; cum_k - hz_k would cancel
        # catastrophically on the [root age, OLDAGE] segment at f32)
        ecum = torch.cat([torch.zeros((L, 1), dtype=dt, device=dev),
                          hz[:, :-1]], dim=1)
        s_ = 1
        while s_ < K:
            ecum = ecum + torch.cat(
                [torch.zeros((L, s_), dtype=dt, device=dev),
                 ecum[:, :-s_]], dim=1)
            s_ *= 2
        cum = ecum + hz
        if fast:
            u1 = RF.raw_u(rng, doff + 1, dt)
        else:
            u1, rng = R.rndu(rng, alive, dt)
        E = -torch.log(torch.clamp(u1, min=1e-300))
        reached = cum >= E[:, None]
        k = torch.argmax(reached.to(torch.int8), dim=1)
        exits = ~reached.any(dim=1)
        kk = k[:, None]
        prev_cum = torch.gather(ecum, 1, kk)[:, 0]
        rate_k = torch.gather(rate, 1, kk)[:, 0]
        lo_k = torch.gather(lo, 1, kk)[:, 0]
        hi_k = torch.gather(hi, 1, kk)[:, 0]
        t_event = lo_k + (E - prev_cum) / torch.clamp(rate_k, min=1e-300)
        t_event = torch.minimum(torch.maximum(t_event, lo_k), hi_k)
        hit_k = hit[ar, k]                                         # [L, P]
        pop_k = torch.argmax(hit_k.to(torch.int8), dim=1)
        theta_k = torch.where(hit_k.any(dim=1), take(params.theta, pop_k),
                              torch.zeros_like(t_event))
        migr_k = torch.gather(mig_rate, 1, kk)[:, 0]
        n_k = torch.gather(n, 1, kk)[:, 0]

        ev_mask = alive & ~exits
        if fast:
            u2 = RF.raw_u(rng, doff + 2, dt)
        else:
            u2, rng = R.rndu(rng, ev_mask, dt)
        esample = u2 * rate_k
        is_mig = ev_mask & (esample < migr_k) & (Bn > 0)
        over_cap = is_mig & (base_migs + n_new + 1 > M)
        if Bn > 0:
            live_k = ((ctx.band_target[None, :] == pop_k[:, None])
                      & (bs_l <= t_event[:, None])
                      & (be_l > t_event[:, None]))                 # [L, B]
            cumb = torch.cumsum(torch.where(
                live_k, rate_l, torch.zeros_like(live_k, dtype=dt)), dim=1)
            chosen = torch.argmax(((cumb > esample[:, None]) & live_k
                                   ).to(torch.int8), dim=1)
            src_pop = ctx.band_source[chosen]
        else:
            chosen = torch.zeros_like(pop_c)
            src_pop = pop_c
        do_mig = is_mig & ~over_cap
        put = do_mig[:, None] & (torch.arange(M, device=dev)[None, :]
                                 == n_new.clamp(0, M - 1)[:, None])
        new_band = torch.where(put, chosen[:, None], new_band)
        new_age = torch.where(put, t_event[:, None], new_age)
        n_new = n_new + do_mig.to(torch.int64)

        # coalescence: i-th covering branch (node-id order) at t_event
        is_coal = ev_mask & ~is_mig
        i_pick = torch.floor((esample - migr_k) * theta_k / 2.0
                             ).to(torch.int64)
        i_pick = torch.minimum(i_pick.clamp(min=0),
                               (n_k.to(torch.int64) - 1).clamp(min=0))
        alive_b = ((gen.age <= t_event[:, None])
                   & (t_event[:, None] < top_all) & (nid != node)[None, :])
        traj = _branch_pop_at(gen, ctx, t_event)
        cov = alive_b & anc[pop_k[:, None], traj]                   # [L, N]
        csum = torch.cumsum(cov.to(torch.int64), dim=1)
        tgt = torch.argmax((csum > i_pick[:, None]).to(torch.int8), dim=1)
        coal_ok = is_coal & (n_k > 0)

        status = torch.where(alive & exits, -1, status)
        status = torch.where(over_cap, -1, status)
        status = torch.where(coal_ok, 1, status)
        status = torch.where(is_coal & (n_k <= 0), -1, status)
        pop_c = torch.where(do_mig, src_pop, pop_c)
        pop_c = torch.where(coal_ok, pop_k, pop_c)
        age_c = torch.where(do_mig, t_event, age_c)
        target = torch.where(coal_ok, tgt, target)
        coal_age = torch.where(coal_ok, t_event, coal_age)
        doff = torch.where(run, doff + 2, doff)
        trips = trips + run_g.to(torch.int64)

    status = torch.where(status == 0, -1, status)
    return SimResult(pop=pop_c, status=status, n_new=n_new,
                     new_band=new_band, new_age=new_age, target=target,
                     coal_age=coal_age, doff=doff, rng=rng)


def _apply_spr(gen: GenState, node: int, accept: torch.Tensor,
               sim: SimResult) -> GenState:
    """Rewire topology + migration events for accepted lanes, replaying
    the sequential update order of the reference's SPR commit
    (src/GPhoCS.c:2716-2830, replaceMigNodes patch.c:1343-1430)."""
    L, N = gen.father.shape
    M = gen.max_migs
    dev = gen.age.device
    ar = torch.arange(L, device=dev)
    f = gen.father[:, node]
    f_safe = f.clamp(min=0)
    sib = gen.lson[ar, f_safe] + gen.rson[ar, f_safe] - node
    g = gen.father[ar, f_safe]
    target = sim.target
    t_new = sim.coal_age
    tgt_fa = gen.father[ar, target]
    topo_change = accept & (target != sib) & (target != f)

    nid = torch.arange(N, device=dev)[None, :]
    is_f = nid == f[:, None]
    is_sib = nid == sib[:, None]
    is_g = (nid == g[:, None]) & (g >= 0)[:, None]
    is_tgt = nid == target[:, None]
    is_tf = (nid == tgt_fa[:, None]) & (tgt_fa >= 0)[:, None]
    tc = topo_change[:, None]
    acc2 = accept[:, None]

    age = torch.where(acc2 & is_f, t_new[:, None], gen.age)
    node_pop = torch.where(acc2 & is_f, sim.pop[:, None], gen.node_pop)
    father = gen.father
    father = torch.where(tc & is_sib, g[:, None], father)
    father = torch.where(tc & is_f, tgt_fa[:, None], father)
    father = torch.where(tc & is_tgt, f[:, None], father)
    lson = torch.where(tc & is_g & (gen.lson == f[:, None]), sib[:, None],
                       gen.lson)
    lson1 = torch.where(tc & is_f, torch.full_like(lson, node), lson)
    # if tgt_fa == g the g-rule may already have replaced f with sib there,
    # so the target-slot test runs against the post-g-rule values
    lson = torch.where(tc & is_tf & (lson1 == target[:, None]), f[:, None],
                       lson1)
    rson = torch.where(tc & is_g & (gen.rson == f[:, None]), sib[:, None],
                       gen.rson)
    rson1 = torch.where(tc & is_f, target[:, None], rson)
    rson = torch.where(tc & is_tf & (rson1 == target[:, None]), f[:, None],
                       rson1)
    root = torch.where(topo_change & (tgt_fa < 0), f,
                       torch.where(topo_change & (g < 0), sib, gen.root))

    act = gen.mig_branch >= 0
    mb = gen.mig_branch
    keep = act & ~(acc2 & (mb == node))
    mb2 = torch.where(acc2 & (mb == f[:, None]), sib[:, None], mb)
    t_eff = torch.where(target == f, sib, target)
    mb2 = torch.where(acc2 & (mb2 == t_eff[:, None])
                      & (gen.mig_age >= t_new[:, None]), f[:, None], mb2)
    mig_branch = torch.where(keep, mb2, -1)
    mig_band = torch.where(keep, gen.mig_band, 0)
    mig_age = torch.where(keep, gen.mig_age, torch.zeros_like(gen.mig_age))
    # the j-th free slot receives the j-th new event
    free = mig_branch < 0
    rank = torch.cumsum(free.to(torch.int64), dim=1) - 1
    recv = acc2 & free & (rank < sim.n_new[:, None])
    rank_safe = rank.clamp(0, M - 1)
    mig_branch = torch.where(recv, torch.full_like(mig_branch, node),
                             mig_branch)
    mig_band = torch.where(recv, torch.gather(sim.new_band, 1, rank_safe),
                           mig_band)
    mig_age = torch.where(recv, torch.gather(sim.new_age, 1, rank_safe),
                          mig_age)
    return gen._replace(father=father, lson=lson, rson=rson, age=age,
                        node_pop=node_pop, root=root, mig_branch=mig_branch,
                        mig_band=mig_band, mig_age=mig_age)


def update_spr(gen: GenState, params: Params, seq: SeqData,
               rng, ctx: Context, lnld: torch.Tensor,
               cond: torch.Tensor, sync_group: int = 0, loci_axis=None):
    """One full SPR sweep over all nodes.  Returns
    (gen, rng, lnld, cond, accepted_count); the genealogy log-prior must
    be recomputed by the caller.  sync_group = 0 means L (global trip
    synchronization; a chain's loci for C chains, whose counts are
    [C]).  loci_axis: the loci mesh of the rank, whose block of each
    chain (L loci, or C chains' L / C each) is one trip group per chain
    spanning all ranks (sync_group L): each group's liveness ([C]) and
    each chain's counter advance are reduced over the ranks, so the
    sharded sweep equals the unsharded one draw for draw.  The accept
    count stays the rank's own."""
    L, N = gen.father.shape
    dt = gen.age.dtype
    dev = gen.age.device
    ar = torch.arange(L, device=dev)
    nid = torch.arange(N, device=dev)[None, :]
    G = sync_group or L
    C = chain_count(params)
    if loci_axis is not None and G < L // (C or 1):
        raise ValueError("a loci mesh takes one trip group per chain")
    doff = torch.zeros((L,), dtype=torch.int64, device=dev)
    acc = torch.zeros(params.theta.shape[:-1], dtype=torch.int64,
                      device=dev)
    fast = isinstance(rng, RF.FastRngState)

    leaves = ctx.admix_slot.tolist()
    pairs = ctx.admix_pops.tolist()
    for inode in range(N):
        active0 = (gen.root != inode) & gen.valid
        gen_sim = gen
        if leaves and fast:
            u_adm = RF.raw_u(rng, doff + 1, dt)
            doff = doff + 1
        elif inode in leaves:
            u_adm, rng = R.rndu(rng, gen.root != inode, dt)
        if inode in leaves:
            a = leaves.index(inode)
            first, second = pairs[a]
            coeff = rows(params.admix_coeff, L)[:, a]
            old = gen.node_pop[:, inode]
            new_pop = torch.where(u_adm < coeff, second, first)
            node_pop = gen.node_pop.clone()
            node_pop[:, inode] = torch.where(gen.root != inode, new_pop, old)
            gen_sim = gen._replace(node_pop=node_pop)
        sim = _simulate_reconnect(gen_sim, params, ctx, inode, rng, doff,
                                  active0, G, loci_axis)
        ok = sim.status == 1
        rng = sim.rng
        gen_prop = _apply_spr(gen_sim, inode, ok, sim)
        # dirty: f (new age/sons), the old grandfather (lost son f) and the
        # target's old father (gained son f), plus their ancestors
        f = gen.father[:, inode]
        g = gen.father[ar, f.clamp(min=0)]
        tgt_fa = gen.father[ar, sim.target]
        dirty0 = (((nid == f[:, None]) & (f >= 0)[:, None])
                  | ((nid == g[:, None]) & (g >= 0)[:, None])
                  | ((nid == tgt_fa[:, None]) & (tgt_fa >= 0)[:, None]
                     & ok[:, None]))
        cond_prop, lnld_prop = refresh_and_lnld(cond, gen_prop, seq, dirty0)
        if fast:
            u = RF.raw_u(rng, sim.doff + 1, dt)
            doff = sim.doff + 1
            accept = mh_accept(u, lnld_prop - lnld, ok & gen.valid)
        else:
            accept, _, rng = draw_accept(rng, lnld_prop - lnld,
                                         ok & gen.valid)
        a2 = accept[:, None]
        gen = GenState(*(torch.where(a2 if o.dim() == 2 else accept, n_, o)
                         for n_, o in zip(gen_prop, gen)))
        cond = torch.where(accept[:, None, None, None], cond_prop, cond)
        lnld = torch.where(accept, lnld_prop, lnld)
        acc = acc + per_chain(accept, C)
    if fast:
        rng = RF.bump(rng, maybe_pmax(per_chain(doff, C, "amax"),
                                      loci_axis))
    return gen, rng, lnld, cond, acc
