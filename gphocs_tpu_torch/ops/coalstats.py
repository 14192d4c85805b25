"""Coalescent/migration sufficient statistics, batched over loci
(twin of gphocs_tpu/ops/coalstats.py; see its docstring for the segment
formulation).

Every genealogy edge is split into segments that each live in one base
population: the part of edge v below its first migration event (base pop
= node_pop[v]), plus one segment per migration event (base pop = the
band's source).  A lineage with base pop q is present in pop r at time t
iff r is ancestral-or-equal to q and t lies in r's window, so

    coal_stats[r] = sum_{s != s'} |clip_r(s) ^ clip_r(s')|
    mig_stats[b]  = sum_s |clip_tgt(b)(s) ^ band_window(b)|
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gphocs_tpu_torch.constants import OLDAGE
from gphocs_tpu_torch.state import GenState, Params

INF = float("inf")


class Segments(NamedTuple):
    start: torch.Tensor     # [L, NSEG]
    end: torch.Tensor       # [L, NSEG]
    base_pop: torch.Tensor  # [L, NSEG] int64
    valid: torch.Tensor     # [L, NSEG] bool


class CoalStats(NamedTuple):
    coal_stats: torch.Tensor  # [L, P] sum n(n-1) dt per pop
    mig_stats: torch.Tensor   # [L, B] sum n dt per band window
    num_coals: torch.Tensor   # [L, P] int64
    num_migs: torch.Tensor    # [L, B] int64


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def segments(gen: GenState, band_source: torch.Tensor,
             oldage: float = OLDAGE, root_cap: torch.Tensor = None
             ) -> Segments:
    """Build the segment set.  root_cap: optional [L] ceiling for the
    root's virtual edge instead of OLDAGE (exact for any cap above every
    other segment end and band-window end; needed at f32, see
    gphocs_tpu/ops/coalstats.segments)."""
    L, N = gen.father.shape
    M = gen.max_migs
    dt = gen.age.dtype
    fa = gen.father
    top_root = (torch.full((L, 1), oldage, dtype=dt, device=fa.device)
                if root_cap is None else root_cap[:, None].to(dt))
    edge_top = torch.where(fa < 0, top_root, _take(gen.age, fa.clamp(min=0)))

    mig_active = gen.mig_branch >= 0
    mig_age = torch.where(mig_active, gen.mig_age,
                          torch.full_like(gen.mig_age, INF))
    nid = torch.arange(N, device=fa.device)
    on_edge = mig_active[:, None, :] & (gen.mig_branch[:, None, :]
                                        == nid[None, :, None])
    first_mig = torch.where(on_edge, mig_age[:, None, :],
                            torch.full_like(mig_age[:, None, :], INF)
                            ).min(dim=2).values                      # [L, N]
    edge_seg_end = torch.minimum(edge_top, first_mig)

    # next mig above each mig on the same branch (ties broken by slot id)
    same_branch = (mig_active[:, :, None] & mig_active[:, None, :]
                   & (gen.mig_branch[:, :, None] == gen.mig_branch[:, None, :]))
    age_i = mig_age[:, :, None]
    age_j = mig_age[:, None, :]
    idx = torch.arange(M, device=fa.device)
    later = same_branch & ((age_j > age_i)
                           | ((age_j == age_i)
                              & (idx[None, None, :] > idx[None, :, None])))
    next_mig = torch.where(later, age_j, torch.full_like(age_j, INF)
                           ).min(dim=2).values                       # [L, M]
    branch_top = _take(edge_top, torch.where(mig_active, gen.mig_branch, 0))
    mig_seg_end = torch.minimum(next_mig, branch_top)

    zero = torch.zeros_like(gen.mig_age)
    start = torch.cat([gen.age, torch.where(mig_active, gen.mig_age, zero)],
                      dim=1)
    end = torch.cat([edge_seg_end,
                     torch.where(mig_active, mig_seg_end, zero)], dim=1)
    band_safe = torch.where(mig_active, gen.mig_band, 0)
    if band_source.shape[0] > 0:
        mig_pop = band_source[band_safe]
    else:  # no bands: no active migration events can exist
        mig_pop = torch.zeros_like(band_safe)
    base_pop = torch.cat([gen.node_pop, mig_pop], dim=1)
    valid = torch.cat([torch.ones((L, N), dtype=torch.bool,
                                  device=fa.device), mig_active], dim=1)
    return Segments(start=start, end=end, base_pop=base_pop, valid=valid)


def _pop_end(father_pop, tau, oldage):
    return torch.where(father_pop < 0, torch.full_like(tau, oldage),
                       tau[father_pop.clamp(min=0)])


def sufficient_stats(gen: GenState, params: Params,
                     father_pop: torch.Tensor, is_ancestral: torch.Tensor,
                     band_source: torch.Tensor, band_target: torch.Tensor,
                     band_start: torch.Tensor, band_end: torch.Tensor,
                     oldage: float = OLDAGE) -> CoalStats:
    """Full recomputation of all sufficient statistics (pairwise-overlap
    form, with the tight root-edge cap of gphocs_tpu)."""
    P = params.theta.shape[0]
    S = gen.num_samples
    cap = gen.age.max(dim=1).values
    if params.tau.shape[0]:
        cap = torch.maximum(cap, params.tau.max())
    if band_end.shape[0] > 0:
        cap = torch.maximum(cap, band_end.max())
    segs = segments(gen, band_source, oldage, root_cap=cap)
    pend = _pop_end(father_pop, params.tau, oldage)

    lo = torch.maximum(segs.start[:, None, :], params.tau[None, :, None])
    hi = torch.minimum(segs.end[:, None, :], pend[None, :, None])
    # anc[r, base[l, s]]: is r ancestral-or-equal to the segment's base pop
    anc_of_base = is_ancestral[:, segs.base_pop].permute(1, 0, 2)  # [L,P,NS]
    present = segs.valid[:, None, :] & anc_of_base & (hi > lo)
    zero = torch.zeros_like(lo)
    lo_m = torch.where(present, lo, zero)
    hi_m = torch.where(present, hi, zero)
    pair = torch.clamp(
        torch.minimum(hi_m[:, :, :, None], hi_m[:, :, None, :])
        - torch.maximum(lo_m[:, :, :, None], lo_m[:, :, None, :]), min=0.0)
    pair = pair * (present[:, :, :, None] & present[:, :, None, :])
    length = torch.clamp(hi_m - lo_m, min=0.0)
    coal = pair.sum(dim=(2, 3)) - length.sum(dim=2)

    B = band_source.shape[0]
    if B > 0:
        lo_t = torch.maximum(lo[:, band_target, :], band_start[None, :, None])
        hi_t = torch.minimum(hi[:, band_target, :], band_end[None, :, None])
        pres_t = present[:, band_target, :] & (hi_t > lo_t)
        mig = torch.where(pres_t, torch.clamp(hi_t - lo_t, min=0.0),
                          torch.zeros_like(lo_t)).sum(dim=2)
        bid = torch.arange(B, device=lo.device)
        nmig = ((gen.mig_branch >= 0)[:, None, :]
                & (gen.mig_band[:, None, :] == bid[None, :, None])).sum(dim=2)
    else:
        mig = gen.age.new_zeros((gen.num_loci, 0))
        nmig = torch.zeros((gen.num_loci, 0), dtype=torch.int64,
                           device=lo.device)

    pid = torch.arange(P, device=lo.device)
    ncoal = (gen.node_pop[:, S:, None] == pid[None, None, :]).sum(dim=1)

    # padding loci contribute nothing
    v = gen.valid[:, None]
    return CoalStats(coal_stats=torch.where(v, coal, torch.zeros_like(coal)),
                     mig_stats=torch.where(v, mig, torch.zeros_like(mig)),
                     num_coals=torch.where(v, ncoal, torch.zeros_like(ncoal)),
                     num_migs=torch.where(v, nmig, torch.zeros_like(nmig)))


def genealogy_log_prior(stats: CoalStats, params: Params) -> torch.Tensor:
    """Per-locus log prior of the genealogy given parameters
    (reference gtreeLnLikelihood, src/patch.c:2702-2738)."""
    th = params.theta
    lnl = torch.sum(stats.num_coals * torch.log(2.0 / th)[None, :]
                    - stats.coal_stats / th[None, :], dim=1)
    if params.mig_rate.shape[0] > 0:
        m = params.mig_rate
        safe_m = torch.where(m > 0.0, m, torch.ones_like(m))
        term = (stats.num_migs * torch.log(safe_m)[None, :]
                - stats.mig_stats * m[None, :])
        lnl = lnl + torch.where(m[None, :] > 0.0, term,
                                torch.zeros_like(term)).sum(dim=1)
    return lnl


def _anc_row_member(is_ancestral, pop, base_pop):
    """[L, NSEG] bool: is_ancestral[pop[l], base_pop[l, s]]."""
    return is_ancestral[pop[:, None], base_pop]


def lineage_presence_integral(gen: GenState, band_source: torch.Tensor,
                              pop: torch.Tensor, w0: torch.Tensor,
                              w1: torch.Tensor, tau: torch.Tensor,
                              pop_end: torch.Tensor,
                              is_ancestral: torch.Tensor,
                              exclude_edge: torch.Tensor = None,
                              oldage: float = OLDAGE) -> torch.Tensor:
    """integral over [w0, w1] of n_pop(t) dt, per locus (optionally
    excluding one edge and its migration segments)."""
    segs = segments(gen, band_source, oldage)
    present = segs.valid & _anc_row_member(is_ancestral, pop, segs.base_pop)
    if exclude_edge is not None:
        N = gen.num_nodes
        nid = torch.arange(N, device=pop.device)[None, :].expand(
            gen.num_loci, N)
        seg_edge = torch.cat(
            [nid, torch.where(gen.mig_branch >= 0, gen.mig_branch, -2)],
            dim=1)
        present = present & (seg_edge != exclude_edge[:, None])
    lo = torch.maximum(torch.maximum(segs.start, w0[:, None]),
                       tau[pop][:, None])
    hi = torch.minimum(torch.minimum(segs.end, w1[:, None]),
                       pop_end[pop][:, None])
    return torch.where(present, torch.clamp(hi - lo, min=0.0),
                       torch.zeros_like(lo)).sum(dim=1)


def mig_age_move_delta(gen: GenState, params: Params, ctx, slot: int,
                       tnew: torch.Tensor, band_start, band_end
                       ) -> torch.Tensor:
    """Genealogy-log-prior delta for moving migration event `slot` from its
    current age to tnew (inactive slots return 0).  Within the move window
    W the branch's base pop switches between the band's target p (below
    the event) and source s (above), so one lineage moves between anc(p)
    and anc(s) during W (see gphocs_tpu/ops/coalstats.py)."""
    P = params.theta.shape[0]
    active = gen.mig_branch[:, slot] >= 0
    band = torch.where(active, gen.mig_band[:, slot], 0)
    t = gen.mig_age[:, slot]
    s_pop = ctx.band_source[band]
    p_pop = ctx.band_target[band]
    up = tnew > t
    A = torch.where(up, p_pop, s_pop)    # pop gaining the lineage in W
    Rm = torch.where(up, s_pop, p_pop)   # pop losing it
    w0 = torch.minimum(t, tnew)
    w1 = torch.maximum(t, tnew)

    anc = ctx.is_ancestral                                   # [P, P]
    in_A = anc[:, A].T                                       # [L, P]: anc[r, A]
    in_R = anc[:, Rm].T
    addm = in_A & ~in_R
    remm = in_R & ~in_A

    segs = segments(gen, ctx.band_source, ctx.oldage)
    pend = _pop_end(ctx.father_pop, params.tau, ctx.oldage)
    lo = torch.maximum(torch.maximum(segs.start[:, None, :],
                                     params.tau[None, :, None]),
                       w0[:, None, None])
    hi = torch.minimum(torch.minimum(segs.end[:, None, :],
                                     pend[None, :, None]),
                       w1[:, None, None])
    anc_of_base = anc[:, segs.base_pop].permute(1, 0, 2)      # [L, P, NS]
    present = segs.valid[:, None, :] & anc_of_base
    integ = torch.where(present, torch.clamp(hi - lo, min=0.0),
                        torch.zeros_like(lo)).sum(dim=2)      # [L, P]
    wlen_r = torch.clamp(
        torch.minimum(w1[:, None], pend[None, :])
        - torch.maximum(w0[:, None], params.tau[None, :]), min=0.0)

    zero = torch.zeros_like(integ)
    dcoal = torch.where(addm, 2.0 * integ,
                        torch.where(remm, -2.0 * (integ - wlen_r), zero))
    dlnp = -torch.sum(dcoal / params.theta[None, :], dim=1)

    if ctx.num_bands > 0:
        tb = ctx.band_target                                  # [B]
        ov = torch.clamp(
            torch.minimum(w1[:, None], band_end[None, :])
            - torch.maximum(w0[:, None], band_start[None, :]), min=0.0)
        add_b = addm[:, tb]
        rem_b = remm[:, tb]
        dmig = torch.where(add_b, ov, torch.where(rem_b, -ov,
                                                  torch.zeros_like(ov)))
        dlnp = dlnp - torch.sum(dmig * params.mig_rate[None, :], dim=1)
    return torch.where(active, dlnp, torch.zeros_like(dlnp))


def node_age_move_delta(gen: GenState, params: Params, ctx,
                        inode: torch.Tensor, tnew: torch.Tensor,
                        band_start, band_end) -> torch.Tensor:
    """Genealogy-log-prior delta for moving coal node `inode` (one per
    locus) from its current age to tnew within its population:

      raising t -> t' adds one lineage on W = (t, t'):
          dcoal = 2 * int_W n dt,        dmig_b = |W ^ band_b|
      lowering removes one:
          dcoal = -2 * int_W (n - 1) dt, dmig_b = -|W ^ band_b|
      dlnP = -dcoal / theta_p - sum_b m_b dmig_b     (counts unchanged)
    """
    L = gen.num_loci
    ar = torch.arange(L, device=tnew.device)
    t = gen.age[ar, inode]
    pop = gen.node_pop[ar, inode]
    w0 = torch.minimum(t, tnew)
    w1 = torch.maximum(t, tnew)
    raising = tnew > t

    segs = segments(gen, ctx.band_source, ctx.oldage)
    present = segs.valid & _anc_row_member(ctx.is_ancestral, pop,
                                           segs.base_pop)
    lo = torch.maximum(segs.start, w0[:, None])
    hi = torch.minimum(segs.end, w1[:, None])
    integral = torch.where(present, torch.clamp(hi - lo, min=0.0),
                           torch.zeros_like(lo)).sum(dim=1)
    wlen = w1 - w0
    dcoal = torch.where(raising, 2.0 * integral, -2.0 * (integral - wlen))
    dlnp = -dcoal / params.theta[pop]
    if ctx.num_bands > 0:
        ov = torch.clamp(
            torch.minimum(w1[:, None], band_end[None, :])
            - torch.maximum(w0[:, None], band_start[None, :]), min=0.0)
        into_p = ctx.band_target[None, :] == pop[:, None]
        dmig = torch.where(into_p, torch.where(raising[:, None], ov, -ov),
                           torch.zeros_like(ov))
        dlnp = dlnp - torch.sum(dmig * params.mig_rate[None, :], dim=1)
    return dlnp
