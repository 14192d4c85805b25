"""UpdateTau and UpdateSampleAge: rubber-band updates of population ages
and of estimated sample ages (twin of gphocs_tpu/kernels/tau.py, fast-RNG
mode).

UpdateTau, per ancestral pop `anc` with sons (s0, s1):
  bounds:  taub0 = max(son ages, son sample ages,
                       start of bands touching a son)
           taub1 = min(father age | OLDAGE, end of bands touching anc)
  factors: f0 = (taunew-taub0)/(tauold-taub0) stretches the region below,
           f1 = (taunew-taub1)/(tauold-taub1) squeezes above (f1 := f0 for
           the root, which scales around taub0)
  remap:   coal nodes in anc -> around taub1 by f1 (root: taub0/f0);
           coal nodes in sons above taub0 -> around taub0 by f0;
           migration events with an endpoint in {anc} -> f1; in {sons}
           (above taub0) or between both sons -> f0
  conflict: a remapped migration event must stay strictly inside its
           band's new window and keep its order against neighbour events
           on its branch; any conflict rejects the whole proposal
  accept:  lnacc = Gamma-prior ratio + dlnP(G) + dlnld
                 + ntj0*log(f0) + ntj1*log(f1)     (Jacobian)

`rubber_band_eval_plain` is the plain PyTorch version of the rubber-band
kernel (csrc/rubber_band.cu): the per-locus evaluation of one proposal
with the outputs of gphocs_tpu's rubber_band_eval_pallas.  Jacobian counts
and conflicts are masked by `gen.valid`, as the Pallas kernel does.

UpdateSampleAge, per current pop `pop` with an estimated sample age (the
kernel's sample-age mode): the same machinery with taub0 = 0, taub1 = the
father's tau, and `pop` itself in the sons' role.  Coal nodes of `pop`
below the old sample age scale around 0 by f0, those above it around taub1
by f1 (never the root form); the pop's leaves move to the new sample age;
migration events touching `pop` scale by the side of the old age they are
on, and all of them are conflict-checked.  tau, and with it the band
windows, do not move.

C chains ([C, P] parameters, chain-major loci, [C] general streams): every
chain draws and decides its own proposal for the population; the bounds,
old and new values, Jacobian counts, conflict flags and decisions are [C],
and a locus reads its chain's.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch.kernels.common import (Context, band_windows,
                                             chain_count, gen_log_prior,
                                             maybe_psum, per_chain, rows,
                                             scalar_mh_accept, take,
                                             with_entry)
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.state import GenState, Params, SeqData
from gphocs_tpu_torch.utils import reflect


def _mig_neighbor_ages(gen: GenState):
    """For every mig slot: age of nearest mig below/above on the same branch
    (+-inf if none), and their slot ids (first slot among equal ages)."""
    M = gen.max_migs
    active = gen.mig_branch >= 0
    same = (active[:, :, None] & active[:, None, :]
            & (gen.mig_branch[:, :, None] == gen.mig_branch[:, None, :]))
    ai = gen.mig_age[:, :, None]
    aj = gen.mig_age[:, None, :]
    idx = torch.arange(M, device=ai.device)
    above = same & ((aj > ai) | ((aj == ai)
                                 & (idx[None, None, :] > idx[None, :, None])))
    below = same & ((aj < ai) | ((aj == ai)
                                 & (idx[None, None, :] < idx[None, :, None])))
    inf = float("inf")
    up = torch.where(above, aj, torch.full_like(aj, inf)).min(dim=2)
    dn = torch.where(below, aj, torch.full_like(aj, -inf)).max(dim=2)
    return up.values, up.indices, dn.values, dn.indices


def _rubber_band_proposal(gen: GenState, params: Params, seq: SeqData,
                          ctx: Context, pop: int, is_sample_age: bool,
                          taub0, taub1, tauold, taunew):
    """Build the remapped state, count Jacobian terms per locus, detect
    conflicts per locus, and rebuild likelihood and prior on the proposal.

    Returns (gen_prop, params_prop, cond_prop, lnld_prop, lnp_prop,
    ntj0 [L], ntj1 [L], conflict [L]) with the per-locus counts not yet
    reduced.  The four bounds are 0-d, or [C] for C chains."""
    S = gen.num_samples
    N = gen.num_nodes
    L = gen.num_loci
    dev = gen.age.device
    is_root = pop == ctx.root_pop and not is_sample_age
    new_val = taunew
    # each locus's chain's values, [1 | L, 1] against its [L, N] rows
    dt = gen.age.dtype
    taub0, taub1, tauold, taunew = (
        rows(torch.as_tensor(x, dtype=dt, device=dev), L, 0)[:, None]
        for x in (taub0, taub1, tauold, taunew))

    f0 = (taunew - taub0) / (tauold - taub0)
    f1 = f0 if is_root else (taunew - taub1) / (tauold - taub1)

    age = gen.age
    internal = (torch.arange(N, device=dev) >= S)[None, :]
    if is_sample_age:
        in_pop = gen.node_pop == pop
        # below the old sample age: f0 around taub0; above: f1 around taub1
        moved0 = in_pop & (age > taub0) & (age < tauold) & internal
        moved1 = in_pop & (age >= tauold) & (age < taub1) & internal
        new_age = torch.where(moved0, taub0 + f0 * (age - taub0), age)
        new_age = torch.where(moved1, taub1 + f1 * (age - taub1), new_age)
        # the pop's leaves sit at the sample age and move with it
        new_age = torch.where(in_pop & ~internal, taunew, new_age)
        new_tau = params.tau
        params_prop = params._replace(
            sample_age=with_entry(params.sample_age, pop, new_val))
    else:
        s0, s1 = ctx.pop_sons[pop, 0], ctx.pop_sons[pop, 1]
        in_anc = gen.node_pop == pop
        in_sons = (gen.node_pop == s0) | (gen.node_pop == s1)
        # the event-chain walk scales only events strictly inside the
        # window (reference patch.c:632-698: loop breaks at end_time)
        if is_root:
            anc_map = taub0 + f0 * (age - taub0)
            moved1 = in_anc & internal
        else:
            anc_map = taub1 + f1 * (age - taub1)
            moved1 = in_anc & internal & (age < taub1)
        moved0 = in_sons & (age > taub0) & (age < tauold) & internal
        new_age = torch.where(moved1, anc_map, age)
        new_age = torch.where(moved0, taub0 + f0 * (age - taub0), new_age)
        new_tau = with_entry(params.tau, pop, new_val)
        params_prop = params._replace(tau=new_tau)
    ntj0 = moved0.sum(dim=1)
    ntj1 = moved1.sum(dim=1)

    conflict = torch.zeros_like(gen.valid)
    if ctx.num_bands == 0:
        gen_prop = gen._replace(age=new_age)
    else:
        active = gen.mig_branch >= 0
        band = torch.where(active, gen.mig_band, 0)
        msrc = ctx.band_source[band]
        mtgt = ctx.band_target[band]
        mage = gen.mig_age
        in_window = active & (mage >= taub0) & (mage <= taub1)
        if is_sample_age:
            touches = in_window & ((msrc == pop) | (mtgt == pop))
            f1_sel = touches & (mage > tauold)
            f0_sel = touches & (mage <= tauold)
            checked = touches
            kind_out = msrc == pop  # out-migration w.r.t. the pop

            def exempt(p):  # a neighbour event of the pop itself
                return p == pop
        else:
            both_sons = in_window & (((msrc == s0) & (mtgt == s1))
                                     | ((msrc == s1) & (mtgt == s0)))
            src_anc = in_window & ~both_sons & (msrc == pop)
            tgt_anc = in_window & ~both_sons & ~src_anc & (mtgt == pop)
            src_son = (in_window & ~both_sons & ~src_anc & ~tgt_anc
                       & ((msrc == s0) | (msrc == s1)) & (mage > taub0))
            tgt_son = (in_window & ~both_sons & ~src_anc & ~tgt_anc
                       & ~src_son & ((mtgt == s0) | (mtgt == s1))
                       & (mage > taub0))
            f1_sel = src_anc | tgt_anc
            f0_sel = both_sons | src_son | tgt_son
            checked = src_anc | tgt_anc | src_son | tgt_son  # not both_sons
            kind_out = src_anc | src_son

            def exempt(p):  # a neighbour event of the trio
                return (p == pop) | (p == s0) | (p == s1)
        new_mage = torch.where(f1_sel, taub1 + f1 * (mage - taub1), mage)
        new_mage = torch.where(f0_sel, taub0 + f0 * (mage - taub0), new_mage)
        ntj0 = ntj0 + f0_sel.sum(dim=1)
        ntj1 = ntj1 + f1_sel.sum(dim=1)

        # conflicts: NEW band windows, OLD node ages, OLD neighbour mig ages
        # (reference :3606-3680)
        bs_new, be_new = band_windows(ctx, new_tau)
        up_age, up_slot, dn_age, dn_slot = _mig_neighbor_ages(gen)
        branch = torch.where(active, gen.mig_branch, 0)
        fa = torch.gather(gen.father, 1, branch)
        fa_age = torch.gather(gen.age, 1, fa.clamp(min=0))
        child_age = torch.gather(gen.age, 1, branch)

        conf = checked & ((new_mage >= take(be_new, band))
                          | (new_mage <= take(bs_new, band)))
        moving_up = checked & ~kind_out & (new_mage > mage)
        up_src = ctx.band_source[torch.gather(band, 1, up_slot)]
        conf = conf | (moving_up & torch.isfinite(up_age) & ~exempt(up_src)
                       & (new_mage >= up_age))
        conf = conf | (moving_up & (fa >= 0) & (new_mage >= fa_age))
        moving_dn = checked & kind_out & (new_mage < mage)
        dn_tgt = ctx.band_target[torch.gather(band, 1, dn_slot)]
        conf = conf | (moving_dn & torch.isfinite(dn_age) & ~exempt(dn_tgt)
                       & (new_mage <= dn_age))
        conf = conf | (moving_dn & (new_mage <= child_age))
        conflict = conf.any(dim=1)
        gen_prop = gen._replace(age=new_age,
                                mig_age=torch.where(active, new_mage, mage))
    cond_prop, lnld_prop = full_rebuild_and_lnld(gen_prop, seq)
    lnp_prop = gen_log_prior(gen_prop, params_prop, ctx)
    return (gen_prop, params_prop, cond_prop, lnld_prop, lnp_prop,
            ntj0, ntj1, conflict)


def rubber_band_eval_plain(gen: GenState, params: Params, seq: SeqData,
                           ctx: Context, pop: int, is_sample_age: bool,
                           taub0, taub1, tauold, taunew, cond):
    """Plain version of the rubber-band kernel: one population's proposal
    evaluated for every locus.  Returns (age_prop [L,N], mag_prop [L,M],
    cond_prop, lnld_prop [L], lnp_prop [L], ntj0 [], ntj1 [], any_conflict
    []), with ntj and conflicts masked by gen.valid; for C chains the
    bounds, counts and flags are [C], each chain's own.  `cond` supplies
    the leaf conditionals in the kernel; here they are rebuilt from seq."""
    (gen_p, _params_p, cond_p, lnld_p, lnp_p, ntj0, ntj1,
     conflict) = _rubber_band_proposal(gen, params, seq, ctx, pop,
                                       is_sample_age, taub0, taub1, tauold,
                                       taunew)
    dt = gen.age.dtype
    v = gen.valid
    C = chain_count(params)
    lnp_p = torch.where(v, lnp_p, torch.zeros_like(lnp_p))
    ntj0 = per_chain(torch.where(v, ntj0, 0), C).to(dt)
    ntj1 = per_chain(torch.where(v, ntj1, 0), C).to(dt)
    return (gen_p.age, gen_p.mig_age, cond_p, lnld_p, lnp_p, ntj0, ntj1,
            per_chain(conflict & v, C, "any"))


def _rubber_band_sweep(gens, params: Params, seqs, rng, ctx: Context,
                       finetunes_taus, lnlds, lnps, conds, pops,
                       is_sample_age: bool, evaluate, loci_axis=None):
    """One rubber-band proposal per population of `pops`, in order, with one
    joint accept over the buckets of the state (sequences `gens`, `seqs`,
    `lnlds`, `lnps`, `conds`: one entry per pattern bucket, one entry for an
    unbucketed state).  `evaluate` (rubber_band_eval's signature) gives each
    bucket's proposal; the likelihood and prior deltas, the Jacobian counts
    and the conflict flags add up over the buckets before the one decision
    (the reference's single global accept over all loci); on a loci mesh
    (`loci_axis`) these bucket totals then cross the ranks in one
    all-reduce per proposal, before the decision.  Returns (gens,
    params, rng, lnlds, lnps, conds, accepted[P], conflicts) with lists
    ([C, P] and [C] for C chains, each chain proposing and deciding on
    its own)."""
    gens, lnlds, lnps, conds = list(gens), list(lnlds), list(lnps), list(conds)
    dt = lnlds[0].dtype
    dev = lnlds[0].device
    C = chain_count(params)
    accepted = torch.zeros(params.tau.shape, dtype=torch.int64, device=dev)
    conflicts = torch.zeros(params.tau.shape[:-1], dtype=torch.int64,
                            device=dev)
    for pop in pops:
        if is_sample_age:
            is_root = False
            tauold = params.sample_age[..., pop]
            taub0 = torch.zeros_like(tauold)
            taub1 = params.tau[..., ctx.father_pop[pop]]
        else:
            is_root = pop == ctx.num_pops - 1
            tauold = params.tau[..., pop]
            taub0, taub1 = _tau_window(params, ctx, pop, is_root, dt, dev)
        z, rng = R.general_draw_2normal8(rng, dt)
        taunew = reflect(tauold + finetunes_taus[pop] * z, taub0, taub1)
        props = [evaluate(g, params, sq, ctx, pop, is_sample_age, taub0,
                          taub1, tauold, taunew, c)
                 for g, sq, c in zip(gens, seqs, conds)]
        lnf0 = torch.log((taunew - taub0) / (tauold - taub0))
        lnf1 = lnf0 if is_root else torch.log((taunew - taub1)
                                              / (tauold - taub1))
        dsum = torch.zeros_like(tauold)
        for p, ld, lp in zip(props, lnlds, lnps):
            dsum = dsum + per_chain(p[3] - ld, C) + per_chain(p[4] - lp, C)
        ntj0 = sum(p[5] for p in props)
        ntj1 = sum(p[6] for p in props)
        conflict = props[0][7]
        for p in props[1:]:
            conflict = conflict | p[7]
        # the conflict flag travels as a sum of 0/1 flags
        dsum, ntj0, ntj1, conflict = maybe_psum([dsum, ntj0, ntj1, conflict],
                                                loci_axis)
        lnacc = (torch.log(taunew / tauold) * (ctx.tau_alpha[pop] - 1.0)
                 - (taunew - tauold) * ctx.tau_beta[pop]
                 + dsum + ntj0 * lnf0 + ntj1 * lnf1)
        accept, rng = scalar_mh_accept(rng, lnacc, conflict)
        for k, (age_p, mag_p, cond_p, lnld_p, lnp_p, *_) in enumerate(props):
            acc = rows(accept, gens[k].num_loci, 0)  # each locus's chain's
            gens[k] = gens[k]._replace(
                age=torch.where(acc[:, None], age_p, gens[k].age),
                mig_age=torch.where(acc[:, None], mag_p, gens[k].mig_age))
            lnlds[k] = torch.where(acc, lnld_p, lnlds[k])
            lnps[k] = torch.where(acc, lnp_p, lnps[k])
            conds[k] = torch.where(acc[:, None, None, None], cond_p, conds[k])
        field = "sample_age" if is_sample_age else "tau"
        old = getattr(params, field)
        params = params._replace(**{field: torch.where(
            accept[..., None], with_entry(old, pop, taunew), old)})
        accepted[..., pop] += accept.to(torch.int64)
        conflicts = conflicts + conflict.to(torch.int64)
    return gens, params, rng, lnlds, lnps, conds, accepted, conflicts


def _tau_window(params: Params, ctx: Context, pop: int, is_root: bool, dt,
                dev):
    """(taub0, taub1): the bounds of an ancestral pop's tau, from its sons'
    ages and sample ages, its father's age (OLDAGE for the root) and the
    current windows of the bands touching it or its sons (reference
    :3279-3294); [C] each for C chains."""
    s0, s1 = ctx.pop_sons[pop, 0], ctx.pop_sons[pop, 1]
    tau, sa = params.tau, params.sample_age
    taub0 = torch.maximum(torch.maximum(tau[..., s0], tau[..., s1]),
                          torch.maximum(sa[..., s0], sa[..., s1]))
    taub1 = (torch.full(tau.shape[:-1], ctx.oldage, dtype=dt, device=dev)
             if is_root else tau[..., ctx.father_pop[pop]])
    if ctx.num_bands > 0:
        bs, be = band_windows(ctx, params.tau)
        src, tgt = ctx.band_source, ctx.band_target
        touch_anc = (src == pop) | (tgt == pop)
        touch_son = (~touch_anc & ((src == s0) | (src == s1)
                                   | (tgt == s0) | (tgt == s1)))
        inf = float("inf")
        taub1 = torch.minimum(taub1, torch.where(
            touch_anc, be, torch.full_like(be, inf)).amin(dim=-1))
        taub0 = torch.maximum(taub0, torch.where(
            touch_son, bs, torch.full_like(bs, -inf)).amax(dim=-1))
    return taub0, taub1


def _one(out):
    """An unbucketed sweep's result: the one bucket out of every list."""
    gens, params, rng, lnlds, lnps, conds, accepted, conflicts = out
    return (gens[0], params, rng, lnlds[0], lnps[0], conds[0], accepted,
            conflicts)


def update_taus(gen: GenState, params: Params, seq: SeqData, rng,
                ctx: Context, finetunes_taus, lnld, lnp, cond,
                num_pops: int, num_cur_pops: int):
    """UpdateTau with the plain per-locus evaluation.  Returns (gen,
    params, rng, lnld, lnp, cond, accepted[P], conflicts)."""
    return _one(_rubber_band_sweep(
        [gen], params, [seq], rng, ctx, finetunes_taus, [lnld], [lnp],
        [cond], range(num_cur_pops, num_pops), False,
        rubber_band_eval_plain))


def update_taus_fused(gen: GenState, params: Params, seq: SeqData, rng,
                      ctx: Context, finetunes_taus, lnld, lnp, cond,
                      num_pops: int, num_cur_pops: int):
    """UpdateTau with the per-locus evaluation through
    ops/sweeps.rubber_band_eval (the kernel on CUDA tensors)."""
    return _one(update_taus_buckets(
        [gen], params, [seq], rng, ctx, finetunes_taus, [lnld], [lnp],
        [cond], num_pops, num_cur_pops))


def update_taus_buckets(gens, params: Params, seqs, rng, ctx: Context,
                        finetunes_taus, lnlds, lnps, conds, num_pops: int,
                        num_cur_pops: int, loci_axis=None):
    """UpdateTau over the pattern buckets of a state (sequences of one entry
    per bucket), one joint accept per population, each bucket's proposal
    through ops/sweeps.rubber_band_eval.  Returns lists, as
    _rubber_band_sweep."""
    from gphocs_tpu_torch.ops.sweeps import rubber_band_eval

    return _rubber_band_sweep(gens, params, seqs, rng, ctx, finetunes_taus,
                              lnlds, lnps, conds,
                              range(num_cur_pops, num_pops), False,
                              rubber_band_eval, loci_axis)


def update_sample_ages_fused(gen: GenState, params: Params, seq: SeqData,
                             rng, ctx: Context, finetunes_taus, lnld, lnp,
                             cond, num_cur_pops: int, update_mask):
    """UpdateSampleAge: one rubber-band proposal, in the sample-age mode,
    per current pop whose entry of `update_mask` (a sequence of bools) is
    set, in population order.  The per-locus evaluation goes through
    ops/sweeps.rubber_band_eval (the kernel on CUDA tensors, the plain
    version on CPU tensors).  The Gamma-prior ratio uses the pop's own
    tau_alpha/tau_beta.  Returns (gen, params, rng, lnld, lnp, cond,
    accepted[P], conflicts)."""
    return _one(update_sample_ages_buckets(
        [gen], params, [seq], rng, ctx, finetunes_taus, [lnld], [lnp],
        [cond], num_cur_pops, update_mask))


def update_sample_ages_buckets(gens, params: Params, seqs, rng,
                               ctx: Context, finetunes_taus, lnlds, lnps,
                               conds, num_cur_pops: int, update_mask,
                               loci_axis=None):
    """UpdateSampleAge over the pattern buckets of a state; see
    update_taus_buckets."""
    from gphocs_tpu_torch.ops.sweeps import rubber_band_eval

    pops = [p for p in range(num_cur_pops) if update_mask[p]]
    return _rubber_band_sweep(gens, params, seqs, rng, ctx, finetunes_taus,
                              lnlds, lnps, conds, pops, True,
                              rubber_band_eval, loci_axis)
