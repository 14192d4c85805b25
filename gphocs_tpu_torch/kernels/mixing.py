"""mixing: global multiplicative rescale of all time-scaled parameters
(twin of gphocs_tpu/kernels/mixing.py).

One factor c = exp(finetune * z) from the general stream scales thetas,
taus, sample ages, band windows, all node ages and all migration-event
ages; migration rates scale by 1/c.  The genealogy-prior delta reduces to
-lnc * (total coals + total migs); the proposal Jacobian is
lnc * (2 numPops - numCurPops - numMigBands + num_events)
(reference src/GPhoCS.c:4688-4915).  The data delta needs a full rebuild
of the conditionals on the scaled ages, XLA code in the JAX package:
here ops/sweeps.full_rebuild, one launch of csrc/full_rebuild.cu per
bucket on CUDA tensors, the plain full_rebuild_and_lnld on CPU tensors.
In a bucketed state every bucket is rebuilt and one joint accept covers
them all.  C chains ([C, P] parameters, chain-major loci) each
draw their own factor and decide on their own: the factors, sums and
decisions are [C].
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch.kernels.common import (Context, chain_count,
                                             maybe_psum, per_chain, rows,
                                             scalar_mh_accept)
from gphocs_tpu_torch.ops.sweeps import full_rebuild
from gphocs_tpu_torch.state import Params


def update_mixing_buckets(gens, params: Params, seqs, rng, ctx: Context,
                          finetune, lnlds, lnps, conds, stats_list,
                          num_cur_pops: int, loci_axis=None):
    """Mixing over the pattern buckets of a state (sequences with one entry
    per bucket): one factor, each bucket rebuilt, one joint accept
    (gphocs_tpu/sampler/bucketed.py:_mixing_bucketed).  On a loci mesh
    (`loci_axis`) the event counts and the data delta, added over the
    buckets, cross the ranks.  Returns (gens, params, rng, lnlds, lnps,
    conds, accepted) with lists."""
    dt = lnlds[0].dtype
    C = chain_count(params)
    z, rng = R.general_draw_2normal8(rng, dt)
    lnc = finetune * z
    c = torch.exp(lnc)
    # per parameter (a chain's factor against its [.., P] row)
    lnc_p, c_p = lnc[..., None], c[..., None]

    def events(counts):  # a bucket's events: of all loci, or per chain
        return counts.sum() if C is None else per_chain(counts.sum(dim=1), C)

    ncoal_tot, nmig_tot = maybe_psum(
        [sum(events(s.num_coals) for s in stats_list).to(dt),
         sum(events(s.num_migs) for s in stats_list).to(dt)], loci_axis)
    num_events = ncoal_tot + nmig_tot
    P = ctx.num_pops
    B = ctx.num_bands

    lnacc = lnc * (2.0 * P - num_cur_pops - B + num_events)
    th_old = params.theta
    th_new = th_old * c_p
    lnacc = lnacc + torch.sum(lnc_p * (ctx.theta_alpha - 1.0)
                              - (th_new - th_old) * ctx.theta_beta, dim=-1)
    anc = torch.arange(P, device=lnc.device) >= num_cur_pops
    tau_old = params.tau
    tau_new = tau_old * c_p
    lnacc = lnacc + torch.sum(torch.where(
        anc, lnc_p * (ctx.tau_alpha - 1.0)
        - (tau_new - tau_old) * ctx.tau_beta,
        torch.zeros_like(tau_old)), dim=-1)
    if B > 0:
        m_old = params.mig_rate
        m_new = m_old / c_p
        lnacc = lnacc + torch.sum(-lnc_p * (ctx.mig_alpha - 1.0)
                                  - (m_new - m_old) * ctx.mig_beta, dim=-1)
    else:
        m_new = params.mig_rate
    lnacc = lnacc - lnc * num_events
    sa_new = torch.where(params.sample_age > 0.0, params.sample_age * c_p,
                         params.sample_age)
    params_prop = params._replace(theta=th_new, tau=tau_new,
                                  sample_age=sa_new, mig_rate=m_new)
    props = []
    ddata = torch.zeros_like(lnc)
    for g, sq, ld, cd in zip(gens, seqs, lnlds, conds):
        c_l = rows(c, g.num_loci, 0)[:, None]
        gen_prop = g._replace(age=g.age * c_l, mig_age=g.mig_age * c_l)
        cond_prop, lnld_prop = full_rebuild(gen_prop, sq, cd)
        ddata = ddata + per_chain(lnld_prop - ld, C)
        props.append((gen_prop, cond_prop, lnld_prop))
    lnacc = lnacc + maybe_psum(ddata, loci_axis)

    accept, rng = scalar_mh_accept(rng, lnacc)

    acc_p = accept[..., None]
    params = Params(*(n_ if n_ is None else torch.where(acc_p, n_, o)
                      for n_, o in zip(params_prop, params)))
    out = ([], [], [], [])
    for (gen_prop, cond_prop, lnld_prop), g, ld, lp, cd, st in zip(
            props, gens, lnlds, lnps, conds, stats_list):
        L = g.num_loci
        acc_l = rows(accept, L, 0)
        lnc_l = rows(lnc, L, 0)
        out[0].append(g._replace(
            age=torch.where(acc_l[:, None], gen_prop.age, g.age),
            mig_age=torch.where(acc_l[:, None], gen_prop.mig_age,
                                g.mig_age)))
        out[1].append(torch.where(acc_l, lnld_prop, ld))
        per_locus = st.num_coals.sum(dim=1) + st.num_migs.sum(dim=1)
        out[2].append(torch.where(acc_l, lp - lnc_l * per_locus.to(dt), lp))
        out[3].append(torch.where(acc_l[:, None, None, None], cond_prop,
                                  cd))
    gens, lnlds, lnps, conds = out
    return gens, params, rng, lnlds, lnps, conds, accept.to(torch.int64)
