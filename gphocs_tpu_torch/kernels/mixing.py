"""mixing: global multiplicative rescale of all time-scaled parameters
(twin of gphocs_tpu/kernels/mixing.py).

One factor c = exp(finetune * z) from the general stream scales thetas,
taus, sample ages, band windows, all node ages and all migration-event
ages; migration rates scale by 1/c.  The genealogy-prior delta reduces to
-lnc * (total coals + total migs); the proposal Jacobian is
lnc * (2 numPops - numCurPops - numMigBands + num_events)
(reference src/GPhoCS.c:4688-4915).  The data delta needs a full rebuild
of the conditionals, which is plain torch here as it is XLA code in the
JAX package.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch.kernels.common import Context, scalar_mh_accept
from gphocs_tpu_torch.ops.coalstats import CoalStats
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.state import GenState, Params, SeqData


def update_mixing(gen: GenState, params: Params, seq: SeqData, rng,
                  ctx: Context, finetune, lnld, lnp, cond, stats: CoalStats,
                  num_cur_pops: int):
    """Returns (gen, params, rng, lnld, lnp, cond, accepted)."""
    dt = lnld.dtype
    z, rng = R.general_draw_2normal8(rng, dt)
    lnc = finetune * z
    c = torch.exp(lnc)

    ncoal_tot = stats.num_coals.sum().to(dt)
    nmig_tot = stats.num_migs.sum().to(dt)
    num_events = ncoal_tot + nmig_tot
    P = ctx.num_pops
    B = ctx.num_bands

    lnacc = lnc * (2.0 * P - num_cur_pops - B + num_events)
    th_old = params.theta
    th_new = th_old * c
    lnacc = lnacc + torch.sum(lnc * (ctx.theta_alpha - 1.0)
                              - (th_new - th_old) * ctx.theta_beta)
    anc = torch.arange(P, device=lnld.device) >= num_cur_pops
    tau_old = params.tau
    tau_new = tau_old * c
    lnacc = lnacc + torch.sum(torch.where(
        anc, lnc * (ctx.tau_alpha - 1.0) - (tau_new - tau_old) * ctx.tau_beta,
        torch.zeros_like(tau_old)))
    if B > 0:
        m_old = params.mig_rate
        m_new = m_old / c
        lnacc = lnacc + torch.sum(-lnc * (ctx.mig_alpha - 1.0)
                                  - (m_new - m_old) * ctx.mig_beta)
    else:
        m_new = params.mig_rate
    gen_delta = -lnc * num_events
    sa_new = torch.where(params.sample_age > 0.0, params.sample_age * c,
                         params.sample_age)
    gen_prop = gen._replace(age=gen.age * c, mig_age=gen.mig_age * c)
    params_prop = params._replace(theta=th_new, tau=tau_new,
                                  sample_age=sa_new, mig_rate=m_new)
    cond_prop, lnld_prop = full_rebuild_and_lnld(gen_prop, seq)
    lnacc = lnacc + gen_delta + torch.sum(lnld_prop - lnld)

    accept, rng = scalar_mh_accept(rng, lnacc)

    gen = gen._replace(age=torch.where(accept, gen_prop.age, gen.age),
                       mig_age=torch.where(accept, gen_prop.mig_age,
                                           gen.mig_age))
    params = Params(*(n_ if n_ is None else torch.where(accept, n_, o)
                      for n_, o in zip(params_prop, params)))
    cond = torch.where(accept, cond_prop, cond)
    lnld = torch.where(accept, lnld_prop, lnld)
    per_locus = stats.num_coals.sum(dim=1) + stats.num_migs.sum(dim=1)
    lnp = torch.where(accept, lnp - lnc * per_locus.to(dt), lnp)
    return gen, params, rng, lnld, lnp, cond, accept.to(torch.int64)
