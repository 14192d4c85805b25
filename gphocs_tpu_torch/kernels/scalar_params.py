"""UpdateTheta and UpdateMigRates: closed-form stats-only parameter updates
(twin of the fast-RNG branches of gphocs_tpu/kernels/scalar_params.py).

Both use multiplicative proposals x' = x * exp(finetune * rnd2normal8)
from the general stream with Gamma priors; the genealogy-likelihood delta
comes in closed form from the total sufficient statistics:

  theta:   delta = -(lnc * ncoals_tot + (1/x' - 1/x) * coalstats_tot)
  migrate: delta = +(lnc * nmigs_tot  - (x' - x)   * migstats_tot)
           proposals below 1e-5 are skipped outright (reference :3159)

All P (or B) proposals are evaluated in one vector step; the statistics
do not change under these moves, so the sweep is exactly parallel.  For C
chains ([C, P] parameters, [C] general streams) the totals are each
chain's and every chain draws, decides and counts on its own: the [C, P]
(or [C, B]) proposals are one vector step too.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.constants import MIN_MIG_RATE
from gphocs_tpu_torch.kernels.common import (Context, chain_count,
                                             maybe_psum, per_chain, rows)
from gphocs_tpu_torch.ops.coalstats import CoalStats
from gphocs_tpu_torch.state import GenState, Params


def _accept(u, lnacc):
    return (lnacc >= 0.0) | (u < torch.exp(torch.clamp(lnacc, max=0.0)))


def update_thetas(gen: GenState, params: Params, rng, ctx: Context,
                  finetune, lnp: torch.Tensor, stats: CoalStats,
                  loci_axis=None):
    """Returns (params, rng, lnp, accepted_count) ([C] counts for C
    chains).  loci_axis: the loci mesh, over which the totals add up."""
    dt = lnp.dtype
    P = ctx.num_pops
    L = lnp.shape[0]
    C = chain_count(params)
    ncoal = stats.num_coals.to(dt)
    ncoal_tot, coal_tot = maybe_psum(
        [per_chain(ncoal, C), per_chain(stats.coal_stats, C)],  # [(C,) P]
        loci_axis)
    z, rng = RF.batch_2normal8(rng, P, dt)
    lnc = finetune * z
    theta_old = params.theta
    theta_new = theta_old * torch.exp(lnc)
    dinv = 1.0 / theta_new - 1.0 / theta_old
    lnacc = (lnc + lnc * (ctx.theta_alpha - 1.0)
             - (theta_new - theta_old) * ctx.theta_beta
             - (lnc * ncoal_tot + dinv * coal_tot))
    u, rng = RF.batch_u(rng, P, dt)
    accept = _accept(u, lnacc)
    params = params._replace(theta=torch.where(accept, theta_new, theta_old))
    dlnp = -(rows(lnc, L) * ncoal + rows(dinv, L) * stats.coal_stats)
    lnp = lnp + torch.where(rows(accept, L), dlnp,
                            torch.zeros_like(dlnp)).sum(dim=1)
    return params, rng, lnp, accept.sum(dim=-1)


def update_mig_rates(gen: GenState, params: Params, rng, ctx: Context,
                     finetune, lnp: torch.Tensor, stats: CoalStats,
                     loci_axis=None):
    """Returns (params, rng, lnp, accepted_count) ([C] counts for C
    chains).  loci_axis: as update_thetas."""
    B = ctx.num_bands
    if B == 0:
        return params, rng, lnp, torch.zeros(
            params.theta.shape[:-1], dtype=torch.int64, device=lnp.device)
    dt = lnp.dtype
    L = lnp.shape[0]
    C = chain_count(params)
    nmig = stats.num_migs.to(dt)
    nmig_tot, mig_tot = maybe_psum(
        [per_chain(nmig, C), per_chain(stats.mig_stats, C)],    # [(C,) B]
        loci_axis)
    z, rng = RF.batch_2normal8(rng, B, dt)
    lnc = finetune * z
    old = params.mig_rate
    new = old * torch.exp(lnc)
    skip = new < MIN_MIG_RATE
    lnacc = (lnc + lnc * (ctx.mig_alpha - 1.0)
             - (new - old) * ctx.mig_beta
             + lnc * nmig_tot - (new - old) * mig_tot)
    u, rng = RF.batch_u(rng, B, dt)
    accept = ~skip & _accept(u, lnacc)
    params = params._replace(mig_rate=torch.where(accept, new, old))
    dlnp = rows(lnc, L) * nmig - rows(new - old, L) * stats.mig_stats
    lnp = lnp + torch.where(rows(accept, L), dlnp,
                            torch.zeros_like(dlnp)).sum(dim=1)
    return params, rng, lnp, accept.sum(dim=-1)
