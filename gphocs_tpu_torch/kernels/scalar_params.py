"""UpdateTheta and UpdateMigRates: closed-form stats-only parameter updates
(twin of gphocs_tpu/kernels/scalar_params.py).

Both use multiplicative proposals x' = x * exp(finetune * rnd2normal8)
from the general stream with Gamma priors; the genealogy-likelihood delta
comes in closed form from the total sufficient statistics:

  theta:   delta = -(lnc * ncoals_tot + (1/x' - 1/x) * coalstats_tot)
  migrate: delta = +(lnc * nmigs_tot  - (x' - x)   * migstats_tot)
           proposals below 1e-5 are skipped outright (reference :3159)

Fast streams: all P (or B) proposals are evaluated in one vector step; the
statistics do not change under these moves, so the sweep is exactly
parallel.  For C chains ([C, P] parameters, [C] general streams) the
totals are each chain's and every chain draws, decides and counts on its
own: the [C, P] (or [C, B]) proposals are one vector step too.

A Wichmann-Hill general stream (the conformance mode) keeps the
reference's sequential scan (src/GPhoCS.c:3037-3212): per population (or
band), in order, one rnd2normal8 and one MH decision (the uniform only
where lnacc < 0; a migration-rate proposal below the floor takes none).
C chains' streams ([C, 1]) take the scan's steps together: step p moves
column p of every chain, each chain drawing and deciding on its own.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.constants import MIN_MIG_RATE
from gphocs_tpu_torch.kernels.common import (Context, chain_count,
                                             maybe_psum, per_chain, rows,
                                             scalar_mh_accept, with_entry)
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
    if not isinstance(rng, RF.FastRngState):
        return _thetas_serial(params, rng, ctx, finetune, lnp, stats,
                              ncoal_tot, coal_tot)
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
    if not isinstance(rng, RF.FastRngState):
        return _mig_rates_serial(params, rng, ctx, finetune, lnp, stats,
                                 nmig_tot, mig_tot)
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


def _thetas_serial(params: Params, rng, ctx: Context, finetune, lnp,
                   stats: CoalStats, ncoal_tot, coal_tot):
    """update_thetas on Wichmann-Hill general streams: one population
    after another (gphocs_tpu's scan, scalar_params.py:66-94), each step
    moving every chain's column at once ([C] draws, decisions and
    counts for C chains)."""
    dt = lnp.dtype
    L = lnp.shape[0]
    ncoal = stats.num_coals.to(dt)
    theta = params.theta
    acc = torch.zeros(theta.shape[:-1], dtype=torch.int64,
                      device=lnp.device)
    for pop in range(ctx.num_pops):
        theta_old = theta[..., pop]
        z, rng = R.general_draw_2normal8(rng, dt)
        lnc = finetune * z
        theta_new = theta_old * torch.exp(lnc)
        lnacc = (lnc + lnc * (ctx.theta_alpha[pop] - 1.0)
                 - (theta_new - theta_old) * ctx.theta_beta[pop])
        dinv = 1.0 / theta_new - 1.0 / theta_old
        lnacc = lnacc + -(lnc * ncoal_tot[..., pop]
                          + dinv * coal_tot[..., pop])
        accept, rng = scalar_mh_accept(rng, lnacc)
        theta = with_entry(theta, pop,
                           torch.where(accept, theta_new, theta_old))
        dlnp = -(rows(lnc, L, 0) * ncoal[:, pop]
                 + rows(dinv, L, 0) * stats.coal_stats[:, pop])
        lnp = torch.where(rows(accept, L, 0), lnp + dlnp, lnp)
        acc = acc + accept.to(torch.int64)
    return params._replace(theta=theta), rng, lnp, acc


def _mig_rates_serial(params: Params, rng, ctx: Context, finetune, lnp,
                      stats: CoalStats, nmig_tot, mig_tot):
    """update_mig_rates on Wichmann-Hill general streams: one band after
    another (gphocs_tpu's scan, scalar_params.py:128-160), every chain's
    column at once, as _thetas_serial."""
    dt = lnp.dtype
    L = lnp.shape[0]
    nmig = stats.num_migs.to(dt)
    rate = params.mig_rate
    acc = torch.zeros(rate.shape[:-1], dtype=torch.int64, device=lnp.device)
    for band in range(ctx.num_bands):
        old = rate[..., band]
        z, rng = R.general_draw_2normal8(rng, dt)
        lnc = finetune * z
        new = old * torch.exp(lnc)
        skip = new < MIN_MIG_RATE  # skipped before the prior (:3159)
        lnacc = (lnc + lnc * (ctx.mig_alpha[band] - 1.0)
                 - (new - old) * ctx.mig_beta[band])
        lnacc = lnacc + (lnc * nmig_tot[..., band]
                         - (new - old) * mig_tot[..., band])
        accept, rng = scalar_mh_accept(rng, lnacc, conflict=skip)
        rate = with_entry(rate, band, torch.where(accept, new, old))
        dlnp = (rows(lnc, L, 0) * nmig[:, band]
                - rows(new - old, L, 0) * stats.mig_stats[:, band])
        lnp = torch.where(rows(accept, L, 0), lnp + dlnp, lnp)
        acc = acc + accept.to(torch.int64)
    return params._replace(mig_rate=rate), rng, lnp, acc
