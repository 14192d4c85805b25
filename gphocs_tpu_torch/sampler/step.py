"""One MCMC iteration and a chunk of iterations (twin of the fused,
fast-RNG path of gphocs_tpu/sampler/step.py).

Update schedule (reference performMCMC, src/GPhoCS.c:1476-1705):

    repeat genetreeSamples times:
        node-age sweep; migration-age sweep; SPR sweep;
        [paired locus-rate update if VAR rates]
    full_stats; theta; [migration rates if iteration > start-mig];
    one tau rubber-band proposal per ancestral pop;
    [one sample-age rubber-band proposal per current pop with an estimated
    sample age]; [mixing]

The three sweeps and the rubber-band evaluation go through the kernel
wrappers in ops/sweeps.py.  Everything stays on the sampler's device:
accept counts are 0-d tensors, and the host reads them once per chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gphocs_tpu_torch.kernels.common import (Context, full_stats,
                                             gen_log_prior,
                                             gen_log_prior_from_stats)
from gphocs_tpu_torch.kernels.locus_rate import update_locus_rates_paired
from gphocs_tpu_torch.kernels.mixing import update_mixing
from gphocs_tpu_torch.kernels.scalar_params import (update_mig_rates,
                                                    update_thetas)
from gphocs_tpu_torch.kernels.tau import (update_sample_ages_fused,
                                          update_taus_fused)
from gphocs_tpu_torch.ops.sweeps import (mig_age_sweep, node_age_sweep,
                                         spr_sweep)
from gphocs_tpu_torch.state import GenState, Params, SeqData


class Finetunes(NamedTuple):
    """Device-side finetune values (the auto-search mutates them)."""

    coal_time: torch.Tensor
    mig_time: torch.Tensor
    theta: torch.Tensor
    mig_rate: torch.Tensor
    mixing: torch.Tensor
    locus_rate: torch.Tensor
    admix: torch.Tensor
    taus: torch.Tensor  # [P]


class StepStats(NamedTuple):
    acc_coal_time: torch.Tensor
    acc_mig_time: torch.Tensor
    acc_spr: torch.Tensor
    acc_theta: torch.Tensor
    acc_mig_rate: torch.Tensor
    acc_taus: torch.Tensor       # [P]
    acc_mixing: torch.Tensor
    acc_locus_rate: torch.Tensor
    rate_var_delta: torch.Tensor
    tau_conflicts: torch.Tensor
    num_migs_total: torch.Tensor
    lnld_sum: torch.Tensor
    lnp_sum: torch.Tensor


class ChunkTrace(NamedTuple):
    """Per-iteration outputs of a chunk (leading axis = iterations)."""

    theta: torch.Tensor        # [K, P]
    tau: torch.Tensor          # [K, P]
    sample_age: torch.Tensor   # [K, P]
    mig_rate: torch.Tensor     # [K, B]
    lnld_sum: torch.Tensor     # [K]
    lnp_sum: torch.Tensor      # [K]


def mcmc_iteration(gen: GenState, params: Params, seq: SeqData, lrng, grng,
                   lnld, lnp, cond, ft: Finetunes, *, ctx: Context,
                   genetree_samples: int, do_migrate: bool, do_mixing: bool,
                   num_pops: int, num_cur_pops: int,
                   sample_age_mask: tuple = (),
                   coal_time_on: bool = True, mig_time_on: bool = True,
                   theta_on: bool = True, mig_rate_on: bool = True,
                   mixing_on: bool = True, var_rates: bool = False,
                   locus_rate_on: bool = True, var_alpha: float = 1.0):
    """Returns (gen, params, lrng, grng, lnld, lnp, cond, StepStats).

    sample_age_mask: per current pop, whether its sample age is estimated.
    var_rates: `locus-mut-rate VAR` (var_alpha is its Dirichlet alpha).

    cond: carried pruning conditionals, consistent with (gen, seq) on
    entry and on return (lnld == lnld_from_cond(cond) at every step
    boundary)."""
    dev = lnld.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    acc_ct = acc_mt = acc_spr = acc_lr = zero
    dvar = torch.zeros((), dtype=lnld.dtype, device=dev)
    for gs in range(genetree_samples):
        if coal_time_on:
            gen, lrng, lnld, lnp, cond, a = node_age_sweep(
                gen, params, seq, lrng, ctx, ft.coal_time, lnld, lnp, cond)
            acc_ct = acc_ct + a
        if mig_time_on and ctx.num_bands > 0:
            gen, lrng, lnp, a = mig_age_sweep(gen, params, lrng, ctx,
                                              ft.mig_time, lnp)
            acc_mt = acc_mt + a
        gen, lrng, lnld, cond, a = spr_sweep(gen, params, seq, lrng, ctx,
                                             lnld, cond)
        acc_spr = acc_spr + a
        # SPR tracks only the data likelihood; the prior refresh of the
        # last genetree sample is merged into the full_stats pass below
        if gs < genetree_samples - 1:
            lnp = gen_log_prior(gen, params, ctx)
        if var_rates and locus_rate_on:
            gen, lrng, lnld, cond, a, dv = update_locus_rates_paired(
                gen, seq, lrng, ft.locus_rate, lnld, var_alpha, cond)
            acc_lr = acc_lr + a
            dvar = dvar + dv

    stats = full_stats(gen, params, ctx)
    lnp = gen_log_prior_from_stats(stats, gen, params, ctx)
    acc_th = acc_mr = zero
    if theta_on:
        params, grng, lnp, acc_th = update_thetas(
            gen, params, grng, ctx, ft.theta, lnp, stats)
    if do_migrate and mig_rate_on and ctx.num_bands > 0:
        params, grng, lnp, acc_mr = update_mig_rates(
            gen, params, grng, ctx, ft.mig_rate, lnp, stats)
    gen, params, grng, lnld, lnp, cond, acc_taus, conflicts = \
        update_taus_fused(gen, params, seq, grng, ctx, ft.taus, lnld, lnp,
                          cond, num_pops, num_cur_pops)
    if any(sample_age_mask):
        gen, params, grng, lnld, lnp, cond, acc_sa, conf_sa = \
            update_sample_ages_fused(gen, params, seq, grng, ctx, ft.taus,
                                     lnld, lnp, cond, num_cur_pops,
                                     sample_age_mask)
        acc_taus = acc_taus + acc_sa
        conflicts = conflicts + conf_sa
    acc_mix = zero
    if do_mixing and mixing_on:
        # mixing reads only event counts, which theta/mig-rate/tau moves
        # never change, so the stats pass above is reusable as-is
        gen, params, grng, lnld, lnp, cond, acc_mix = update_mixing(
            gen, params, seq, grng, ctx, ft.mixing, lnld, lnp, cond, stats,
            num_cur_pops)

    out = StepStats(
        acc_coal_time=acc_ct, acc_mig_time=acc_mt, acc_spr=acc_spr,
        acc_theta=acc_th, acc_mig_rate=acc_mr, acc_taus=acc_taus,
        acc_mixing=acc_mix, acc_locus_rate=acc_lr, rate_var_delta=dvar,
        tau_conflicts=conflicts,
        num_migs_total=(gen.mig_branch >= 0).sum(),
        lnld_sum=lnld.sum(), lnp_sum=lnp.sum())
    return gen, params, lrng, grng, lnld, lnp, cond, out


def mcmc_chunk(gen: GenState, params: Params, seq: SeqData, lrng, grng,
               lnld, lnp, cond, ft: Finetunes, *, ctx: Context, n_iters: int,
               **flags):
    """Run n_iters iterations.  Returns (gen, params, lrng, grng, lnld,
    lnp, cond, totals: StepStats summed over the chunk, ChunkTrace)."""
    stats, rows = [], []
    for _ in range(n_iters):
        gen, params, lrng, grng, lnld, lnp, cond, st = mcmc_iteration(
            gen, params, seq, lrng, grng, lnld, lnp, cond, ft, ctx=ctx,
            **flags)
        stats.append(st)
        rows.append((params.theta, params.tau, params.sample_age,
                     params.mig_rate, st.lnld_sum, st.lnp_sum))
    totals = StepStats(*(torch.stack(f).sum(dim=0) for f in zip(*stats)))
    trace = ChunkTrace(*(torch.stack(f) for f in zip(*rows)))
    return gen, params, lrng, grng, lnld, lnp, cond, totals, trace
