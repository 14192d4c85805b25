"""The MCMC iteration over pattern buckets (twin of
gphocs_tpu/sampler/bucketed.py, fast RNG, no jit and no scan).

Ragged loci padded to the largest pattern count cost memory and sweep work
in proportion to L * P_max.  Sorted by phased-pattern count and split into
a few contiguous buckets (io/sequences.build_seq_data_buckets), each
bucket pads only to its own largest count.  An unbucketed state is one
bucket: the sampler always holds its per-locus state as sequences with one
entry per bucket.

Update schedule (reference performMCMC, src/GPhoCS.c:1476-1705):

    repeat genetreeSamples times, for every bucket:
        node-age sweep; migration-age sweep; SPR sweep;
        [paired locus-rate update if VAR rates]
    full_stats per bucket; theta and [migration rates if iteration >
    start-mig] on the concatenated statistics;
    one tau rubber-band proposal per ancestral pop, [one sample-age
    proposal per current pop with an estimated sample age], [mixing]:
    each proposed once from the general stream, evaluated per bucket,
    accepted once for all buckets (the reference's one global decision)

The sweeps go through the kernel wrappers of ops/sweeps.py for every
bucket: on CUDA tensors each bucket launches the four kernels at its own
pattern count, on CPU tensors they run their plain versions.  The JAX
package's bucketed mode takes its XLA twins for the migration-age sweep
and the rubber band, which the plain versions equal, so the CPU path
compares draw for draw.  Each bucket keeps its loci's own streams.
Everything stays on the sampler's device: accept counts are 0-d tensors,
and the host reads them once per chunk.

C chains (one bucket of chain-major loci, [C, P] parameters, a counter per
chain; sampler/driver.py) run through the same code with no loop over the
chains: every move is drawn, decided and counted per chain, the totals and
trace entries get a chain axis ([C], [C, P]), and each sweep kernel is
launched once for all chains.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gphocs_tpu_torch.kernels.common import (chain_count, full_stats,
                                             gen_log_prior,
                                             gen_log_prior_from_stats)
from gphocs_tpu_torch.kernels.locus_rate import update_locus_rates_paired
from gphocs_tpu_torch.kernels.mixing import update_mixing_buckets
from gphocs_tpu_torch.kernels.scalar_params import (update_mig_rates,
                                                    update_thetas)
from gphocs_tpu_torch.kernels.tau import (update_sample_ages_buckets,
                                          update_taus_buckets)
from gphocs_tpu_torch.ops.coalstats import CoalStats
from gphocs_tpu_torch.ops.sweeps import (mig_age_sweep, node_age_sweep,
                                         spr_sweep)
from gphocs_tpu_torch.sampler.step import ChunkTrace, Finetunes, StepStats


def _cat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return xs[0] if len(xs) == 1 else torch.cat(list(xs))


def _split(x: torch.Tensor, sizes) -> list:
    return [x] if len(sizes) == 1 else list(torch.split(x, list(sizes)))


def mcmc_iteration_buckets(gens, params, seqs, lrngs, grng, lnlds, lnps,
                           conds, ft: Finetunes, *, ctx, genetree_samples: int,
                           do_migrate: bool, do_mixing: bool, num_pops: int,
                           num_cur_pops: int, sample_age_mask: tuple = (),
                           coal_time_on: bool = True, mig_time_on: bool = True,
                           theta_on: bool = True, mig_rate_on: bool = True,
                           mixing_on: bool = True, var_rates: bool = False,
                           locus_rate_on: bool = True,
                           var_alpha: float = 1.0):
    """One iteration over the buckets.  `gens`, `seqs`, `lrngs`, `lnlds`,
    `lnps`, `conds` hold one entry per bucket.  Returns (gens, params,
    lrngs, grng, lnlds, lnps, conds, StepStats) with lists.

    sample_age_mask: per current pop, whether its sample age is estimated.
    var_rates: `locus-mut-rate VAR` (var_alpha is its Dirichlet alpha); the
    paired rate update runs within each bucket.  The *_on flags skip an
    update whose finetune is 0.

    conds: carried pruning conditionals, consistent with (gens, seqs) on
    entry and on return."""
    K = len(gens)
    gens, lrngs = list(gens), list(lrngs)
    lnlds, lnps, conds = list(lnlds), list(lnps), list(conds)
    dev = lnlds[0].device
    C = chain_count(params)
    ch = params.theta.shape[:-1]         # () for one chain, (C,) for C
    zero = torch.zeros(ch, dtype=torch.int64, device=dev)
    acc_ct = acc_mt = acc_spr = acc_lr = zero
    dvar = torch.zeros(ch, dtype=lnlds[0].dtype, device=dev)
    for gs in range(genetree_samples):
        for k in range(K):
            g, sq, r = gens[k], seqs[k], lrngs[k]
            if coal_time_on:
                g, r, lnlds[k], lnps[k], conds[k], a = node_age_sweep(
                    g, params, sq, r, ctx, ft.coal_time, lnlds[k], lnps[k],
                    conds[k])
                acc_ct = acc_ct + a
            if mig_time_on and ctx.num_bands > 0:
                g, r, lnps[k], a = mig_age_sweep(g, params, r, ctx,
                                                 ft.mig_time, lnps[k])
                acc_mt = acc_mt + a
            g, r, lnlds[k], conds[k], a = spr_sweep(g, params, sq, r, ctx,
                                                    lnlds[k], conds[k])
            acc_spr = acc_spr + a
            # SPR tracks only the data likelihood; the prior refresh of the
            # last genetree sample is merged into the full_stats pass below
            if gs < genetree_samples - 1:
                lnps[k] = gen_log_prior(g, params, ctx)
            if var_rates and locus_rate_on:
                g, r, lnlds[k], conds[k], a, dv = update_locus_rates_paired(
                    g, sq, r, ft.locus_rate, lnlds[k], var_alpha, conds[k])
                acc_lr = acc_lr + a
                dvar = dvar + dv
            gens[k], lrngs[k] = g, r

    stats_list = [full_stats(g, params, ctx) for g in gens]
    lnps = [gen_log_prior_from_stats(st, g, params, ctx)
            for st, g in zip(stats_list, gens)]
    # theta and the migration rates read the totals over all loci
    stats = CoalStats(*(_cat(f) for f in zip(*stats_list)))
    lnp = _cat(lnps)
    acc_th = acc_mr = zero
    if theta_on:
        params, grng, lnp, acc_th = update_thetas(
            gens[0], params, grng, ctx, ft.theta, lnp, stats)
    if do_migrate and mig_rate_on and ctx.num_bands > 0:
        params, grng, lnp, acc_mr = update_mig_rates(
            gens[0], params, grng, ctx, ft.mig_rate, lnp, stats)
    lnps = _split(lnp, [g.num_loci for g in gens])
    gens, params, grng, lnlds, lnps, conds, acc_taus, conflicts = \
        update_taus_buckets(gens, params, seqs, grng, ctx, ft.taus, lnlds,
                            lnps, conds, num_pops, num_cur_pops)
    if any(sample_age_mask):
        gens, params, grng, lnlds, lnps, conds, acc_sa, conf_sa = \
            update_sample_ages_buckets(gens, params, seqs, grng, ctx,
                                       ft.taus, lnlds, lnps, conds,
                                       num_cur_pops, sample_age_mask)
        acc_taus = acc_taus + acc_sa
        conflicts = conflicts + conf_sa
    acc_mix = zero
    if do_mixing and mixing_on:
        # mixing reads only event counts, which theta/mig-rate/tau moves
        # never change, so the stats pass above is reusable as-is
        gens, params, grng, lnlds, lnps, conds, acc_mix = \
            update_mixing_buckets(gens, params, seqs, grng, ctx, ft.mixing,
                                  lnlds, lnps, conds, stats_list,
                                  num_cur_pops)

    def total(x):  # over a bucket's loci (and slots), or per chain
        return x.sum() if C is None else x.reshape(C, -1).sum(dim=1)

    out = StepStats(
        acc_coal_time=acc_ct, acc_mig_time=acc_mt, acc_spr=acc_spr,
        acc_theta=acc_th, acc_mig_rate=acc_mr, acc_taus=acc_taus,
        acc_mixing=acc_mix, acc_locus_rate=acc_lr, rate_var_delta=dvar,
        tau_conflicts=conflicts,
        num_migs_total=sum(total(g.mig_branch >= 0) for g in gens),
        lnld_sum=sum(total(x) for x in lnlds),
        lnp_sum=sum(total(x) for x in lnps))
    return gens, params, lrngs, grng, lnlds, lnps, conds, out


def mcmc_chunk_buckets(gens, params, seqs, lrngs, grng, lnlds, lnps, conds,
                       ft: Finetunes, *, ctx, n_iters: int, **flags):
    """Run n_iters iterations.  Returns (gens, params, lrngs, grng, lnlds,
    lnps, conds, totals: StepStats summed over the chunk, ChunkTrace)."""
    stats, rows = [], []
    for _ in range(n_iters):
        gens, params, lrngs, grng, lnlds, lnps, conds, st = \
            mcmc_iteration_buckets(gens, params, seqs, lrngs, grng, lnlds,
                                   lnps, conds, ft, ctx=ctx, **flags)
        stats.append(st)
        rows.append((params.theta, params.tau, params.sample_age,
                     params.mig_rate, st.lnld_sum, st.lnp_sum,
                     st.rate_var_delta))
    totals = StepStats(*(torch.stack(f).sum(dim=0) for f in zip(*stats)))
    trace = ChunkTrace(*(torch.stack(f) for f in zip(*rows)))
    return gens, params, lrngs, grng, lnlds, lnps, conds, totals, trace
