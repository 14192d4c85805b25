"""The MCMC iteration over pattern buckets (twin of
gphocs_tpu/sampler/bucketed.py and, for one bucket, of
gphocs_tpu/sampler/step.py's mcmc_iteration; no jit and no scan).

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
    proposal per current pop with an estimated sample age], [the
    admixture coefficients], [mixing]:
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

On a loci mesh (`loci_axis`, a parallel/mesh.LociMesh) every bucket holds
this rank's block of its loci and the sweeps run on it; the reductions
across loci are all-reduces at the places of gphocs_tpu's maybe_psum /
maybe_pmax: theta's and the migration rates' totals, one per rubber-band
proposal, the admixture counts, mixing's event counts and data delta,
the paired rate update's count and variance, SPR's counter advance, and
at the end of the iteration one for its statistics (accepts of the
sweeps, migrations, lnld and lnp sums).  Every rank makes them all, in
the same order.

The conformance mode (`legacy`: the Wichmann-Hill streams, one bucket)
runs gphocs_tpu's mcmc_iteration with use_fused=False: the node-age,
migration-age and SPR sweeps are their plain versions on the state's
device (ops/sweeps.*_plain; the kernels implement the counter streams
only), the rate update is the serial, reference-coupled sweep, followed
by a full rebuild of the conditionals, and the rubber band keeps
launching its kernel (it draws nothing).  Every other move is the same
code, drawing from the general stream in sequence.  With C chains
(gphocs_tpu vmaps its legacy chunk) the per-locus streams are chain-major
[C * L] and the general streams [C, 1]: a lane draws only where its own
chain's move asks for it, so no chain's draws depend on another's, and
the loops run over populations, bands, loci of one chain and walk trips,
never over the chains.  On a loci mesh the legacy sweeps run on the
rank's block with no collective: a Wichmann-Hill lane draws only where
its own locus asks (SPR's trips synchronize within the block, which
changes no lane's draws), the rate update hands its carry from rank to
rank (kernels/locus_rate.py; `ref_seq` is the reference locus's data
row), the global moves make the all-reduces of the fast mode, and the
iteration's lnld and lnp sums come from the gathered loci, added in one
process's order, so that the trace has the one-process run's bits.

Admixed leaves (one bucket, as in gphocs_tpu, which refuses them with
buckets): SPR resamples their populations, the prior carries their terms,
and the coefficients move after the sample ages.  A chunk also adds up,
on the device, how often each admixed leaf of each locus sat in its
second population (for admixture-trace.out).

While a torch.profiler runs, the chunk's iterations are `profiling.span`s
named iteration, and inside each every update sits in a span of its
family's name: node_age, mig_age, spr, locus_rate and the prior refresh
(full_stats) per bucket and genetree sample, then full_stats, theta,
mig_rate, tau, sample_age, admix, mixing and the closing sums; the
chunk's stacking of its totals and trace rows is chunk_totals.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from gphocs_tpu_torch.kernels.admix import (in_second_pop,
                                            update_admix_coeffs)
from gphocs_tpu_torch.kernels.common import (chain_count, full_stats,
                                             gen_log_prior,
                                             gen_log_prior_from_stats,
                                             maybe_psum)
from gphocs_tpu_torch.kernels.locus_rate import (update_locus_rates,
                                                 update_locus_rates_paired)
from gphocs_tpu_torch.kernels.mixing import update_mixing_buckets
from gphocs_tpu_torch.kernels.scalar_params import (update_mig_rates,
                                                    update_thetas)
from gphocs_tpu_torch.kernels.tau import (update_sample_ages_buckets,
                                          update_taus_buckets)
from gphocs_tpu_torch.ops import sweeps
from gphocs_tpu_torch.ops.coalstats import CoalStats
from gphocs_tpu_torch.ops.likelihood_cache import full_build
from gphocs_tpu_torch.parallel.mesh import gather_rows
from gphocs_tpu_torch.profiling import span
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
                           var_alpha: float = 1.0, loci_axis=None,
                           legacy: bool = False, ref_seq=None):
    """One iteration over the buckets.  `gens`, `seqs`, `lrngs`, `lnlds`,
    `lnps`, `conds` hold one entry per bucket.  Returns (gens, params,
    lrngs, grng, lnlds, lnps, conds, StepStats) with lists.

    sample_age_mask: per current pop, whether its sample age is estimated.
    var_rates: `locus-mut-rate VAR` (var_alpha is its Dirichlet alpha); the
    paired rate update runs within each bucket.  The *_on flags skip an
    update whose finetune is 0.  legacy: the conformance mode's
    schedule (the module's docstring) for Wichmann-Hill streams;
    ref_seq: its rate update's reference locus's data row (on a loci
    mesh; None: the bucket's own row).

    conds: carried pruning conditionals, consistent with (gens, seqs) on
    entry and on return."""
    K = len(gens)
    if legacy and K > 1:
        raise ValueError("the conformance mode runs one bucket")
    if legacy:
        node_age, mig_age, spr = (sweeps.node_age_sweep_plain,
                                  sweeps.mig_age_sweep_plain,
                                  sweeps.spr_sweep_plain)
    else:
        node_age, mig_age, spr = (
            sweeps.node_age_sweep, sweeps.mig_age_sweep,
            functools.partial(sweeps.spr_sweep, loci_axis=loci_axis))
    if K > 1 and ctx.num_admixed > 0:
        raise ValueError("admixture requires one pattern bucket (as in "
                         "gphocs_tpu)")
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
                with span("node_age"):
                    g, r, lnlds[k], lnps[k], conds[k], a = node_age(
                        g, params, sq, r, ctx, ft.coal_time, lnlds[k],
                        lnps[k], conds[k])
                    acc_ct = acc_ct + a
            if mig_time_on and ctx.num_bands > 0:
                with span("mig_age"):
                    g, r, lnps[k], a = mig_age(g, params, r, ctx,
                                               ft.mig_time, lnps[k])
                    acc_mt = acc_mt + a
            with span("spr"):
                g, r, lnlds[k], conds[k], a = spr(g, params, sq, r, ctx,
                                                  lnlds[k], conds[k])
                acc_spr = acc_spr + a
            # SPR tracks only the data likelihood; the prior refresh of the
            # last genetree sample is merged into the full_stats pass below
            if gs < genetree_samples - 1:
                with span("full_stats"):
                    lnps[k] = gen_log_prior(g, params, ctx)
            if var_rates and locus_rate_on:
                with span("locus_rate"):
                    if legacy:
                        g, r, lnlds[k], a, dv = update_locus_rates(
                            g, sq, r, ft.locus_rate, lnlds[k], var_alpha,
                            chains=C or 1, loci_axis=loci_axis,
                            ref_seq=ref_seq)
                        # rate moves change edge lengths everywhere:
                        # rebuild
                        conds[k] = full_build(g, sq)
                    else:
                        g, r, lnlds[k], conds[k], a, dv = \
                            update_locus_rates_paired(
                                g, sq, r, ft.locus_rate, lnlds[k],
                                var_alpha, conds[k], loci_axis)
                    acc_lr = acc_lr + a
                    dvar = dvar + dv
            gens[k], lrngs[k] = g, r

    with span("full_stats"):
        stats_list = [full_stats(g, params, ctx) for g in gens]
        lnps = [gen_log_prior_from_stats(st, g, params, ctx)
                for st, g in zip(stats_list, gens)]
        # theta and the migration rates read the totals over all loci
        stats = CoalStats(*(_cat(f) for f in zip(*stats_list)))
        lnp = _cat(lnps)
    acc_th = acc_mr = zero
    if theta_on:
        with span("theta"):
            params, grng, lnp, acc_th = update_thetas(
                gens[0], params, grng, ctx, ft.theta, lnp, stats, loci_axis)
    if do_migrate and mig_rate_on and ctx.num_bands > 0:
        with span("mig_rate"):
            params, grng, lnp, acc_mr = update_mig_rates(
                gens[0], params, grng, ctx, ft.mig_rate, lnp, stats,
                loci_axis)
    with span("tau"):
        lnps = _split(lnp, [g.num_loci for g in gens])
        gens, params, grng, lnlds, lnps, conds, acc_taus, conflicts = \
            update_taus_buckets(gens, params, seqs, grng, ctx, ft.taus,
                                lnlds, lnps, conds, num_pops, num_cur_pops,
                                loci_axis)
    if any(sample_age_mask):
        with span("sample_age"):
            gens, params, grng, lnlds, lnps, conds, acc_sa, conf_sa = \
                update_sample_ages_buckets(gens, params, seqs, grng, ctx,
                                           ft.taus, lnlds, lnps, conds,
                                           num_cur_pops, sample_age_mask,
                                           loci_axis)
            acc_taus = acc_taus + acc_sa
            conflicts = conflicts + conf_sa
    acc_adm = zero
    if ctx.num_admixed > 0:
        with span("admix"):
            params, grng, lnp0, acc_adm = update_admix_coeffs(
                gens[0], params, grng, ctx, ft.admix, lnps[0], loci_axis)
            lnps = [lnp0]
    acc_mix = zero
    if do_mixing and mixing_on:
        # mixing reads only event counts, which theta/mig-rate/tau moves
        # never change, so the stats pass above is reusable as-is
        with span("mixing"):
            gens, params, grng, lnlds, lnps, conds, acc_mix = \
                update_mixing_buckets(gens, params, seqs, grng, ctx,
                                      ft.mixing, lnlds, lnps, conds,
                                      stats_list, num_cur_pops, loci_axis)

    def total(x):  # over a bucket's loci (and slots), or per chain
        return x.sum() if C is None else x.reshape(C, -1).sum(dim=1)

    with span("sums"):
        # the sweeps' accepts and the sums over loci are the rank's own on
        # a loci mesh; the counts of the global moves (and the rate
        # update's, reduced or handed on where it ran) are every rank's
        # already
        if legacy and loci_axis is not None:
            # the conformance mode's lnld and lnp sums add in one process's
            # order: every rank sums the gathered [C * Lp] loci on its
            # device
            both = gather_rows(loci_axis,
                               torch.stack([lnlds[0], lnps[0]], 1),
                               C or 1).to(dev)
            lnld_sum, lnp_sum = (total(both[:, j].contiguous())
                                 for j in (0, 1))
            acc_ct, acc_mt, acc_spr, num_migs = maybe_psum(
                [acc_ct, acc_mt, acc_spr, total(gens[0].mig_branch >= 0)],
                loci_axis)
        else:
            acc_ct, acc_mt, acc_spr, num_migs, lnld_sum, lnp_sum = \
                maybe_psum([acc_ct, acc_mt, acc_spr,
                            sum(total(g.mig_branch >= 0) for g in gens),
                            sum(total(x) for x in lnlds),
                            sum(total(x) for x in lnps)], loci_axis)
        out = StepStats(
            acc_coal_time=acc_ct, acc_mig_time=acc_mt, acc_spr=acc_spr,
            acc_theta=acc_th, acc_mig_rate=acc_mr, acc_taus=acc_taus,
            acc_mixing=acc_mix, acc_locus_rate=acc_lr, rate_var_delta=dvar,
            tau_conflicts=conflicts, num_migs_total=num_migs,
            lnld_sum=lnld_sum, lnp_sum=lnp_sum, acc_admix=acc_adm)
    return gens, params, lrngs, grng, lnlds, lnps, conds, out


def mcmc_chunk_buckets(gens, params, seqs, lrngs, grng, lnlds, lnps, conds,
                       ft: Finetunes, *, ctx, n_iters: int, **flags):
    """Run n_iters iterations.  Returns (gens, params, lrngs, grng, lnlds,
    lnps, conds, totals: StepStats summed over the chunk, ChunkTrace,
    in2): in2 [L, A] int64 counts, for each admixed leaf of each valid
    locus, the iterations that ended with it in its second population
    (None without admixed leaves)."""
    stats, rows = [], []
    in2 = None
    for _ in range(n_iters):
        with span("iteration"):
            gens, params, lrngs, grng, lnlds, lnps, conds, st = \
                mcmc_iteration_buckets(gens, params, seqs, lrngs, grng,
                                       lnlds, lnps, conds, ft, ctx=ctx,
                                       **flags)
        stats.append(st)
        rows.append((params.theta, params.tau, params.sample_age,
                     params.mig_rate, st.lnld_sum, st.lnp_sum,
                     st.rate_var_delta, params.admix_coeff))
        if ctx.num_admixed > 0:
            x = in_second_pop(gens[0], ctx).to(torch.int64)
            in2 = x if in2 is None else in2 + x
    with span("chunk_totals"):
        totals = StepStats(*(torch.stack(f).sum(dim=0)
                             for f in zip(*stats)))
        trace = ChunkTrace(*(torch.stack(f) for f in zip(*rows)))
    return gens, params, lrngs, grng, lnlds, lnps, conds, totals, trace, in2
