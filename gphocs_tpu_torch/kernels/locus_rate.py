"""UpdateLocusRate for `locus-mut-rate VAR`: per-locus relative mutation
rates (twin of gphocs_tpu/kernels/locus_rate.py): the fast-RNG
iteration's update in random disjoint pairs (update_locus_rates_paired),
and the conformance mode's serial, reference-coupled sweep
(update_locus_rates).

The rates live on the simplex sum r = L.  Each call draws a random perfect
matching of the loci; every pair proposes one transfer of rate mass between
its members, which keeps the sum exactly; the acceptances are independent
because no locus is in two pairs:

    rnew_lo = reflect(r_lo + finetune * rnd2normal8, 0, r_lo + r_hi)
    rnew_hi = r_lo + r_hi - rnew_lo
    lnacc   = (alpha - 1) * log((rnew_lo * rnew_hi) / (r_lo * r_hi))
            + dlnld(lo) + dlnld(hi)

One full rebuild of the conditionals evaluates all proposed likelihoods.
Plain tensor code, as it is XLA code in the JAX package.

Three draws come from the per-locus streams, in this order and for every
lane whatever the masks: rndu (the matching), rnd2normal8 (the proposal),
rndu (the accept).  The counter advances by 5.

C chains (chain-major loci, a counter per chain): every chain matches its
own loci and keeps its own simplex; the counts and variance deltas are
[C].
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.kernels.common import maybe_psum, per_chain, rows
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.state import GenState, SeqData
from gphocs_tpu_torch.utils import reflect


def update_locus_rates_paired(gen: GenState, seq: SeqData, rng, finetune,
                              lnld: torch.Tensor, var_alpha, cond,
                              loci_axis=None):
    """Returns (gen, rng, lnld, cond, accepted, rate_var_delta); accepted
    counts loci (both members of an accepted pair).  On a loci mesh
    (`loci_axis`) the pairs form within each rank's block, as under
    gphocs_tpu's shard_map (each pair keeps its sum, so the global mean
    stays 1), and the count and the variance delta add up over the ranks,
    with the global L in the denominator."""
    C = None if rng.ctr.dim() == 0 else rng.ctr.shape[0]
    L = gen.num_loci // (C or 1)                      # loci of one chain
    dt = lnld.dtype
    dev = lnld.device

    # random perfect matching of each chain's loci: rank them by a uniform
    # each; rank 2m pairs with rank 2m+1 (odd L: the last-ranked locus sits
    # out).  The sort is stable, as jnp.argsort is: equal uniforms keep
    # locus order.  Ranks and ids are a chain's own, [C or 1, L].
    u_perm, rng = RF.rndu(rng, dt)
    order = torch.argsort(u_perm.view(-1, L), dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)   # rank of each locus
    is_lo = (rank % 2 == 0).view(-1)                  # proposer of the pair
    mate_rank = torch.where(rank % 2 == 0, rank + 1, rank - 1)
    mate = torch.gather(order, 1, mate_rank.clamp(0, L - 1))
    first = torch.arange(0, gen.num_loci, L, device=dev)[:, None]
    paired = ((mate_rank < L) & (mate != torch.arange(L, device=dev))
              ).view(-1)
    mate = (mate + first).view(-1)                    # partner's locus id
    paired = paired & gen.valid & gen.valid[mate]

    r = gen.mut_rate.to(dt)
    r_mate = r[mate]
    z, rng = RF.rnd2normal8(rng, dt)
    # the lower-ranked member proposes; both members see mirrored values
    z_pair = torch.where(is_lo, z, z[mate])
    r_lo = torch.where(is_lo, r, r_mate)
    total = r + r_mate
    rnew_lo = reflect(r_lo + finetune * z_pair, torch.zeros((), dtype=dt,
                                                            device=dev),
                      total)
    rnew = torch.where(is_lo, rnew_lo, total - rnew_lo)
    rnew = torch.where(paired, rnew, r)

    cond_prop, lnld_prop = full_rebuild_and_lnld(
        gen._replace(mut_rate=rnew), seq)
    dlnld = lnld_prop - lnld
    # the 1e-300 floor is gphocs_tpu's; at f32 it rounds to 0 there and here
    lnacc = ((var_alpha - 1.0)
             * torch.log((rnew * rnew[mate])
                         / torch.clamp(r * r_mate, min=1e-300))
             + dlnld + dlnld[mate])

    # one uniform per pair: both members read the proposer's draw
    u, rng = RF.rndu(rng, dt)
    u_pair = torch.where(is_lo, u, u[mate])
    accept = paired & ((lnacc >= 0.0)
                       | (u_pair < torch.exp(lnacc.clamp(max=0.0))))

    gen = gen._replace(mut_rate=torch.where(accept, rnew, gen.mut_rate))
    lnld = torch.where(accept, lnld_prop, lnld)
    cond = torch.where(accept[:, None, None, None], cond_prop, cond)
    # (a sum of bools is int64)
    acc, dvar = maybe_psum([per_chain(accept, C), per_chain(
        torch.where(accept, rnew ** 2 - r ** 2, torch.zeros_like(r)), C)],
        loci_axis)
    L_total = L if loci_axis is None else L * loci_axis.world
    return gen, rng, lnld, cond, acc, dvar / L_total


def _pair_lnld(gen: GenState, seq: SeqData, idx: torch.Tensor,
               rates: torch.Tensor) -> torch.Tensor:
    """Data log-likelihood of the loci `idx` with their rates replaced by
    `rates` (gphocs_tpu's _pair_lnld): a full rebuild of those loci."""
    sub = GenState(*(x[idx] for x in gen))._replace(mut_rate=rates)
    sq = SeqData(*(None if x is None else x[idx] for x in seq))
    return full_rebuild_and_lnld(sub, sq)[1]


def update_locus_rates(gen: GenState, seq: SeqData, rng, finetune,
                       lnld: torch.Tensor, var_alpha, ref_locus: int = 0,
                       chains: int = 1):
    """The serial sweep of the conformance mode (reference
    src/GPhoCS.c:4598-4674; gphocs_tpu's update_locus_rates) on the
    Wichmann-Hill streams: every locus g but the reference locus, in
    order, moves its rate against the reference locus's, preserving the
    mean,

        rnew    = reflect(rold + finetune * rnd2normal8(g), 0, rold + rref)
        rrefnew = rref + rold - rnew
        lnacc   = (alpha - 1) * log((rnew * rrefnew) / (rold * rref))
                + dlnld(g) + dlnld(ref)

    with the draws on locus g's own stream (the uniform only where lnacc
    < 0) and the two loci's likelihoods rebuilt.  The carried
    conditionals are left to the caller, which rebuilds them all after
    the sweep.  `chains` C: the state holds C chains' loci chain-major,
    and step g moves locus g of every chain against that chain's
    reference locus (rows c L + g and c L + ref), each chain drawing and
    deciding on its own.  Returns (gen, rng, lnld, accepted,
    rate_var_delta), the last two [C] for C > 1 chains."""
    K = gen.num_loci
    L = K // chains                                   # loci of one chain
    dt = lnld.dtype
    dev = lnld.device
    first = torch.arange(0, K, L, device=dev)         # [C]
    zero = torch.zeros((), dtype=dt, device=dev)
    n_loci = torch.full((), L, dtype=dt, device=dev)
    acc = torch.zeros(first.shape, dtype=torch.int64, device=dev)
    dvar = torch.zeros(first.shape, dtype=dt, device=dev)
    rate = gen.mut_rate
    ri = first + ref_locus
    for g in range(L):
        if g == ref_locus:  # it draws nothing and never moves
            continue
        gi = first + g
        active = gen.valid[gi]
        rold, rref = rate[gi], rate[ri]
        lanes = torch.zeros((K,), dtype=torch.bool, device=dev)
        lanes[gi] = active
        z, rng = R.rnd2normal8(rng, lanes, dt)
        rnew = reflect(rold + finetune * z[gi], zero, rold + rref)
        rrefnew = rref + rold - rnew
        new_pair = _pair_lnld(gen, seq, torch.stack([gi, ri], dim=1).view(-1),
                              torch.stack([rnew, rrefnew], dim=1).view(-1)
                              ).view(-1, 2)
        dlnld = ((new_pair[:, 0] - lnld[gi])
                 + (new_pair[:, 1] - lnld[ri]))
        lnacc = ((var_alpha - 1.0)
                 * torch.log((rnew * rrefnew) / (rold * rref)) + dlnld)
        lanes = torch.zeros((K,), dtype=torch.bool, device=dev)
        lanes[gi] = active & (lnacc < 0.0)
        u, rng = R.rndu(rng, lanes, dt)
        accept = active & ((lnacc >= 0.0)
                           | (u[gi] < torch.exp(torch.clamp(lnacc,
                                                            max=0.0))))
        on = rows(accept, K, 0)                       # each locus's chain's
        moved = rate.clone()
        moved[gi], moved[ri] = rnew, rrefnew
        rate = torch.where(on, moved, rate)
        moved = lnld.clone()
        moved[gi], moved[ri] = new_pair[:, 0], new_pair[:, 1]
        lnld = torch.where(on, moved, lnld)
        acc = acc + accept.to(torch.int64)
        dvar = dvar + torch.where(
            accept,
            (rnew ** 2 + rrefnew ** 2 - rold ** 2 - rref ** 2) / n_loci,
            zero)
    if chains == 1:
        acc, dvar = acc[0], dvar[0]
    return gen._replace(mut_rate=rate), rng, lnld, acc, dvar
