"""UpdateLocusRate for `locus-mut-rate VAR`: per-locus relative mutation
rates, updated in random disjoint pairs (twin of
gphocs_tpu/kernels/locus_rate.update_locus_rates_paired, the fast-RNG
iteration's rate update).

The rates live on the simplex sum r = L.  Each call draws a random perfect
matching of the loci; every pair proposes one transfer of rate mass between
its members, which keeps the sum exactly; the acceptances are independent
because no locus is in two pairs:

    rnew_lo = reflect(r_lo + finetune * rnd2normal8, 0, r_lo + r_hi)
    rnew_hi = r_lo + r_hi - rnew_lo
    lnacc   = (alpha - 1) * log((rnew_lo * rnew_hi) / (r_lo * r_hi))
            + dlnld(lo) + dlnld(hi)

One full rebuild of the conditionals evaluates all proposed likelihoods.
Plain tensor code, as it is XLA code in the JAX package.  The serial,
reference-coupled sweep of the legacy RNG is not ported.

Three draws come from the per-locus streams, in this order and for every
lane whatever the masks: rndu (the matching), rnd2normal8 (the proposal),
rndu (the accept).  The counter advances by 5.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
from gphocs_tpu_torch.state import GenState, SeqData
from gphocs_tpu_torch.utils import reflect


def update_locus_rates_paired(gen: GenState, seq: SeqData, rng, finetune,
                              lnld: torch.Tensor, var_alpha, cond):
    """Returns (gen, rng, lnld, cond, accepted, rate_var_delta); accepted
    counts loci (both members of an accepted pair)."""
    L = gen.num_loci
    dt = lnld.dtype
    dev = lnld.device

    # random perfect matching: rank the loci by a uniform each; rank 2m
    # pairs with rank 2m+1 (odd L: the last-ranked locus sits out).  The
    # sort is stable, as jnp.argsort is: equal uniforms keep locus order.
    u_perm, rng = RF.rndu(rng, dt)
    order = torch.argsort(u_perm, stable=True)        # [L] locus ids by rank
    rank = torch.argsort(order, stable=True)          # rank of each locus
    is_lo = rank % 2 == 0                             # proposer of the pair
    mate_rank = torch.where(is_lo, rank + 1, rank - 1)
    mate = order[mate_rank.clamp(0, L - 1)]           # partner locus id
    paired = ((mate_rank < L) & (mate != torch.arange(L, device=dev))
              & gen.valid & gen.valid[mate])

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
    dvar = torch.where(accept, rnew ** 2 - r ** 2,
                       torch.zeros_like(r)).sum() / L
    return gen, rng, lnld, cond, accept.sum(dtype=torch.int64), dvar
