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

On a loci mesh the paired update pairs within each rank's block, as
gphocs_tpu's shard_map does, and all-reduces its counts; the serial
sweep scans the ranks' blocks in rank order, each rank handing the
reference locus's carry to the next with one broadcast (W per sweep), so
that it gives the one-process sweep's bits on the padded loci.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.kernels.common import maybe_psum, per_chain
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


def _pair_lnld(gen: GenState, seq: SeqData, ref_gen: GenState,
               ref_seq: SeqData, gi: torch.Tensor, rnew: torch.Tensor,
               rrefnew: torch.Tensor) -> torch.Tensor:
    """Data log-likelihood of the loci gi ([C], one per chain) and of
    their chains' reference loci (ref_gen, ref_seq: [C] rows), with
    their rates replaced by rnew and rrefnew (gphocs_tpu's _pair_lnld):
    a full rebuild of the 2C loci, held as pairs (g, ref) chain by
    chain.  Returns [C, 2]."""
    def pairs(a, b):
        return torch.stack([a, b], dim=1).reshape(-1, *a.shape[1:])

    sub = GenState(*(pairs(x[gi], r) for x, r in zip(gen, ref_gen)))
    sub = sub._replace(mut_rate=pairs(rnew, rrefnew))
    sq = SeqData(*(None if x is None else pairs(x[gi], r)
                   for x, r in zip(seq, ref_seq)))
    return full_rebuild_and_lnld(sub, sq)[1].view(-1, 2)


def update_locus_rates(gen: GenState, seq: SeqData, rng, finetune,
                       lnld: torch.Tensor, var_alpha, ref_locus: int = 0,
                       chains: int = 1, loci_axis=None,
                       ref_seq: SeqData = None):
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
    rate_var_delta), the last two [C] for C > 1 chains.

    The scan carries the reference loci's rates and lnld, the accepts
    and the variance delta ([C] each) and writes the reference rows back
    at its end.  On a loci mesh (`loci_axis`, W ranks; the reference
    locus must be 0) rank r holds the loci [r Ls, (r + 1) Ls) of every
    chain, so the global order of the scan is rank 0's block, then rank
    1's, and so on: rank r scans its block once the ranks before it are
    done and then broadcasts the carry (rank 0's broadcast also carries
    the reference loci's genealogy rows, which the update never changes),
    W broadcasts in rank order whatever the data.  `ref_seq` is the
    reference locus's SeqData row ([1, ...] or [C, ...]), which every
    rank holds; rank 0 writes the reference rows back after the last
    broadcast.  Each step's arithmetic is the one-process step's, on the
    same rows and streams, so W ranks give the bits of one process
    running the padded loci; the counts and the variance delta (divided
    by the padded loci of a chain, W Ls) are global on every rank."""
    from gphocs_tpu_torch.parallel.mesh import broadcast

    K = gen.num_loci
    Ls = K // chains                                  # loci of one block
    W, rank = ((1, 0) if loci_axis is None
               else (loci_axis.world, loci_axis.rank))
    if loci_axis is not None and ref_locus != 0:
        raise ValueError("a loci mesh takes the reference locus 0")
    dt = lnld.dtype
    dev = lnld.device
    first = torch.arange(0, K, Ls, device=dev)        # [C]
    zero = torch.zeros((), dtype=dt, device=dev)
    n_loci = torch.full((), Ls * W, dtype=dt, device=dev)
    ri = first + ref_locus
    # the carry: the reference rows, their rate and lnld, the accepts and
    # the variance delta; off rank 0, placeholders of their shapes
    ref_gen = GenState(*(x[ri] for x in gen))
    if ref_seq is None:
        ref_seq = SeqData(*(None if x is None else x[ri] for x in seq))
    ref_seq = SeqData(*(None if x is None else x.expand(
        len(first), *x.shape[1:]) for x in ref_seq))
    rref, lnld_ref = gen.mut_rate[ri], lnld[ri]
    acc = torch.zeros(first.shape, dtype=torch.int64, device=dev)
    dvar = torch.zeros(first.shape, dtype=dt, device=dev)
    rate = gen.mut_rate
    for src in range(W):
        if src == rank:
            for g in range(Ls):
                if rank == 0 and g == ref_locus:  # draws nothing, never moves
                    continue
                gi = first + g
                active = gen.valid[gi]
                rold = rate[gi]
                lanes = torch.zeros((K,), dtype=torch.bool, device=dev)
                lanes[gi] = active
                z, rng = R.rnd2normal8(rng, lanes, dt)
                rnew = reflect(rold + finetune * z[gi], zero, rold + rref)
                rrefnew = rref + rold - rnew
                new_pair = _pair_lnld(gen, seq, ref_gen, ref_seq, gi, rnew,
                                      rrefnew)
                dlnld = ((new_pair[:, 0] - lnld[gi])
                         + (new_pair[:, 1] - lnld_ref))
                lnacc = ((var_alpha - 1.0)
                         * torch.log((rnew * rrefnew) / (rold * rref))
                         + dlnld)
                lanes = torch.zeros((K,), dtype=torch.bool, device=dev)
                lanes[gi] = active & (lnacc < 0.0)
                u, rng = R.rndu(rng, lanes, dt)
                accept = active & ((lnacc >= 0.0)
                                   | (u[gi] < torch.exp(torch.clamp(
                                       lnacc, max=0.0))))
                rate = rate.index_put((gi,), torch.where(accept, rnew,
                                                         rold))
                lnld = lnld.index_put((gi,), torch.where(
                    accept, new_pair[:, 0], lnld[gi]))
                dvar = dvar + torch.where(
                    accept,
                    (rnew ** 2 + rrefnew ** 2 - rold ** 2 - rref ** 2)
                    / n_loci, zero)
                rref = torch.where(accept, rrefnew, rref)
                lnld_ref = torch.where(accept, new_pair[:, 1], lnld_ref)
                acc = acc + accept.to(torch.int64)
        if loci_axis is not None:
            carry = [rref, lnld_ref, acc, dvar]
            if src == 0:
                carry += list(ref_gen)
            carry = broadcast(loci_axis, carry, src)
            rref, lnld_ref, acc, dvar = carry[:4]
            if src == 0:
                ref_gen = GenState(*carry[4:])
    if rank == 0:
        rate = rate.index_put((ri,), rref)
        lnld = lnld.index_put((ri,), lnld_ref)
    if chains == 1:
        acc, dvar = acc[0], dvar[0]
    return gen._replace(mut_rate=rate), rng, lnld, acc, dvar
