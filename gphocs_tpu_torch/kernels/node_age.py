"""UpdateGB_InternalNode: random-walk updates of coalescent-node ages
(twin of gphocs_tpu/kernels/node_age.py).

This is the plain PyTorch version of the node-age kernel
(csrc/node_age.cu): ops/sweeps.node_age_sweep calls it for CPU tensors,
and the tests hold the kernel against it.  With the Wichmann-Hill streams
of the conformance mode it is the sweep itself, on any device
(ops/sweeps.node_age_sweep_plain): the kernel implements the counter
streams only.

Per node per locus (reference src/GPhoCS.c:2287-2428):
  bounds  tb0 = max(pop age, per-son last-mig-age-or-son-age)
          tb1 = min(father-pop age | OLDAGE,
                    first-mig-age | father age (unless locus root))
  tnew    = reflect(t + finetune * rnd2normal8, tb0, tb1)
  lnacc   = [lnP(G') - lnP(G)] + [lnld'(X) - lnld(X)]
  a |tnew - t| < 1e-15 proposal is counted accepted without moving.
Fast streams: 4 draws per node step, 3 for the proposal and 1 for the MH
uniform.  Wichmann-Hill streams, as gphocs_tpu draws them: the proposal on
the valid loci, the uniform on the valid loci whose move is not tiny and
whose lnacc < 0.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng as R
from gphocs_tpu_torch.kernels.common import (Context, band_windows,
                                             chain_count, draw_accept,
                                             first_mig_above, last_mig_below,
                                             per_chain, take)
from gphocs_tpu_torch.ops.coalstats import node_age_move_delta
from gphocs_tpu_torch.ops.likelihood_cache import refresh_and_lnld
from gphocs_tpu_torch.state import GenState, Params, SeqData
from gphocs_tpu_torch.utils import reflect


def update_internal_node_ages(gen: GenState, params: Params, seq: SeqData,
                              rng, ctx: Context, finetune,
                              lnld: torch.Tensor, lnp: torch.Tensor,
                              cond: torch.Tensor, record=None):
    """One full sweep over all internal nodes.  Returns
    (gen, rng, lnld, lnp, cond, accepted_count); for C chains (chain-major
    loci, [C, P] parameters, a counter per chain) the count is [C].  A
    list given as `record` receives one dict per node step with the step's
    state, proposal and decision (tools/node_age_probe.py)."""
    L = gen.num_loci
    S = gen.num_samples
    N = gen.num_nodes
    dt = gen.age.dtype
    dev = gen.age.device
    ar = torch.arange(L, device=dev)
    loci_mask = gen.valid
    bstart, bend = band_windows(ctx, params.tau)
    inf = torch.full((L,), float("inf"), dtype=dt, device=dev)
    acc = torch.zeros(params.theta.shape[:-1], dtype=torch.int64,
                      device=dev)
    C = chain_count(params)

    for inode in range(S, N):
        t = gen.age[:, inode]
        pop = gen.node_pop[:, inode]
        tb0 = take(params.tau, pop)
        tb1 = torch.where(pop == ctx.root_pop,
                          torch.full_like(t, ctx.oldage),
                          take(params.tau, ctx.father_pop[pop]))
        node_vec = torch.full((L,), inode, dtype=torch.int64, device=dev)
        fm = first_mig_above(gen, node_vec, -inf)
        is_root = gen.root == inode
        fa = gen.father[:, inode]
        fa_age = gen.age[ar, fa.clamp(min=0)]
        upper2 = torch.where(torch.isfinite(fm), fm,
                             torch.where(is_root, inf, fa_age))
        tb1 = torch.minimum(tb1, upper2)
        for son in (gen.lson[:, inode], gen.rson[:, inode]):
            lm = last_mig_below(gen, son, inf)
            tb0 = torch.maximum(tb0, torch.where(torch.isfinite(lm), lm,
                                                 gen.age[ar, son]))

        z, rng = R.rnd2normal8(rng, loci_mask, dt)
        tnew = reflect(t + finetune * z, tb0, tb1)
        tiny = torch.abs(tnew - t) < 1e-15

        age_prop = gen.age.clone()
        age_prop[:, inode] = tnew
        gen_prop = gen._replace(age=age_prop)
        dirty0 = torch.zeros((N,), dtype=torch.bool, device=dev)
        dirty0[inode] = True
        cond_prop, lnld_prop = refresh_and_lnld(cond, gen_prop, seq, dirty0)
        dlnp = node_age_move_delta(gen, params, ctx, node_vec, tnew,
                                   bstart, bend)
        lnp_prop = lnp + dlnp
        lnacc = dlnp + (lnld_prop - lnld)

        accept, u, rng = draw_accept(rng, lnacc, loci_mask & ~tiny)
        if record is not None:
            record.append(dict(gen=gen, node=inode, tnew=tnew, dlnp=dlnp,
                               lnld=lnld, lnld_prop=lnld_prop,
                               cond_prop=cond_prop, u=u, lnacc=lnacc,
                               accept=accept))
        age = gen.age.clone()
        age[:, inode] = torch.where(accept, tnew, t)
        gen = gen._replace(age=age)
        cond = torch.where(accept[:, None, None, None], cond_prop, cond)
        lnld = torch.where(accept, lnld_prop, lnld)
        lnp = torch.where(accept, lnp_prop, lnp)
        acc = acc + per_chain((accept | tiny) & loci_mask, C)
    return gen, rng, lnld, lnp, cond, acc
