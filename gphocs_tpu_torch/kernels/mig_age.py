"""UpdateGB_MigrationNode: random-walk updates of migration-event ages
(twin of gphocs_tpu/kernels/mig_age.py, fast-RNG mode).

This is the plain PyTorch version of the migration-age kernel
(csrc/mig_age.cu).  Sequential sweep over migration slots, loci in
parallel; the acceptance ratio is the closed-form genealogy-prior delta
(ops/coalstats.mig_age_move_delta) — the data likelihood does not change.
4 draws per slot: 3 for the proposal, 1 for the MH uniform.
"""

from __future__ import annotations

import torch

from gphocs_tpu_torch import rng_fast as RF
from gphocs_tpu_torch.kernels.common import (Context, band_windows,
                                             chain_count, mh_accept,
                                             per_chain, take)
from gphocs_tpu_torch.ops.coalstats import mig_age_move_delta
from gphocs_tpu_torch.state import GenState, Params
from gphocs_tpu_torch.utils import reflect


def update_mig_ages(gen: GenState, params: Params, rng: RF.FastRngState,
                    ctx: Context, finetune, lnp: torch.Tensor):
    """Returns (gen, rng, lnp, accepted_count); for C chains (chain-major
    loci, [C, P] parameters, a counter per chain) the count is [C]."""
    L = gen.num_loci
    M = gen.max_migs
    dt = gen.age.dtype
    dev = gen.age.device
    C = chain_count(params)
    acc = torch.zeros(params.theta.shape[:-1], dtype=torch.int64,
                      device=dev)
    if ctx.num_bands == 0:
        return gen, rng, lnp, acc
    ar = torch.arange(L, device=dev)
    slots = torch.arange(M, device=dev)
    bs, be = band_windows(ctx, params.tau)
    inf = float("inf")

    for m in range(M):
        active = (gen.mig_branch[:, m] >= 0) & gen.valid
        band = torch.where(active, gen.mig_band[:, m], 0)
        t = gen.mig_age[:, m]
        branch = torch.where(active, gen.mig_branch[:, m], 0)

        tb0 = take(bs, band)
        tb1 = take(be, band)
        others = (gen.mig_branch >= 0) & (gen.mig_branch == branch[:, None])
        others = others & (slots[None, :] != m)
        below = others & (gen.mig_age < t[:, None])
        above = others & (gen.mig_age > t[:, None])
        lm = torch.where(below, gen.mig_age,
                         torch.full_like(gen.mig_age, -inf)).max(dim=1).values
        fm = torch.where(above, gen.mig_age,
                         torch.full_like(gen.mig_age, inf)).min(dim=1).values
        child_age = gen.age[ar, branch]
        fa = gen.father[ar, branch]
        fa_age = torch.where(fa < 0, torch.full_like(t, ctx.oldage),
                             gen.age[ar, fa.clamp(min=0)])
        tb0 = torch.maximum(tb0, torch.where(torch.isfinite(lm), lm,
                                             child_age))
        tb1 = torch.minimum(tb1, torch.where(torch.isfinite(fm), fm, fa_age))

        z, rng = RF.rnd2normal8(rng, dt)
        tnew = reflect(t + finetune * z, tb0, tb1)
        tiny = torch.abs(tnew - t) < 1e-15

        dlnp = mig_age_move_delta(gen, params, ctx, m, tnew, bs, be)
        u, rng = RF.rndu(rng, dt)
        accept = mh_accept(u, dlnp, active & ~tiny)
        mig_age = gen.mig_age.clone()
        mig_age[:, m] = torch.where(accept, tnew, t)
        gen = gen._replace(mig_age=mig_age)
        lnp = torch.where(accept, lnp + dlnp, lnp)
        acc = acc + per_chain(accept | (active & tiny), C)
    return gen, rng, lnp, acc
