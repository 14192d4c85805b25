"""Shared static context + helpers for the MH update kernels
(twin of gphocs_tpu/kernels/common.py)."""

from __future__ import annotations

import dataclasses

import torch

from gphocs_tpu_torch.constants import OLDAGE
from gphocs_tpu_torch.model.poptree import PopTree
from gphocs_tpu_torch.state import GenState, Params


@dataclasses.dataclass(frozen=True)
class Context:
    """Static (per-run) population-tree context: tensors on the sampler's
    device plus python ints/floats usable in control flow.  Band windows
    are functions of tau and are recomputed by `band_windows`."""

    father_pop: torch.Tensor     # [P] int64
    pop_sons: torch.Tensor       # [P, 2] int64
    is_ancestral: torch.Tensor   # [P, P] bool; [i, j]: i ancestor-or-self of j
    band_source: torch.Tensor    # [B] int64
    band_target: torch.Tensor    # [B] int64
    theta_alpha: torch.Tensor    # [P]
    theta_beta: torch.Tensor
    tau_alpha: torch.Tensor
    tau_beta: torch.Tensor
    mig_alpha: torch.Tensor      # [B]
    mig_beta: torch.Tensor
    sample_pop: torch.Tensor     # [S] int64
    update_sample_age: torch.Tensor  # [P] bool
    admix_slot: torch.Tensor     # [A] int64
    admix_pops: torch.Tensor     # [A, 2] int64
    root_pop: int = 0
    num_cur_pops: int = 0
    oldage: float = OLDAGE

    @property
    def num_pops(self) -> int:
        return self.father_pop.shape[0]

    @property
    def num_bands(self) -> int:
        return self.band_source.shape[0]

    @property
    def num_admixed(self) -> int:
        return self.admix_slot.shape[0]


def make_context(tree: PopTree, dtype=torch.float64, device="cpu") -> Context:
    def i64(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def real(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Context(
        father_pop=i64(tree.father),
        pop_sons=i64(tree.sons),
        is_ancestral=torch.as_tensor(tree.is_ancestral, dtype=torch.bool,
                                     device=device),
        band_source=i64(tree.band_source),
        band_target=i64(tree.band_target),
        theta_alpha=real(tree.theta_alpha),
        theta_beta=real(tree.theta_beta),
        tau_alpha=real(tree.tau_alpha),
        tau_beta=real(tree.tau_beta),
        mig_alpha=real(tree.mig_alpha),
        mig_beta=real(tree.mig_beta),
        sample_pop=i64(tree.sample_pop),
        update_sample_age=torch.as_tensor(tree.update_sample_age,
                                          dtype=torch.bool, device=device),
        admix_slot=i64(tree.admix_slot),
        admix_pops=i64(tree.admix_pops).reshape(-1, 2),
        root_pop=int(tree.root_pop),
        num_cur_pops=int(tree.num_cur_pops),
        oldage=OLDAGE,
    )


def band_windows(ctx: Context, tau: torch.Tensor):
    """[B] band start/end from current taus
    (reference src/PopulationTree.c:439-505)."""
    if ctx.num_bands == 0:
        z = tau.new_zeros((0,))
        return z, z
    src, tgt = ctx.band_source, ctx.band_target
    start = torch.maximum(tau[src], tau[tgt])
    end = torch.minimum(tau[ctx.father_pop[src]], tau[ctx.father_pop[tgt]])
    collapsed = start >= end
    start = torch.where(collapsed, tau[tgt], start)
    end = torch.where(collapsed, tau[tgt], end)
    return start, end


def pop_end(ctx: Context, tau: torch.Tensor) -> torch.Tensor:
    """[P] top of each pop's window (tau of father, OLDAGE for root)."""
    fa = ctx.father_pop
    return torch.where(fa < 0, torch.full_like(tau, ctx.oldage),
                       tau[fa.clamp(min=0)])


def full_stats(gen: GenState, params: Params, ctx: Context):
    """Sufficient statistics with band windows derived from current taus."""
    from gphocs_tpu_torch.ops.coalstats import sufficient_stats

    bs, be = band_windows(ctx, params.tau)
    return sufficient_stats(
        gen, params, father_pop=ctx.father_pop,
        is_ancestral=ctx.is_ancestral, band_source=ctx.band_source,
        band_target=ctx.band_target, band_start=bs, band_end=be,
        oldage=ctx.oldage)


def gen_log_prior_from_stats(stats, gen: GenState, params: Params,
                             ctx: Context) -> torch.Tensor:
    """Per-locus genealogy log prior from precomputed sufficient stats.
    Admixture terms are not ported yet (the driver refuses admixture)."""
    from gphocs_tpu_torch.ops.coalstats import genealogy_log_prior

    if ctx.num_admixed > 0:
        raise NotImplementedError(
            "admixture: ROADMAP Queue 1 item 10b")
    return genealogy_log_prior(stats, params)


def gen_log_prior(gen: GenState, params: Params, ctx: Context) -> torch.Tensor:
    return gen_log_prior_from_stats(full_stats(gen, params, ctx), gen,
                                    params, ctx)


def first_mig_above(gen: GenState, node: torch.Tensor, age: torch.Tensor):
    """Per locus: min age of active migration events on edge `node` with age
    > `age` (reference findFirstMig, src/patch.c:397); +inf when none."""
    on = (gen.mig_branch == node[:, None]) & (gen.mig_branch >= 0) \
        & (gen.mig_age > age[:, None])
    return torch.where(on, gen.mig_age,
                       torch.full_like(gen.mig_age, float("inf"))
                       ).min(dim=1).values


def last_mig_below(gen: GenState, node: torch.Tensor, age: torch.Tensor):
    """Per locus: max age of active migs on edge `node` with age < `age`
    (reference findLastMig, src/patch.c:374); -inf when none."""
    on = (gen.mig_branch == node[:, None]) & (gen.mig_branch >= 0) \
        & (gen.mig_age < age[:, None])
    return torch.where(on, gen.mig_age,
                       torch.full_like(gen.mig_age, float("-inf"))
                       ).max(dim=1).values


def maybe_psum(x, loci_axis=None):
    """Identity: the port runs on one device (multi-GPU reductions are
    ROADMAP Queue 1 item 15)."""
    return x


def maybe_pmax(x, loci_axis=None):
    return x


def mh_accept(u: torch.Tensor, lnacc: torch.Tensor, mask: torch.Tensor):
    """Vectorized MH decision; `u` is the lane's uniform (fast-RNG mode
    always draws it, so the caller has already advanced the stream)."""
    return mask & ((lnacc >= 0.0) | (u < torch.exp(torch.clamp(lnacc,
                                                               max=0.0))))


def scalar_mh_accept(rng_state, lnacc, conflict=False):
    """MH decision on the (size-1) general stream (scalar lnacc).  The
    uniform is drawn unconditionally, as in the JAX fast-RNG mode (the
    counter advances by one whether or not the draw is used)."""
    from gphocs_tpu_torch import rng as R

    u, rng_state = R.general_draw_u(rng_state, lnacc.dtype)
    conflict = torch.as_tensor(conflict, device=lnacc.device)
    accept = ~conflict & ((lnacc >= 0.0)
                          | (u < torch.exp(torch.clamp(lnacc, max=0.0))))
    return accept, rng_state
