"""Shared static context + helpers for the MH update kernels
(twin of gphocs_tpu/kernels/common.py).

A state of C chains (sampler/driver.py, `chains=C`) keeps its per-locus
tensors chain-major, [C * L, ...], and its parameters with a leading chain
axis ([C, P], [C, B]); one chain's parameters are [P], [B], as in the JAX
package.  The JAX package vmaps one chain's functions over the chains; here
the functions take both layouts, and `rows`, `take` and `per_chain` give a
locus its chain's parameters and a chain its loci's sums.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gphocs_tpu_torch.constants import OLDAGE
from gphocs_tpu_torch.model.poptree import PopTree
from gphocs_tpu_torch.state import GenState, Params
from gphocs_tpu_torch.utils import ordered_sum


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
    # the CUDA kernels' integer tables, built once by make_context:
    # [father_pop (P), band_source (B), band_target (B), is_ancestral (P*P),
    #  admix_slot (A), admix_pops[:, 0] (A), admix_pops[:, 1] (A)]
    popi: torch.Tensor | None = None

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

    pairs = np.asarray(tree.admix_pops).reshape(-1, 2)
    popi = torch.cat([i64(tree.father), i64(tree.band_source),
                      i64(tree.band_target),
                      i64(tree.is_ancestral).reshape(-1),
                      i64(tree.admix_slot), i64(pairs[:, 0]),
                      i64(pairs[:, 1])]).contiguous()
    return Context(
        popi=popi,
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


def chain_count(params: Params) -> Optional[int]:
    """C for the parameters of C chains ([C, P]), None for one chain's
    ([P])."""
    return None if params.theta.dim() == 1 else params.theta.shape[0]


def rows(x: torch.Tensor, L: int, nd: int = 1) -> torch.Tensor:
    """A table of nd dims per locus, for L loci: one chain's table as one
    row that broadcasts over the loci ([1, ...]); C chains' tables ([C,
    ...]) each repeated over its chain's L // C loci ([L, ...])."""
    if x.dim() == nd:
        return x.unsqueeze(0)
    C = x.shape[0]
    return x[:, None].expand(C, L // C, *x.shape[1:]).reshape(L,
                                                             *x.shape[1:])


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with per-locus indices idx ([L] or [L, k]) into a population
    table x: one chain's ([P]), or C chains' ([C, P]), each locus reading
    its own chain's row.  A negative index counts from the end."""
    if x.dim() == 1:
        return x[idx]
    L = idx.shape[0]
    return rows(x, L).gather(1, idx.reshape(L, -1) % x.shape[1]).reshape(
        idx.shape)


def with_entry(t: torch.Tensor, j: int, value) -> torch.Tensor:
    """t with its entry j (each chain's, for [C, P]) set to value."""
    out = t.clone()
    out[..., j] = value
    return out


def per_chain(x: torch.Tensor, C: Optional[int], op: str = "sum"
              ) -> torch.Tensor:
    """Reduce a per-locus tensor x [L, ...] over its loci: over all of
    them for one chain (C None), over each chain's for C chains ([C,
    ...]).  op: "sum", "any" or "amax"."""
    if C is not None:
        x = x.reshape(C, -1, *x.shape[1:])
    return getattr(x, op)(dim=0 if C is None else 1)


def band_windows(ctx: Context, tau: torch.Tensor):
    """[B] band start/end from current taus ([C, B] from C chains' [C, P])
    (reference src/PopulationTree.c:439-505)."""
    if ctx.num_bands == 0:
        z = tau.new_zeros(tau.shape[:-1] + (0,))
        return z, z
    src, tgt = ctx.band_source, ctx.band_target
    start = torch.maximum(tau[..., src], tau[..., tgt])
    end = torch.minimum(tau[..., ctx.father_pop[src]],
                        tau[..., ctx.father_pop[tgt]])
    collapsed = start >= end
    start = torch.where(collapsed, tau[..., tgt], start)
    end = torch.where(collapsed, tau[..., tgt], end)
    return start, end


def pop_end(ctx: Context, tau: torch.Tensor) -> torch.Tensor:
    """[P] ([C, P]) top of each pop's window (tau of father, OLDAGE for
    root)."""
    fa = ctx.father_pop
    return torch.where(fa < 0, torch.full_like(tau, ctx.oldage),
                       tau[..., fa.clamp(min=0)])


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
    """Per-locus genealogy log prior from precomputed sufficient stats,
    with the admixture assignment terms where the run has admixed leaves
    (reference gtreeLnLikelihood, src/patch.c:2725-2735): log c where the
    leaf sits in its second population, log(1 - c) in its first, added
    over the admixed leaves in index order (the rubber-band kernel's
    order, csrc/rubber_band.cu)."""
    from gphocs_tpu_torch.ops.coalstats import genealogy_log_prior

    lnp = genealogy_log_prior(stats, params)
    if ctx.num_admixed > 0:
        in_second = (gen.node_pop[:, ctx.admix_slot]
                     == ctx.admix_pops[None, :, 1])            # [L, A]
        c = rows(params.admix_coeff, gen.num_loci)
        lnp = lnp + ordered_sum(torch.where(in_second, torch.log(c),
                                            torch.log1p(-c)))
    return lnp


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
    """x summed over the ranks of the loci mesh `loci_axis` (a
    parallel/mesh.LociMesh); x itself without one.  A sequence of tensors
    travels in one all-reduce and comes back as a list."""
    return _reduce(x, loci_axis, "sum")


def maybe_pmax(x, loci_axis=None):
    """x's largest value over the ranks of the loci mesh (see maybe_psum)."""
    return _reduce(x, loci_axis, "max")


def _reduce(x, mesh, op):
    if mesh is None:
        return x
    from gphocs_tpu_torch.parallel.mesh import all_reduce

    if isinstance(x, (list, tuple)):
        return all_reduce(mesh, x, op)
    return all_reduce(mesh, [x], op)[0]


def mh_accept(u: torch.Tensor, lnacc: torch.Tensor, mask: torch.Tensor):
    """Vectorized MH decision on the lane's uniform `u` (drawn by the
    caller: see draw_accept)."""
    return mask & ((lnacc >= 0.0) | (u < torch.exp(torch.clamp(lnacc,
                                                               max=0.0))))


def draw_accept(rng, lnacc: torch.Tensor, mask: torch.Tensor):
    """MH decision on the per-locus streams `rng`: the fast streams draw
    the uniform on every lane; the Wichmann-Hill streams only where
    mask & (lnacc < 0), the reference's short-circuit (e.g.
    src/GPhoCS.c:2383; gphocs_tpu/kernels/common.mh_accept).  Returns
    (accept, u, rng)."""
    from gphocs_tpu_torch import rng as R

    u, rng = R.rndu(rng, mask & (lnacc < 0.0), lnacc.dtype)
    return mh_accept(u, lnacc, mask), u, rng


def scalar_mh_accept(rng_state, lnacc, conflict=False):
    """MH decision on the (size-1) general stream (scalar lnacc; [C] on
    the general streams of C chains).  The fast streams draw the uniform
    unconditionally, as in the JAX fast-RNG mode (the counter advances by
    one whether or not the draw is used); a Wichmann-Hill stream only
    where there is no conflict and lnacc < 0, as the reference does."""
    from gphocs_tpu_torch import rng as R

    conflict = torch.as_tensor(conflict, device=lnacc.device)
    u, rng_state = R.general_draw_u(rng_state, lnacc.dtype,
                                    ~conflict & (lnacc < 0.0))
    accept = ~conflict & ((lnacc >= 0.0)
                          | (u < torch.exp(torch.clamp(lnacc, max=0.0))))
    return accept, rng_state
