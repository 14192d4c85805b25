"""Carried pruning conditionals with incremental (dirty-path) refresh
(twin of gphocs_tpu/ops/likelihood_cache.py).

The conditionals live in a carried tensor `cond` [L, N, P, 4].  Topology
lookups are indexed gathers (`cond[l, lson[l, n]]`); the JAX package's
one-hot [L, N, N] einsum tables were a TPU choice, and selection is exact,
so the values are the same.
"""

from __future__ import annotations

import math

import torch

from gphocs_tpu_torch.io.sequences import group_members
from gphocs_tpu_torch.ops.pruning import (edge_p, jc_combine,
                                          leaf_conditionals, sum4)
from gphocs_tpu_torch.state import GenState, SeqData
from gphocs_tpu_torch.utils import ordered_sum


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[l, idx[l, n]] for x [L, N, ...] and idx [L, N] (idx >= 0)."""
    ar = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[ar, idx]


def _combine_all(cond, gen: GenState):
    """New conditionals for ALL nodes from current son conditionals
    (garbage on leaf rows — callers mask)."""
    ls = gen.lson.clamp(min=0)
    rs = gen.rson.clamp(min=0)
    mu = gen.mut_rate[:, None]
    pl = edge_p(mu * (gen.age - _rows(gen.age, ls)))
    pr = edge_p(mu * (gen.age - _rows(gen.age, rs)))
    return jc_combine(_rows(cond, ls), _rows(cond, rs), pl, pr)


def full_build(gen: GenState, seq: SeqData) -> torch.Tensor:
    """Conditionals for all nodes by Jacobi iteration: trip k finalizes all
    nodes of subtree height <= k, so S-1 trips converge for any topology."""
    L, N = gen.father.shape
    S = (N + 1) // 2
    leaf = leaf_conditionals(seq.leaf_base, gen.age.dtype)
    cond = leaf.new_zeros((L, N) + leaf.shape[2:])
    cond[:, :S] = leaf
    internal = (torch.arange(N, device=cond.device) >= S)[None, :, None, None]
    for _ in range(S - 1):
        cond = torch.where(internal, _combine_all(cond, gen), cond)
    return cond


def refresh(cond: torch.Tensor, gen: GenState, dirty0: torch.Tensor
            ) -> torch.Tensor:
    """Recompute `cond` for the dirty nodes and (transitively) their
    ancestors, bottom-up along the dirty frontier.

    dirty0: [L, N] bool (or [N], broadcast) — the directly-touched nodes.
    Recomputing a node marks its father dirty (the tensor twin of the
    reference's dirty-flag propagation, src/LocusDataLikelihood.c:875-930).
    """
    L, N = gen.father.shape
    S = (N + 1) // 2
    internal = (torch.arange(N, device=cond.device) >= S)[None, :]
    dirty = torch.broadcast_to(dirty0, (L, N)) & internal
    ls = gen.lson.clamp(min=0)
    rs = gen.rson.clamp(min=0)
    fa_idx = torch.where(gen.father >= 0, gen.father, N)
    it = 0
    # several dirty seeds may recompute a shared ancestor more than once
    # as the waves merge, so the cap exceeds one tree height
    while it < 2 * N and bool(dirty.any()):
        sons_dirty = internal & (_rows(dirty, ls) | _rows(dirty, rs))
        ready = dirty & ~sons_dirty
        cond = torch.where(ready[:, :, None, None], _combine_all(cond, gen),
                           cond)
        fd = torch.zeros((L, N + 1), dtype=torch.bool, device=cond.device)
        fd.scatter_(1, torch.where(ready, fa_idx, N), True)
        dirty = (dirty & ~ready) | (fd[:, :N] & internal)
        it += 1
    return cond


def _group_sums(x: torch.Tensor, seq: SeqData) -> torch.Tensor:
    """seg[l, g] = the sum of x[l, p] over the patterns p of group g, added
    in pattern order: (x[first] + x[next]) + ...

    The order is fixed on every device: a float scatter_add_ adds in any
    order on CUDA, and a matmul may take a TF32 or split-K route.  The JAX
    package's one-hot product gives the same sums up to their order (equal
    bits for groups of one or two patterns), but it costs L * P * P; this
    costs L * P per pattern of the largest group.  The gather indices
    depend on the data alone and are built with the SeqData
    (io/sequences.group_members); index P reads a zero column."""
    idx = seq.group_members
    if idx is None:
        idx = torch.as_tensor(group_members(seq.group_id.cpu().numpy()),
                              device=x.device)
    xp = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    seg = xp.gather(1, idx[:, 0])
    for j in range(1, idx.shape[1]):
        seg = seg + xp.gather(1, idx[:, j])
    return seg


def lnld_from_cond(cond: torch.Tensor, gen: GenState, seq: SeqData
                   ) -> torch.Tensor:
    """Per-locus data log-likelihood from root conditionals: averages over
    the 4 root bases and all phasings of each het-pattern group
    (reference src/LocusDataLikelihood.c:471-479), weighted by site counts,
    minus the (S-1) log 4 of the x4 rescale.  The groups add in index
    order."""
    L, N, P, _ = cond.shape
    S = (N + 1) // 2
    ar = torch.arange(L, device=cond.device)
    root_sum = sum4(cond[ar, gen.root])                        # [L, P]
    root_sum = torch.where(seq.pattern_valid, root_sum,
                           torch.zeros_like(root_sum))
    seg = _group_sums(root_sum, seq)
    safe = torch.where(seq.group_count > 0, seg, torch.ones_like(seg))
    # the groups in index order, as the kernels add them (utils.ordered_sum)
    return ordered_sum(
        seq.group_count * (torch.log(safe) - torch.log(4.0 * seq.group_nphases)
                           - (S - 1) * math.log(4.0)))


def full_rebuild_and_lnld(gen: GenState, seq: SeqData):
    """Leaf init + full bottom-up rebuild (+ root reduce)."""
    cond = full_build(gen, seq)
    return cond, lnld_from_cond(cond, gen, seq)


def refresh_and_lnld(cond, gen: GenState, seq: SeqData, dirty0):
    """Dirty refresh + root reduce."""
    cond = refresh(cond, gen, dirty0)
    return cond, lnld_from_cond(cond, gen, seq)
