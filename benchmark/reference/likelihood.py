"""A plain data log-likelihood of a genealogy under Jukes-Cantor.

For one site pattern, Felsenstein's pruning: a leaf's conditional is 1 at
its base (at every base for N); an edge of length t = rate x (age of the
father - age of the child) carries a conditional c to

    P(same base) c[b] + P(other base) (sum c - c[b]),
    P(other) = -expm1(-4 t / 3) / 4,  P(same) = 1 - 3 P(other)

and a node's conditional is the product of its two edges'.  The nodes are
taken from the leaves up, by their height (the longest path down to a
leaf).  A site's likelihood averages the root's conditional over the 4
bases; a pattern's averages its phased patterns' likelihoods; and a
locus's log-likelihood is the sum over its patterns of count x log of
that (G-PhoCS's computeLocusDataLikelihood, src/LocusDataLikelihood.c).

Plain torch on any device, in the dtype asked for, a block of (chain,
locus) rows at a time.  Nothing of the program under test is imported.
"""

from __future__ import annotations

import torch


def heights(lson: torch.Tensor, rson: torch.Tensor, S: int) -> torch.Tensor:
    """[R, N] the longest path from each node down to a leaf."""
    R, N = lson.shape
    h = torch.zeros((R, N), dtype=torch.int64, device=lson.device)
    internal = torch.arange(N, device=lson.device) >= S
    for _ in range(S - 1):
        hl = h.gather(1, lson.clamp(min=0))
        hr = h.gather(1, rson.clamp(min=0))
        h = torch.where(internal, 1 + torch.maximum(hl, hr), h)
    return h


def log_likelihood(gen: dict, leaf: torch.Tensor, group: torch.Tensor,
                   count: torch.Tensor, nphases: torch.Tensor,
                   dtype=torch.float64) -> torch.Tensor:
    """[R] log-likelihoods.  gen: father, lson, rson, age, root, mut_rate
    ([R, N] / [R]); leaf [R, Q, S] bases of the phased patterns; group
    [R, Q] their pattern (-1: padding); count, nphases [R, G]."""
    lson, rson, root = gen["lson"], gen["rson"], gen["root"]
    age = gen["age"].to(dtype)
    rate = gen["mut_rate"].to(dtype)
    R, N = lson.shape
    S = (N + 1) // 2
    Q = leaf.shape[1]
    dev = age.device
    ar = torch.arange(R, device=dev)
    cond = torch.zeros((R, N, Q, 4), dtype=dtype, device=dev)
    bases = torch.arange(4, device=dev)
    lf = leaf.permute(0, 2, 1).to(torch.int64)              # [R, S, Q]
    cond[:, :S] = ((lf[..., None] == bases) | (lf[..., None] >= 4)).to(dtype)

    def edge(child, parent_age):
        t = rate * (parent_age - age[ar, child])
        other = (-0.25 * torch.expm1(-4.0 * t / 3.0))[:, None, None]
        same = 1.0 - 3.0 * other
        c = cond[ar, child]                                   # [R, Q, 4]
        return same * c + other * (c.sum(dim=-1, keepdim=True) - c)

    h = heights(lson, rson, S)
    # internal nodes from the lowest height up (ties by number)
    order = torch.argsort(h[:, S:] * N + torch.arange(S, N, device=dev),
                          dim=1) + S
    for k in range(S - 1):
        v = order[:, k]
        cond[ar, v] = (edge(lson[ar, v], age[ar, v])
                       * edge(rson[ar, v], age[ar, v]))
    site = cond[ar, root].sum(dim=-1) / 4.0                   # [R, Q]
    site = torch.where(group >= 0, site, torch.zeros_like(site))
    per = torch.zeros(count.shape, dtype=dtype, device=dev)
    per.scatter_add_(1, group.clamp(min=0), site)
    per = per / nphases.to(dtype)
    cnt = count.to(dtype)
    safe = torch.where(cnt > 0, per, torch.ones_like(per))
    return (cnt * torch.log(safe)).sum(dim=1)
