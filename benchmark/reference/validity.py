"""What a state of the sampler must satisfy, counted per (chain, locus).

A genealogy is a binary tree over the samples' haploid slots: one root,
every internal node the father of its two sons, no cycle; a leaf sits in
its sample's population at that population's sample age; ages do not fall
toward the root; every node lies in a population whose window [tau_r,
tau_father(r)] holds its age, and the lineages of its two sons have
reached that population when they meet.  A migration event lies on an
edge (the root's included) between its ends, inside its band's window,
and the lineage just below it is in the band's target.  The parameters:
theta > 0, the current populations' tau 0, an ancestral population's tau
no younger than its sons', migration rates >= 0, locus rates > 0, all
finite.

Comparisons between ages allow 2^-20 of their size (16 float32 ulps).
Plain torch; nothing of the program under test is imported.
"""

from __future__ import annotations

import torch

from benchmark.reference.prior import Tree, event_order

RTOL = 2.0 ** -20


def _le(a, b):
    """a <= b, up to RTOL of their size."""
    return a <= b + RTOL * torch.maximum(a.abs(), b.abs())


def violations(gen: dict, theta, tau, mig, sample_age, slot_pop,
               tree: Tree) -> torch.Tensor:
    """[R] the number of broken conditions of each row (0 = valid).  gen
    as for the prior; theta, tau, sample_age [R, P], mig [R, B]; slot_pop
    [S] the population of each leaf."""
    fa, ls, rs = gen["father"], gen["lson"], gen["rson"]
    age = gen["age"].double()
    npop, root = gen["node_pop"], gen["root"]
    branch, band = gen["mig_branch"], gen["mig_band"]
    mage = gen["mig_age"].double()
    theta, tau, mig = theta.double(), tau.double(), mig.double()
    R, N = fa.shape
    S = (N + 1) // 2
    P = tree.P
    B = tree.src.shape[0]
    dev = fa.device
    nid = torch.arange(N, device=dev)
    bad = []

    # the tree
    bad.append((fa < 0).sum(dim=1) != 1)
    bad.append(fa.gather(1, root[:, None])[:, 0] >= 0)
    inr = (fa >= -1) & (fa < N) & (ls >= -1) & (ls < N) & (rs >= -1) \
        & (rs < N) & (npop >= 0) & (npop < P)
    bad.append(~inr.all(dim=1))
    fa, ls, rs = fa.clamp(-1, N - 1), ls.clamp(-1, N - 1), rs.clamp(-1, N - 1)
    npop = npop.clamp(0, P - 1)
    leaf = nid < S
    bad.append(((ls >= 0) | (rs >= 0))[:, :S].any(dim=1))
    for sons in (ls, rs):
        ok = (sons >= 0) & (fa.gather(1, sons.clamp(min=0)) == nid)
        bad.append(~(ok | leaf)[:, S:].all(dim=1))
    bad.append((ls == rs)[:, S:].any(dim=1))
    cur = nid.expand(R, N).clone()
    for _ in range(N):
        cur = torch.where(cur >= 0, fa.gather(1, cur.clamp(min=0)), cur)
    bad.append((cur >= 0).any(dim=1))

    # ages and populations
    top = torch.where(fa >= 0, age.gather(1, fa.clamp(min=0)),
                      torch.full_like(age, float("inf")))
    bad.append(~_le(age, top).all(dim=1))
    bad.append((npop[:, :S] != slot_pop[None, :]).any(dim=1))
    bad.append(~_le((age[:, :S] - sample_age.gather(1, npop[:, :S])).abs(),
                    torch.zeros_like(age[:, :S])).all(dim=1))
    ws, we = tree.windows(tau)
    lo_p, hi_p = ws.gather(1, npop), we.gather(1, npop)
    bad.append(~(_le(lo_p, age) & _le(age, hi_p)).all(dim=1))

    # migration events, and the population of each edge's lineage at its
    # top: that of the edge's highest event's source, else its node's
    act = branch >= 0
    order, s_br, _ = event_order(branch, mage, N)
    bad.append((act & ((branch >= N) | (band < 0) | (band >= B)))
               .any(dim=1))
    br = branch.clamp(0, N - 1)
    bd = band.clamp(0, max(B - 1, 0))
    top_pop = npop
    below_pop = npop.gather(1, br)
    if B:
        s_bd = bd.gather(1, order)
        s_src = tree.src[s_bd]
        s_act = s_br < N
        last = s_act & torch.cat([s_br[:, 1:] != s_br[:, :-1],
                                  torch.ones_like(s_act[:, :1])], dim=1)
        tp = torch.cat([npop, torch.zeros_like(npop[:, :1])], dim=1)
        tp.scatter_(1, torch.where(last, s_br, N), torch.where(last, s_src,
                                                               0))
        top_pop = tp[:, :N]
        prev_same = torch.cat([torch.zeros_like(s_act[:, :1]),
                               s_br[:, 1:] == s_br[:, :-1]], dim=1)
        prev_src = torch.cat([s_src[:, :1], s_src[:, :-1]], dim=1)
        s_below = torch.where(prev_same, prev_src,
                              npop.gather(1, s_br.clamp(max=N - 1)))
        below_pop = torch.empty_like(s_below).scatter_(1, order, s_below)
        bs, be = tree.band_windows(tau)
        ebs, ebe = bs.gather(1, bd), be.gather(1, bd)
        ev_ok = (_le(age.gather(1, br), mage) & _le(mage, top.gather(1, br))
                 & (ebs < ebe) & _le(ebs, mage) & _le(mage, ebe)
                 & tree.anc[tree.tgt[bd], below_pop])
        bad.append((act & ~ev_ok).any(dim=1))
    else:
        bad.append(act.any(dim=1))
    # sons' lineages reach their father's population
    for sons in (ls, rs):
        s = sons.clamp(min=0)
        ok = tree.anc[npop, top_pop.gather(1, s)]
        bad.append(~(ok | leaf)[:, S:].all(dim=1))

    # parameters
    fin = torch.isfinite
    bad.append(~(fin(theta) & (theta > 0)).all(dim=1))
    bad.append(~(fin(tau) & (tau >= 0)).all(dim=1))
    bad.append((tau[:, :tree.num_current] != 0).any(dim=1))
    for p in range(tree.num_current, P):
        sons = (tree.father == p).nonzero()[:, 0]
        bad.append(~_le(tau[:, sons], tau[:, p:p + 1]).all(dim=1))
    if B:
        bad.append(~(fin(mig) & (mig >= 0)).all(dim=1))
    rate = gen["mut_rate"].double()
    bad.append(~(fin(rate) & (rate > 0)))
    return torch.stack(bad, dim=1).sum(dim=1)
