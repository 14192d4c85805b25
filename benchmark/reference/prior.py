"""A plain log density of a genealogy with migration events under the
multi-population coalescent with migration bands (G-PhoCS's
gtreeLnLikelihood, src/patch.c; Gronau et al. 2011, Supplementary Note).

Each edge of the genealogy is a lineage from its node's age up to its
father's (the root's up to infinity).  Migration events on an edge cut it
into pieces: below the lowest event the lineage belongs to its node's
population, above each event to the event's band's source.  A piece that
belongs to population q at time t lies in the ancestor of q (or q) whose
window [tau_r, tau_father(r)) holds t.  With k_r(t) the pieces in
population r at time t,

    ln p = sum_r [ c_r ln(2 / theta_r) - (1 / theta_r) int k_r (k_r - 1) dt ]
         + sum_b [ e_b ln m_b - m_b int_{band b's window} k_target(b) dt ]

c_r being the coalescences (internal nodes) in r and e_b the events of
band b.  A band's window is where its source and target both live.  The
integral of k (k - 1) is taken by a sweep over the ends of the pieces.

Plain torch on any device and dtype, a block of rows at a time; nothing of
the program under test is imported.
"""

from __future__ import annotations

import torch

from benchmark.reference.control import Control


class Tree:
    """The population tree's tables, from the reference's control reader."""

    def __init__(self, ctl: Control, device):
        P = ctl.num_pops
        fa = ctl.father
        anc = torch.zeros((P, P), dtype=torch.bool)
        for q in range(P):
            for r in ctl.ancestors(q):
                anc[r, q] = True
        self.P = P
        self.father = torch.tensor(fa, device=device)
        self.anc = anc.to(device)                 # [r, q]: r holds q's past
        self.src = torch.tensor([ctl.index(b.source) for b in ctl.bands],
                                dtype=torch.int64, device=device)
        self.tgt = torch.tensor([ctl.index(b.target) for b in ctl.bands],
                                dtype=torch.int64, device=device)
        self.num_current = ctl.num_current

    def windows(self, tau: torch.Tensor):
        """[R, P] start and end of each population's window."""
        inf = torch.full_like(tau[:, :1], float("inf"))
        end = torch.cat([tau, inf], dim=1)[:, torch.where(
            self.father >= 0, self.father, self.P)]
        return tau, end

    def band_windows(self, tau: torch.Tensor):
        start, end = self.windows(tau)
        bs = torch.maximum(start[:, self.src], start[:, self.tgt])
        be = torch.minimum(end[:, self.src], end[:, self.tgt])
        return bs, torch.maximum(be, bs)


def event_order(branch: torch.Tensor, mage: torch.Tensor, N: int):
    """The migration slots sorted by their edge, then by age (ties by
    slot), the free slots (edge N) last: (order, edge, age) [R, M]."""
    act = branch >= 0
    key_age = torch.where(act, mage, torch.full_like(mage, float("inf")))
    o1 = torch.argsort(key_age, dim=1, stable=True)
    key_br = torch.where(act, branch, N).gather(1, o1)
    order = o1.gather(1, torch.argsort(key_br, dim=1, stable=True))
    return (order, torch.where(act, branch, N).gather(1, order),
            mage.gather(1, order))


def pieces(gen: dict, tree: Tree, dtype):
    """The lineage pieces: (lo, hi, pop, valid) [R, N + M]: the part of each
    edge below its lowest event, then the part above each active event."""
    age = gen["age"].to(dtype)
    mage = gen["mig_age"].to(dtype)
    father, branch, band = gen["father"], gen["mig_branch"], gen["mig_band"]
    R, N = age.shape
    M = branch.shape[1]
    dev = age.device
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    top = torch.where(father >= 0, age.gather(1, father.clamp(min=0)), inf)
    act = branch >= 0
    key_age = torch.where(act, mage, inf)
    order, s_br, s_age = event_order(branch, mage, N)
    nxt_same = torch.cat([s_br[:, 1:] == s_br[:, :-1],
                          torch.zeros_like(s_br[:, :1], dtype=torch.bool)],
                         dim=1)
    s_next = torch.cat([s_age[:, 1:], s_age[:, :1]], dim=1)
    s_top = top.gather(1, s_br.clamp(max=N - 1))
    s_hi = torch.where(nxt_same, s_next, s_top)
    hi_ev = torch.empty_like(s_hi).scatter_(1, order, s_hi)
    # each edge's lowest event
    lowest = torch.full((R, N + 1), float("inf"), dtype=dtype, device=dev)
    lowest.scatter_reduce_(1, torch.where(act, branch, N), key_age, "amin")
    hi_node = torch.minimum(top, lowest[:, :N])
    src = tree.src[torch.where(act, band, 0)] if M and len(tree.src) else \
        torch.zeros_like(branch)
    lo = torch.cat([age, torch.where(act, mage, 0 * mage)], dim=1)
    hi = torch.cat([hi_node, torch.where(act, hi_ev, 0 * mage)], dim=1)
    pop = torch.cat([gen["node_pop"], src], dim=1)
    valid = torch.cat([torch.ones_like(act[:, :1]).expand(R, N), act], dim=1)
    return lo, hi, pop, valid


def log_prior(gen: dict, theta: torch.Tensor, tau: torch.Tensor,
              mig: torch.Tensor, tree: Tree, dtype=torch.float64
              ) -> torch.Tensor:
    """[R] ln p(genealogy | theta, tau, m); theta, tau [R, P], mig [R, B]
    (each row its chain's parameters)."""
    theta, tau, mig = theta.to(dtype), tau.to(dtype), mig.to(dtype)
    lo, hi, pop, valid = pieces(gen, tree, dtype)
    R, K = lo.shape
    S = (gen["age"].shape[1] + 1) // 2
    ws, we = tree.windows(tau)                                  # [R, P]
    # each piece clipped to each population's window, where it lies there
    plo = torch.maximum(lo[:, None, :], ws[:, :, None])         # [R, P, K]
    phi = torch.minimum(hi[:, None, :], we[:, :, None])
    inside = valid[:, None, :] & tree.anc[:, pop].permute(1, 0, 2) \
        & (phi > plo)
    plo = torch.where(inside, plo, torch.zeros_like(plo))
    phi = torch.where(inside, phi, torch.zeros_like(phi))
    # sweep: between consecutive ends, count the pieces that cover it
    ends, _ = torch.sort(torch.cat([plo, phi], dim=2), dim=2)
    a, b = ends[..., :-1], ends[..., 1:]
    cover = (inside[:, :, None, :] & (plo[:, :, None, :] <= a[..., None])
             & (phi[:, :, None, :] >= b[..., None]) & (b > a)[..., None])
    k = cover.sum(dim=3).to(dtype)
    span = torch.where(k >= 2, b - a, torch.zeros_like(a))
    coal = (k * (k - 1) * span).sum(dim=2)                      # [R, P]
    P = tree.P
    ncoal = (gen["node_pop"][:, S:, None]
             == torch.arange(P, device=lo.device)).sum(dim=1).to(dtype)
    lnp = (ncoal * torch.log(2.0 / theta) - coal / theta).sum(dim=1)
    B = tree.src.shape[0]
    if B:
        bs, be = tree.band_windows(tau)
        t = tree.tgt
        mlo = torch.maximum(plo[:, t, :], bs[:, :, None])
        mhi = torch.minimum(phi[:, t, :], be[:, :, None])
        expo = torch.where(inside[:, t, :], (mhi - mlo).clamp(min=0),
                           torch.zeros_like(mlo)).sum(dim=2)    # [R, B]
        act = gen["mig_branch"] >= 0
        nev = ((gen["mig_band"][:, None, :]
                == torch.arange(B, device=lo.device)[None, :, None])
               & act[:, None, :]).sum(dim=2).to(dtype)
        safe = torch.where(mig > 0, mig, torch.ones_like(mig))
        term = torch.where(mig > 0, nev * torch.log(safe) - expo * mig,
                           torch.where(nev > 0,
                                       torch.full_like(mig, -float("inf")),
                                       torch.zeros_like(mig)))
        lnp = lnp + term.sum(dim=1)
    return lnp
