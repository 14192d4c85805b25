"""Sampler initialization: prior draws for parameters + random genealogies.

Mirrors the reference's initializeMCMC (src/GPhoCS.c:1122-1229):
  * samplePopParameters: theta/tau ~ U[0.9, 1.1] * prior-mean start point,
    pre-order with parent-consistency fixes (src/PopulationTree.c:339-400);
    migration rates start at 0 (they are sampled at start-mig).
  * per-locus mutation rates: CONST=1 / VAR ~ U[0.8, 1.2] normalized /
    FIXED from a rate file (src/GPhoCS.c:1137-1178).
  * GetRandomGtree: simulate a coalescent genealogy (no migration) down the
    population tree, post-order over populations
    (src/patch.c:241-360 Coalescence1Pop).

All of this is host-side numpy using the same legacy RNG streams so that
a conformance run consumes randomness in exactly the reference's order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gphocs_tpu_torch.constants import MAX_MIGS
from gphocs_tpu_torch.model.poptree import PopTree
from gphocs_tpu_torch.rng_host import HostRng
from gphocs_tpu_torch.state import GenState, Params


def sample_pop_parameters(tree: PopTree, rng: HostRng) -> Params:
    """Pre-order sampling of theta and tau (src/PopulationTree.c:339-400)."""
    P = tree.num_pops
    theta = np.zeros(P)
    tau = np.zeros(P)
    g = rng.general_slot

    # pre-order via BFS queue from root, matching the reference's queue
    theta_start = tree.theta_alpha / tree.theta_beta
    order = [tree.root_pop]
    qi = 0
    while qi < len(order):
        p = order[qi]
        qi += 1
        theta[p] = theta_start[p] * (0.9 + 0.2 * rng.rndu(g))
        if tree.sons[p, 0] >= 0:
            start = tree.tau_initial[p]
            tau[p] = start * (0.9 + 0.2 * rng.rndu(g))
            fa = tree.father[p]
            if fa >= 0 and tau[fa] < tau[p]:
                lo = max(tree.sample_age[tree.sons[p, 0]],
                         tree.sample_age[tree.sons[p, 1]])
                tau[p] = lo + (tau[fa] - lo) * (0.93 + 0.004 * rng.rndu(g))
            order.append(int(tree.sons[p, 0]))
            order.append(int(tree.sons[p, 1]))

    mig_rate = np.zeros(tree.num_bands)
    # admixture coefficients start at 0.5 (reference src/GPhoCS.c:1094)
    admix = np.full(len(tree.admix_slot), 0.5)
    return Params(theta=theta, tau=tau,
                  sample_age=tree.sample_age.copy(), mig_rate=mig_rate,
                  admix_coeff=admix)


def sample_mig_rates(tree: PopTree, rng: HostRng) -> np.ndarray:
    """m ~ U[0.9, 1.1] * prior mean (src/PopulationTree.c:414-433)."""
    g = rng.general_slot
    rates = np.zeros(tree.num_bands)
    for b in range(tree.num_bands):
        mean = tree.mig_alpha[b] / tree.mig_beta[b]
        rates[b] = mean * (0.9 + 0.2 * rng.rndu(g))
    return rates


def sample_locus_rates(num_loci: int, mode: int, rng: HostRng,
                       fixed_rates: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, float]:
    """Per-locus mutation rates; returns (rates, rateVar)
    (src/GPhoCS.c:1137-1178)."""
    if mode == 0:
        return np.ones(num_loci), 0.0
    if mode == 2:
        assert fixed_rates is not None and len(fixed_rates) == num_loci
        mean = fixed_rates.mean()
        rates = fixed_rates / mean
        return rates, float(((rates - 1.0) ** 2).mean())
    rates = np.array([0.8 + 0.4 * rng.rndu(gen) for gen in range(num_loci)])
    rates = rates / rates.mean()
    return rates, float(((rates - 1.0) ** 2).mean())


def random_genealogy(tree: PopTree, params: Params, rng: HostRng, gen: int):
    """One random coalescent genealogy (src/patch.c:241-360).

    Returns (father, lson, rson, age, node_pop, root) numpy arrays.
    Leaves are numbered grouped by population in pop order; internal nodes
    are assigned in coalescence order within the post-order pop traversal.
    """
    S = tree.num_samples
    N = 2 * S - 1
    father = np.full(N, -1, np.int32)
    lson = np.full(N, -1, np.int32)
    rson = np.full(N, -1, np.int32)
    age = np.zeros(N)
    node_pop = np.zeros(N, np.int32)

    cum = np.concatenate([[0], np.cumsum(tree.samples_per_pop)])
    next_node = [S]  # boxed nextAvailableNodeId

    def coalesce_pop(pop: int, living: list) -> list:
        if pop < tree.num_cur_pops:
            lo, hi = int(cum[pop]), int(cum[pop + 1])
            living = list(range(lo, hi))
            for v in living:
                node_pop[v] = pop
                age[v] = tree.sample_age[pop]
            T = tree.sample_age[pop]
        else:
            left = coalesce_pop(int(tree.sons[pop, 0]), [])
            right = coalesce_pop(int(tree.sons[pop, 1]), [])
            living = left + right
            T = params.tau[pop]
        k = len(living)
        while k > 1:
            t = rng.rndexp(gen, params.theta[pop] / (k * (k - 1.0)))
            T = T + t
            if tree.father[pop] >= 0 and T > params.tau[tree.father[pop]]:
                break
            c1 = int(k * rng.rndu(gen))
            node1 = living[c1]
            living[c1] = living[k - 1]
            c2 = int((k - 1) * rng.rndu(gen))
            node2 = living[c2]
            nid = next_node[0]
            living[c2] = nid
            next_node[0] += 1
            rson[nid] = node1
            lson[nid] = node2
            age[nid] = T
            father[node1] = nid
            father[node2] = nid
            node_pop[nid] = pop
            k -= 1
        return living[:k]

    coalesce_pop(tree.root_pop, [])
    root = next_node[0] - 1
    return father, lson, rson, age, node_pop, root


def _post_order_pops(tree: PopTree):
    order = []

    def rec(pop):
        if tree.sons[pop, 0] >= 0:
            rec(int(tree.sons[pop, 0]))
            rec(int(tree.sons[pop, 1]))
        order.append(pop)

    rec(int(tree.root_pop))
    return order


def init_gen_state_fast(tree: PopTree, params: Params, seed: int,
                        num_loci: int, mut_rates: np.ndarray,
                        max_migs: int = MAX_MIGS,
                        dtype=np.float64) -> GenState:
    """Vectorized random genealogies for all loci (production path).

    Same coalescent simulation as random_genealogy
    (reference GetRandomGtree/Coalescence1Pop, src/patch.c:241-360) but
    batched over loci with numpy — masked coalescence steps per population
    in post-order — instead of a per-locus Python loop.  Uses a numpy
    Generator rather than the legacy per-locus WH streams (the legacy
    loop is the conformance path; at 37K+ loci it costs minutes of host
    time while this runs in well under a second).
    """
    L = num_loci
    S = tree.num_samples
    N = 2 * S - 1
    rng = np.random.default_rng(seed)
    father = np.full((L, N), -1, np.int64)
    lson = np.full((L, N), -1, np.int64)
    rson = np.full((L, N), -1, np.int64)
    age = np.zeros((L, N), dtype)
    node_pop = np.zeros((L, N), np.int64)
    next_node = np.full(L, S, np.int64)
    ar = np.arange(L)

    cum = np.concatenate([[0], np.cumsum(tree.samples_per_pop)])
    # survivor sets per pop: ids [L, S] (unused slots -1) + counts [L]
    surv_ids = {}
    surv_k = {}
    for pop in _post_order_pops(tree):
        if pop < tree.num_cur_pops:
            lo, hi = int(cum[pop]), int(cum[pop + 1])
            k = np.full(L, hi - lo, np.int64)
            living = np.full((L, S), -1, np.int64)
            living[:, :hi - lo] = np.arange(lo, hi)
            node_pop[:, lo:hi] = pop
            age[:, lo:hi] = tree.sample_age[pop]
            T = np.full(L, tree.sample_age[pop], dtype)
        else:
            s0, s1 = int(tree.sons[pop, 0]), int(tree.sons[pop, 1])
            kl, kr = surv_k[s0], surv_k[s1]
            k = kl + kr
            living = np.full((L, S), -1, np.int64)
            living[:, :S] = surv_ids[s0]
            # append right survivors after the left ones, column by column
            for j in range(S):
                dst = kl + j
                m = (j < kr) & (dst < S)
                living[ar[m], dst[m]] = surv_ids[s1][m, j]
            T = np.full(L, params.tau[pop], dtype)
        fa_pop = int(tree.father[pop])
        top = params.tau[fa_pop] if fa_pop >= 0 else np.inf
        stopped = np.zeros(L, bool)
        for _ in range(S - 1):
            active = (k > 1) & ~stopped
            if not active.any():
                break
            kk = np.maximum(k, 2).astype(dtype)
            mean = params.theta[pop] / (kk * (kk - 1.0))
            t = rng.exponential(mean)
            T = np.where(active, T + t, T)
            exceeded = active & (T > top)
            stopped |= exceeded
            go = active & ~exceeded
            c1 = np.minimum((k * rng.random(L)).astype(np.int64), k - 1)
            node1 = living[ar, c1]
            living[ar[go], c1[go]] = living[ar[go], (k - 1)[go]]
            c2 = np.minimum(((k - 1) * rng.random(L)).astype(np.int64),
                            np.maximum(k - 2, 0))
            node2 = living[ar, c2]
            nid = next_node
            living[ar[go], c2[go]] = nid[go]
            g = ar[go]
            rson[g, nid[go]] = node1[go]
            lson[g, nid[go]] = node2[go]
            age[g, nid[go]] = T[go]
            father[g, node1[go]] = nid[go]
            father[g, node2[go]] = nid[go]
            node_pop[g, nid[go]] = pop
            next_node = np.where(go, next_node + 1, next_node)
            k = np.where(go, k - 1, k)
        surv_ids[pop] = living
        surv_k[pop] = k
    root = next_node - 1
    return GenState(
        father=father.astype(np.int32), lson=lson.astype(np.int32),
        rson=rson.astype(np.int32), age=age,
        node_pop=node_pop.astype(np.int32), root=root.astype(np.int32),
        mig_branch=np.full((num_loci, max_migs), -1, np.int32),
        mig_band=np.zeros((num_loci, max_migs), np.int32),
        mig_age=np.zeros((num_loci, max_migs), dtype),
        mut_rate=np.asarray(mut_rates, dtype),
        valid=np.ones(num_loci, bool),
    )


def init_gen_state(tree: PopTree, params: Params, rng: HostRng,
                   num_loci: int, mut_rates: np.ndarray,
                   max_migs: int = MAX_MIGS, dtype=np.float64) -> GenState:
    """Random genealogies for all loci, stacked into a GenState (numpy)."""
    S = tree.num_samples
    N = 2 * S - 1
    father = np.zeros((num_loci, N), np.int32)
    lson = np.zeros((num_loci, N), np.int32)
    rson = np.zeros((num_loci, N), np.int32)
    age = np.zeros((num_loci, N), dtype)
    node_pop = np.zeros((num_loci, N), np.int32)
    root = np.zeros(num_loci, np.int32)
    for g in range(num_loci):
        fa, ls, rs, ag, npop, rt = random_genealogy(tree, params, rng, g)
        father[g], lson[g], rson[g] = fa, ls, rs
        age[g], node_pop[g], root[g] = ag, npop, rt
    return GenState(
        father=father, lson=lson, rson=rson, age=age, node_pop=node_pop,
        root=root,
        mig_branch=np.full((num_loci, max_migs), -1, np.int32),
        mig_band=np.zeros((num_loci, max_migs), np.int32),
        mig_age=np.zeros((num_loci, max_migs), dtype),
        mut_rate=np.asarray(mut_rates, dtype),
        valid=np.ones(num_loci, bool),
    )
