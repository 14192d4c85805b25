"""The benchmark's data: a sequence file simulated from `--seed`.

For every locus a genealogy is drawn from the coalescent prior without
migration (coalescences in each population, the populations from the
leaves up, at the rate k (k - 1) / theta), and the sequences evolve down it
under Jukes-Cantor (each edge mutates Binomial(bp, p) sites, p = 3/4 (1 -
exp(-4 t / 3)), each by a uniform shift to another base).  theta and tau
are drawn as G-PhoCS starts its chain: each population's prior mean times
U(0.9, 1.1), a tau above its father's pulled below it.  A diploid sample is
written as one genotype, with the IUPAC code at heterozygous sites, in the
format G-PhoCS reads:

    <loci>
    <locus name> <samples> <bp>
    <sample name> <sequence>
    ...

A locus length is either one number of sites for every locus, or {"min":
a, "max": b}: each locus's length drawn uniformly from a..b, its sites the
first of a block simulated at the block's longest.  Everything is
vectorized over loci in blocks with NumPy, and the same seed gives the same
file.  Nothing of the program under test is imported.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.control import Control

BASES = np.frombuffer(b"TCAG", np.uint8)
# genotype of two bases: the base itself, or the IUPAC code of the pair
_IUPAC = {frozenset("TC"): "Y", frozenset("TG"): "K", frozenset("TA"): "W",
          frozenset("CG"): "S", frozenset("AC"): "M", frozenset("AG"): "R"}
GENOTYPE = np.array([[ord(a) if a == b else ord(_IUPAC[frozenset(a + b)])
                      for b in "TCAG"] for a in "TCAG"], np.uint8)
BLOCK = 2048


def draw_params(ctl: Control, rng: np.random.Generator):
    """theta [P], tau [P] (0 for current populations): the prior means
    times U(0.9, 1.1), in pre-order from the root."""
    P = ctl.num_pops
    theta, tau = np.zeros(P), np.zeros(P)
    fa = ctl.father
    order = [P - 1]
    for p in order:
        pop = ctl.pops[p]
        theta[p] = pop.theta_alpha / pop.theta_beta * rng.uniform(0.9, 1.1)
        if pop.children:
            tau[p] = pop.tau_initial * rng.uniform(0.9, 1.1)
            if fa[p] >= 0 and tau[fa[p]] < tau[p]:
                lo = max(ctl.pops[ctl.index(c)].sample_age
                         for c in pop.children)
                tau[p] = lo + (tau[fa[p]] - lo) * rng.uniform(0.93, 0.934)
            order += [ctl.index(c) for c in pop.children]
    return theta, tau


def genealogies(ctl: Control, theta, tau, L: int, rng):
    """L genealogies: father [L, N], lson, rson, age [L, N].  Internal
    nodes are numbered in the order they coalesce, so every node's father
    has a larger number and the root is N - 1."""
    slots = ctl.slots
    S = len(slots)
    N = 2 * S - 1
    father = np.full((L, N), -1, np.int64)
    sons = np.full((L, N, 2), -1, np.int64)
    age = np.zeros((L, N))
    nxt = np.full(L, S, np.int64)
    ar = np.arange(L)
    fa = ctl.father

    def coalesce(p):
        pop = ctl.pops[p]
        if not pop.children:
            ids = [s for s, sl in enumerate(slots) if sl["pop"] == p]
            lin = np.full((L, S), -1, np.int64)
            lin[:, :len(ids)] = ids
            age[:, ids] = pop.sample_age
            k = np.full(L, len(ids), np.int64)
            t = np.full(L, pop.sample_age)
        else:
            (la, ka), (lb, kb) = (coalesce(ctl.index(c))
                                  for c in pop.children)
            both = np.concatenate([la, lb], axis=1)
            lin = np.take_along_axis(
                both, np.argsort(both < 0, axis=1, kind="stable"),
                axis=1)[:, :S]
            k = ka + kb
            t = np.full(L, tau[p])
        end = tau[fa[p]] if fa[p] >= 0 else np.inf
        live = k >= 2
        while live.any():
            w = rng.exponential(size=L) * theta[p] / np.maximum(k * (k - 1),
                                                                 1)
            live &= (k >= 2) & (t + w < end)
            i = np.minimum((rng.random(L) * k).astype(np.int64), k - 1)
            j = np.minimum((rng.random(L) * (k - 1)).astype(np.int64),
                           np.maximum(k - 2, 0))
            j = np.where(j >= i, j + 1, j)
            li = np.nonzero(live)[0]
            a, b = lin[li, i[li]], lin[li, j[li]]
            new = nxt[li]
            father[li, a] = new
            father[li, b] = new
            sons[li, new, 0], sons[li, new, 1] = a, b
            age[li, new] = t[li] + w[li]
            t[li] = t[li] + w[li]
            lin[li, i[li]] = new
            lin[li, j[li]] = lin[li, k[li] - 1]
            lin[li, k[li] - 1] = -1
            k[li] -= 1
            nxt[li] += 1
        return lin, k

    lin, k = coalesce(ctl.num_pops - 1)
    assert (k == 1).all() and (lin[:, 0] == N - 1).all()
    return father, sons[..., 0], sons[..., 1], age


def evolve(lson, rson, age, bp: int, rng) -> np.ndarray:
    """[L, S, bp] base codes (0..3 = TCAG) of the leaves under JC."""
    L, N = age.shape
    S = (N + 1) // 2
    seq = np.zeros((L, N, bp), np.int8)
    seq[:, N - 1] = rng.integers(0, 4, (L, bp), dtype=np.int8)
    ar = np.arange(L)
    for v in range(N - 1, S - 1, -1):
        for child in (lson[:, v], rson[:, v]):
            t = age[:, v] - age[ar, child]
            p = 0.75 * -np.expm1(-4.0 * t / 3.0)
            n = rng.binomial(bp, np.clip(p, 0.0, 1.0))
            seq[ar, child] = seq[:, v]
            loc = np.repeat(ar, n)
            pos = rng.integers(0, bp, loc.size)
            shift = rng.integers(1, 4, loc.size, dtype=np.int8)
            np.add.at(seq, (loc, child[loc], pos), shift)
            seq[ar, child] %= 4
    return seq[:, :S]


def write_seq_file(path: str, ctl: Control, num_loci: int, bp,
                   seed: int) -> dict:
    """Write num_loci loci simulated from `seed` to `path`, of bp sites
    each, or of lengths drawn from bp = {"min": a, "max": b}; returns the
    theta and tau that were drawn."""
    rng = np.random.default_rng(seed)
    theta, tau = draw_params(ctl, rng)
    if isinstance(bp, dict):
        lengths = rng.integers(int(bp["min"]), int(bp["max"]) + 1, num_loci)
    else:
        lengths = np.full(num_loci, int(bp))
    slots = ctl.slots
    samples = [(i, s) for i, s in enumerate(slots) if s["first"]]
    names = [(s["name"] + " ").encode() for _, s in samples]
    with open(path, "wb") as f:
        f.write(f"{num_loci}\n".encode())
        for lo in range(0, num_loci, BLOCK):
            n = min(BLOCK, num_loci - lo)
            width = int(lengths[lo:lo + n].max())
            _, ls, rs, age = genealogies(ctl, theta, tau, n, rng)
            leaves = evolve(ls, rs, age, width, rng)
            rows = np.empty((n, len(samples), width), np.uint8)
            for k, (i, s) in enumerate(samples):
                rows[:, k] = (GENOTYPE[leaves[:, i], leaves[:, i + 1]]
                              if s["diploid"] else BASES[leaves[:, i]])
            out = []
            for l in range(n):
                b = int(lengths[lo + l])
                out.append(f"locus{lo + l} {len(samples)} {b}\n".encode())
                out += [nm + rows[l, k, :b].tobytes() + b"\n"
                        for k, nm in enumerate(names)]
            f.write(b"".join(out))
    return {"theta": theta.tolist(), "tau": tau.tolist()}
