"""The plain reference against hand-worked cases: JC pruning with
phasings, the coalescent prior with migration in closed form, and
perturbed states that the comparison must refuse."""

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark.reference import control, judge, likelihood, patterns, prior
from benchmark.reference import validity

TWO_DIPLOIDS = """
GENERAL-INFO-START
    tau-theta-alpha 1.0
    tau-theta-beta 10000.0
    mig-rate-alpha 0.002
    mig-rate-beta 0.00001
GENERAL-INFO-END
CURRENT-POPS-START
    POP-START
        name A
        samples a d
    POP-END
    POP-START
        name B
        samples b d
    POP-END
CURRENT-POPS-END
ANCESTRAL-POPS-START
    POP-START
        name AB
        children A B
        tau-initial 0.0001
    POP-END
ANCESTRAL-POPS-END
MIG-BANDS-START
    BAND-START
        source A
        target B
    BAND-END
MIG-BANDS-END
"""
TWO_HAPLOIDS = TWO_DIPLOIDS.replace("a d", "a h").replace("b d", "b h")


def brute(leaves, ages, t_root):
    """P(leaf bases | genealogy ((0,2):t4, (1,3):t5) at t_root), summing
    over the internal nodes' bases."""
    def p(a, b, t):
        e = math.exp(-4.0 * t / 3.0)
        return 0.25 + 0.75 * e if a == b else 0.25 - 0.25 * e

    t4, t5 = ages
    total = 0.0
    for x6, x4, x5 in itertools.product(range(4), repeat=3):
        total += (0.25 * p(x6, x4, t_root - t4) * p(x6, x5, t_root - t5)
                  * p(x4, leaves[0], t4) * p(x4, leaves[2], t4)
                  * p(x5, leaves[1], t5) * p(x5, leaves[3], t5))
    return total


def test_jc_pruning_with_phasings(tmp_path):
    # locus0: columns (A,A) (R,A) (A,G), each once: the het column is
    # phased arbitrarily (symmetry breaking); locus1: (R,A) twice, both
    # phasings averaged
    path = tmp_path / "seqs.txt"
    path.write_text("2\nl0 2 3\na ARA\nb AAG\nl1 2 2\na RR\nb AA\n")
    ctl = control.parse(TWO_DIPLOIDS)
    pats = patterns.build(str(path), ctl)
    ages = (0.05, 0.08)
    gen = {"lson": torch.tensor([[-1, -1, -1, -1, 0, 1, 4]] * 2),
           "rson": torch.tensor([[-1, -1, -1, -1, 2, 3, 5]] * 2),
           "age": torch.tensor([[0, 0, 0, 0, *ages, 0.2]] * 2,
                               dtype=torch.float64),
           "root": torch.tensor([6, 6]),
           "mut_rate": torch.ones(2, dtype=torch.float64)}
    got = likelihood.log_likelihood(
        gen, *(torch.as_tensor(x) for x in (pats.leaf, pats.group,
                                              pats.count, pats.nphases)))
    # canonical columns: (A,A) -> (T,T); (R,A) -> (Y,T), Y fixed as T|C;
    # (A,G) -> (T,C)
    T, C = 0, 1
    want0 = (math.log(brute((T, T, T, T), ages, 0.2))
             + math.log(brute((T, C, T, T), ages, 0.2))
             + math.log(brute((T, T, C, C), ages, 0.2)))
    want1 = 2 * math.log((brute((T, C, T, T), ages, 0.2)
                          + brute((C, T, T, T), ages, 0.2)) / 2)
    assert pats.nphases[0].tolist()[:3] == [1, 1, 1]
    assert pats.nphases[1, 0] == 2 and pats.count[1, 0] == 2
    assert got.tolist() == pytest.approx([want0, want1], rel=1e-13)


def two_leaf_state(t, s, M=3):
    """Leaf 0 in A, leaf 1 in B, their coalescence in AB at t; one
    migration event (band A -> B) on leaf 1's edge at s."""
    return {"father": torch.tensor([[2, 2, -1]]),
            "lson": torch.tensor([[-1, -1, 0]]),
            "rson": torch.tensor([[-1, -1, 1]]),
            "age": torch.tensor([[0.0, 0.0, t]], dtype=torch.float64),
            "node_pop": torch.tensor([[0, 1, 2]]),
            "root": torch.tensor([2]),
            "mig_branch": torch.tensor([[1] + [-1] * (M - 1)]),
            "mig_band": torch.tensor([[0] * M]),
            "mig_age": torch.tensor([[s] + [0.0] * (M - 1)],
                                    dtype=torch.float64),
            "mut_rate": torch.ones(1, dtype=torch.float64),
            "valid": torch.ones(1, dtype=torch.bool)}


def test_coalescent_prior_closed_form():
    ctl = control.parse(TWO_HAPLOIDS)
    tree = prior.Tree(ctl, "cpu")
    th = torch.tensor([[1.1e-4, 0.9e-4, 1.3e-4]], dtype=torch.float64)
    tau = torch.tensor([[0.0, 0.0, 1e-4]], dtype=torch.float64)
    m = torch.tensor([[150.0]], dtype=torch.float64)
    t, s = 3e-4, 4e-5
    got = prior.log_prior(two_leaf_state(t, s), th, tau, m, tree)
    # B's lineage migrates to A at s (going back): from s to tau both
    # lineages are in A, from tau to t in AB; B's lineage is exposed to
    # the band from 0 to s
    thA, thAB, tu = 1.1e-4, 1.3e-4, 1e-4
    want = (math.log(2 / thAB) - 2 * (t - tu) / thAB - 2 * (tu - s) / thA
            + math.log(150.0) - 150.0 * s)
    assert got.item() == pytest.approx(want, rel=1e-13)
    # without the event: A and B hold one lineage each until tau, and B's
    # is exposed to the band over the whole window [0, tau]
    st = two_leaf_state(t, s)
    st["mig_branch"][:] = -1
    got = prior.log_prior(st, th, tau, m, tree)
    want = math.log(2 / thAB) - 2 * (t - tu) / thAB - 150.0 * tu
    assert got.item() == pytest.approx(want, rel=1e-13)
    sage = torch.zeros_like(th)
    slot_pop = torch.tensor([0, 1])
    assert validity.violations(two_leaf_state(t, s), th, tau, m, sage,
                               slot_pop, tree).tolist() == [0]


@pytest.mark.parametrize("fault", ["age", "event_outside_band",
                                   "event_below_node", "lnld", "lnp",
                                   "topology_kept", "theta_frozen"])
def test_perturbed_state_fails(fault):
    ctl = control.parse(TWO_HAPLOIDS)
    th = np.array([[1.1e-4, 0.9e-4, 1.3e-4]])
    tau = np.array([[0.0, 0.0, 1e-4]])
    m = np.array([[150.0]])
    gen = {k: v.numpy() for k, v in two_leaf_state(3e-4, 4e-5).items()}
    prog = dict(gen, theta=th, tau=tau, mig_rate=m,
                sample_age=np.zeros_like(th))
    pats = patterns.Patterns(leaf=np.array([[[0, 1]]], np.int8),
                             group=np.array([[0]]), count=np.array([[5.0]]),
                             nphases=np.ones((1, 1)))
    ref = judge.reference_values(prog, pats, ctl, "cpu")
    assert ref["invalid"].tolist() == [0]
    prog.update(lnld=ref["lnld"].copy(), lnp=ref["lnp"].copy(),
                lnld_sum=ref["lnld"].copy(), lnp_sum=ref["lnp"].copy(),
                age0=gen["age"] * 0.5, mig_age0=gen["mig_age"],
                father0=gen["father"][:, ::-1].copy(), theta0=th * 0.9,
                tau0=tau * 0.9, mig_rate0=m * 0.9)
    limits = {"lnld_gap": 1e-3, "lnp_gap": 1e-3, "sum_gap": 1e-6,
              "invalid": 0, "unmoved": 0, "kept_topology": 0.5,
              "frozen_params": 0}
    ok, _ = judge.verdict(judge.numbers(prog, ref), limits)
    assert ok
    bad = {k: v.copy() for k, v in prog.items()}
    if fault == "age":
        bad["age"][0, 2] *= 1.01
    elif fault == "event_outside_band":
        bad["mig_age"][0, 0] = 2e-4          # above tau: no band there
    elif fault == "event_below_node":
        bad["mig_age"][0, 0] = -1e-6
    elif fault == "lnld":
        bad["lnld"][0] += 0.01
    elif fault == "topology_kept":
        bad["father0"] = bad["father"].copy()
    elif fault == "theta_frozen":
        bad["theta0"] = bad["theta"].copy()
    else:
        bad["lnp"][0] -= 0.01
    ref = judge.reference_values(bad, pats, ctl, "cpu")
    ok, rows = judge.verdict(judge.numbers(bad, ref), limits)
    assert not ok, rows


def test_canonical_form_is_the_greedy_one():
    # the greedy mapping of G-PhoCS (each symbol to the lowest one a
    # still-possible permutation allows) is the lexicographic minimum
    table = patterns.canonical_table(3)
    rng = np.random.default_rng(3)
    for code in rng.integers(0, 15 ** 3, 300):
        digits = [code // 225 % 15, code // 15 % 15, code % 15]
        live = list(range(24))
        out = []
        for d in digits:
            low = min(patterns.IMAGES[p, d] for p in live)
            live = [p for p in live if patterns.IMAGES[p, d] == low]
            out.append(low)
        assert table[code] == out[0] * 225 + out[1] * 15 + out[2]
