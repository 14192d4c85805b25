"""Population tree as flat arrays.

The reference models the population tree with linked Population structs and
MigrationBand structs (reference: src/PopulationTree.h / .c).  Here the
static structure (topology, priors, band endpoints) lives in numpy arrays
inside a frozen `PopTree`; the *sampled* quantities (theta, tau,
sample ages, migration rates) live in the `Params` pytree of state.py so
they can flow through jitted kernels.

Population indexing follows the reference convention: current pops first
(0..numCurPops-1, in control-file order), then ancestral pops; the root is
the last ancestral pop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from gphocs_tpu_torch.config.settings import RunConfig
from gphocs_tpu_torch.config.control import ancestry_matrix


@dataclass(frozen=True)
class PopTree:
    names: List[str]
    num_pops: int
    num_cur_pops: int
    root_pop: int
    father: np.ndarray        # [P] int32, -1 for root
    sons: np.ndarray          # [P, 2] int32, -1 for current pops
    is_ancestral: np.ndarray  # [P, P] bool; is_ancestral[i, j]: i ancestor-or-self of j
    # priors
    theta_alpha: np.ndarray   # [P]
    theta_beta: np.ndarray
    tau_alpha: np.ndarray     # [P] (only ancestral entries meaningful)
    tau_beta: np.ndarray
    tau_initial: np.ndarray   # [P] init sampling start (prior mean fallback)
    sample_age: np.ndarray    # [P] configured ancient-sample age (current pops)
    update_sample_age: np.ndarray  # [P] bool
    # samples
    num_samples: int
    sample_pop: np.ndarray    # [S] int32 pop of each haploid sample slot
    samples_per_pop: np.ndarray  # [numCurPops]
    # migration bands
    num_bands: int
    band_source: np.ndarray   # [B] int32
    band_target: np.ndarray   # [B] int32
    mig_alpha: np.ndarray     # [B]
    mig_beta: np.ndarray      # [B]
    # admixed samples
    admix_slot: np.ndarray    # [A] int32 haploid slot ids
    admix_pops: np.ndarray    # [A, 2] int32 (first pop, second pop)
    # trace output scaling
    theta_print: np.ndarray   # [P]
    tau_print: np.ndarray     # [P]
    mig_print: np.ndarray     # [B]

    @property
    def num_anc_pops(self) -> int:
        return self.num_pops - self.num_cur_pops


def build_poptree(cfg: RunConfig) -> PopTree:
    P = cfg.num_pops
    idx = cfg.pop_index()
    father = np.full(P, -1, np.int32)
    sons = np.full((P, 2), -1, np.int32)
    for p in cfg.anc_pops:
        i = idx[p.name]
        for k, ch in enumerate(p.children):
            j = idx[ch]
            sons[i, k] = j
            father[j] = i
    anc = np.array(ancestry_matrix(cfg), dtype=bool)

    pops = cfg.pops
    theta_alpha = np.array([p.theta_alpha for p in pops])
    theta_beta = np.array([p.theta_beta for p in pops])
    tau_alpha = np.array([max(p.tau_alpha, 0.0) for p in pops])
    tau_beta = np.array([max(p.tau_beta, 1.0) for p in pops])
    tau_initial = np.array(
        [p.tau_initial if p.tau_initial > 0 else 0.0 for p in pops]
    )
    sample_age = np.array([p.sample_age for p in pops])
    update_sample_age = np.array([p.update_sample_age for p in pops])

    sample_pop = []
    for pi, p in enumerate(cfg.cur_pops):
        for _, fmt in p.samples:
            sample_pop.append(pi)
            if fmt == "d":
                sample_pop.append(pi)
    sample_pop = np.array(sample_pop, np.int32)

    adm = cfg.admixed_slots()
    admix_slot = np.array([a[0] for a in adm], np.int32)
    admix_pops = np.array([[a[1], a[2]] for a in adm], np.int32).reshape(-1, 2)

    band_source = np.array([idx[b.source] for b in cfg.bands], np.int32)
    band_target = np.array([idx[b.target] for b in cfg.bands], np.int32)
    mig_alpha = np.array([b.mig_rate_alpha for b in cfg.bands])
    mig_beta = np.array([b.mig_rate_beta for b in cfg.bands])

    return PopTree(
        names=[p.name for p in pops],
        num_pops=P,
        num_cur_pops=cfg.num_cur_pops,
        root_pop=P - 1 if cfg.anc_pops else 0,
        father=father,
        sons=sons,
        is_ancestral=anc,
        theta_alpha=theta_alpha,
        theta_beta=theta_beta,
        tau_alpha=tau_alpha,
        tau_beta=tau_beta,
        tau_initial=tau_initial,
        sample_age=sample_age,
        update_sample_age=update_sample_age,
        num_samples=cfg.num_samples,
        sample_pop=sample_pop,
        samples_per_pop=np.array(cfg.samples_per_pop(), np.int32),
        admix_slot=admix_slot,
        admix_pops=admix_pops,
        num_bands=len(cfg.bands),
        band_source=band_source,
        band_target=band_target,
        mig_alpha=mig_alpha,
        mig_beta=mig_beta,
        theta_print=np.array([p.theta_print for p in pops]),
        tau_print=np.array([p.tau_print for p in pops]),
        mig_print=np.array([b.mig_rate_print for b in cfg.bands]),
    )


def band_times(tree: PopTree, tau: np.ndarray):
    """Start/end times of every migration band given pop ages tau[P]
    (reference: src/PopulationTree.c:439-505).

    start = max(tau[source], tau[target]);
    end = min(tau[father(source)], tau[father(target)]).
    Zero-span bands are collapsed to [tau[target], tau[target]].
    Numpy arrays only (tensors use kernels/common.band_windows).
    """
    if tree.num_bands == 0:
        z = np.zeros((0,), tau.dtype)
        return z, z
    fa = tree.father
    src, tgt = tree.band_source, tree.band_target
    start = np.maximum(tau[src], tau[tgt])
    end = np.minimum(tau[fa[src]], tau[fa[tgt]])
    collapsed = start >= end
    start = np.where(collapsed, tau[tgt], start)
    end = np.where(collapsed, tau[tgt], end)
    return start, end
