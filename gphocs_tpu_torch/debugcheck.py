"""State invariant checker — the analogue of the reference's checkAll()
(src/patch.c:2745-2884, checkGtreeStructure :2978-3542); twin of
gphocs_tpu/debugcheck.py, on the port's tensors (moved to numpy with
state.to_numpy).

The reference needs checkAll because its incremental bookkeeping (event
chains, delta stats, saved versions) can drift from the authoritative
state.  Here the only carried quantities are lnld/lnp; everything else is
recomputed functionally.  The checker still validates the structural
invariants of the genealogy/migration tensors after updates, and verifies
the carried likelihoods against fresh recomputation.

`check_gen_state` is fully vectorized over [L, N]/[L, M] arrays so the
--debug-check gate stays usable at the 37K-locus benchmark scale
(measured <1 s at 37K loci vs minutes for the per-locus loops);
`check_gen_state_slow` keeps the original per-locus loops as the oracle
for the vectorized form.
"""

from __future__ import annotations

from typing import List

import numpy as np

import torch

from gphocs_tpu_torch.constants import OLDAGE
from gphocs_tpu_torch.model.poptree import PopTree, band_times
from gphocs_tpu_torch.state import to_numpy


def _collect(errs: List[str], bad: np.ndarray, what: str, limit=5):
    """Append one message per offending locus (first `limit`)."""
    if not bad.any():
        return
    loci = np.unique(np.nonzero(bad)[0])
    for l in loci[:limit]:
        errs.append(f"locus {l}: {what}")
    if len(loci) > limit:
        errs.append(f"... ({len(loci)} loci total for: {what})")


def check_gen_state(gen, params, tree: PopTree, atol=1e-9) -> List[str]:
    """Vectorized invariant scan; returns violation messages (empty if
    consistent).  Math identical to check_gen_state_slow (the oracle)."""
    gen, params = to_numpy(gen), to_numpy(params)
    errs: List[str] = []
    fa = np.asarray(gen.father)
    ls = np.asarray(gen.lson)
    rs = np.asarray(gen.rson)
    age = np.asarray(gen.age)
    npop = np.asarray(gen.node_pop)
    root = np.asarray(gen.root)
    mbr = np.asarray(gen.mig_branch)
    mbd = np.asarray(gen.mig_band)
    mag = np.asarray(gen.mig_age)
    tau = np.asarray(params.tau)
    sage = np.asarray(params.sample_age)
    valid = np.asarray(gen.valid)
    L, N = fa.shape
    S = (N + 1) // 2
    M = mbr.shape[1]
    anc = np.asarray(tree.is_ancestral)
    pop_end = np.where(tree.father >= 0, tau[tree.father], OLDAGE)
    bstart, bend = band_times(tree, tau)
    vl = valid[:, None]

    # -- roots: exactly one fatherless node, and it is gen.root --
    n_roots = (fa < 0).sum(axis=1)
    root_fa = np.take_along_axis(fa, root[:, None], axis=1)[:, 0]
    _collect(errs, valid & ((n_roots != 1) | (root_fa >= 0)),
             "root mismatch (fatherless nodes != [root])")

    # -- father/son links + age ordering (internal nodes) --
    vids = np.arange(S, N)
    for side, sons in (("lson", ls), ("rson", rs)):
        son = sons[:, S:]                                     # [L, NI]
        son_ok = son >= 0
        fa_of_son = np.take_along_axis(fa, np.maximum(son, 0), axis=1)
        _collect(errs, vl & (~son_ok | (fa_of_son != vids[None, :])),
                 f"{side} father link broken")
        age_son = np.take_along_axis(age, np.maximum(son, 0), axis=1)
        _collect(errs, vl & son_ok
                 & (age_son > age[:, S:] + atol),
                 f"node younger than its {side}")

    # -- internal node ages inside their population window --
    p_i = npop[:, S:]
    _collect(errs, vl & ((age[:, S:] < tau[p_i] - atol)
                         | (age[:, S:] > pop_end[p_i] + atol)),
             "internal node age outside pop window")

    # -- leaves: no sons; age equals the pop's sample age --
    _collect(errs, vl & ((ls[:, :S] >= 0) | (rs[:, :S] >= 0)),
             "leaf has sons")
    _collect(errs, vl & (np.abs(age[:, :S] - sage[npop[:, :S]]) > atol),
             "leaf age != sample age")

    # -- migration events: on live edges, inside band windows --
    act = mbr >= 0
    br = np.maximum(mbr, 0)
    bd = np.where(act, mbd, 0)
    fa_br = np.take_along_axis(fa, br, axis=1)
    top = np.where(fa_br >= 0,
                   np.take_along_axis(age, np.maximum(fa_br, 0), axis=1),
                   OLDAGE)
    child = np.take_along_axis(age, br, axis=1)
    _collect(errs, vl & act & ((mag < child - atol) | (mag > top + atol)),
             "mig age outside its edge interval")
    _collect(errs, vl & act & ((mag < bstart[bd] - atol)
                               | (mag > bend[bd] + atol)),
             "mig age outside its band window")

    # -- per-edge trajectories: each mig's lineage pop just below it must
    # sit under the band's target; edge-top pop must cover the last
    # segment's pop (vectorized over the [L, M, M] neighbor lattice) --
    if M > 0:
        same = (act[:, :, None] & act[:, None, :]
                & (mbr[:, :, None] == mbr[:, None, :]))
        idx = np.arange(M)
        below_rel = same & ((mag[:, None, :] < mag[:, :, None])
                            | ((mag[:, None, :] == mag[:, :, None])
                               & (idx[None, None, :] < idx[None, :, None])))
        key = np.where(below_rel, mag[:, None, :], -np.inf)
        prev = np.argmax(key, axis=2)                        # [L, M]
        has_prev = np.isfinite(np.max(key, axis=2))
        prev_band = np.take_along_axis(bd, prev, axis=1)
        below_pop = np.where(
            has_prev, np.asarray(tree.band_source)[prev_band],
            np.take_along_axis(npop, br, axis=1))
        tgt = np.asarray(tree.band_target)[bd]
        src = np.asarray(tree.band_source)[bd]
        _collect(errs, vl & act & ~anc[tgt, below_pop],
                 "mig lineage pop not under the band target")
        _collect(errs, vl & act & ((mag < tau[tgt] - atol)
                                   | (mag > pop_end[tgt] + atol)),
                 "mig age outside the target pop window")
        # topmost mig per edge -> its source must sit under the father pop
        above_rel = same & ((mag[:, None, :] > mag[:, :, None])
                            | ((mag[:, None, :] == mag[:, :, None])
                               & (idx[None, None, :] > idx[None, :, None])))
        is_top = act & ~above_rel.any(axis=2)
        fpop = np.take_along_axis(npop, np.maximum(fa_br, 0), axis=1)
        _collect(errs, vl & is_top & (fa_br >= 0) & ~anc[fpop, src],
                 "edge trajectory ends outside the father pop")
    # edges with no migs: node pop must sit under father pop
    no_mig = np.ones((L, N), bool)
    if M > 0:
        onb = act[:, None, :] & (mbr[:, None, :]
                                 == np.arange(N)[None, :, None])
        no_mig = ~onb.any(axis=2)
    fa_all = np.maximum(fa, 0)
    fpop_all = np.take_along_axis(npop, fa_all, axis=1)
    _collect(errs, vl & no_mig & (fa >= 0) & ~anc[fpop_all, npop],
             "edge pop not under father pop")
    return errs


def check_gen_state_slow(gen, params, tree: PopTree, atol=1e-9) -> List[str]:
    """Original per-locus loop form — kept as the oracle for the
    vectorized checker (identical violation classes)."""
    errs: List[str] = []
    fa = np.asarray(gen.father)
    ls = np.asarray(gen.lson)
    rs = np.asarray(gen.rson)
    age = np.asarray(gen.age)
    npop = np.asarray(gen.node_pop)
    root = np.asarray(gen.root)
    mbr = np.asarray(gen.mig_branch)
    mbd = np.asarray(gen.mig_band)
    mag = np.asarray(gen.mig_age)
    tau = np.asarray(params.tau)
    sage = np.asarray(params.sample_age)
    L, N = fa.shape
    S = (N + 1) // 2
    anc = tree.is_ancestral
    pop_end = np.where(tree.father >= 0, tau[tree.father], OLDAGE)
    bstart, bend = band_times(tree, tau)

    for l in range(L):
        roots = [v for v in range(N) if fa[l, v] < 0]
        if roots != [root[l]]:
            errs.append(f"locus {l}: root mismatch {roots} vs {root[l]}")
            continue
        for v in range(S, N):
            for son in (ls[l, v], rs[l, v]):
                if son < 0 or fa[l, son] != v:
                    errs.append(f"locus {l}: node {v} son {son} father "
                                f"link broken")
                elif age[l, son] > age[l, v] + atol:
                    errs.append(f"locus {l}: node {v} younger than son {son}")
            p = npop[l, v]
            if not (tau[p] - atol <= age[l, v] <= pop_end[p] + atol):
                errs.append(f"locus {l}: node {v} age {age[l, v]} outside "
                            f"pop {p} window [{tau[p]}, {pop_end[p]}]")
        for v in range(S):
            if ls[l, v] >= 0 or rs[l, v] >= 0:
                errs.append(f"locus {l}: leaf {v} has sons")
            expected = sage[npop[l, v]]
            if abs(age[l, v] - expected) > atol:
                errs.append(f"locus {l}: leaf {v} age {age[l, v]} != "
                            f"sample age {expected}")

        # migration events: on live edges, inside band windows, ordered
        # trajectories consistent with node pops
        for m in range(mbr.shape[1]):
            if mbr[l, m] < 0:
                continue
            v, b, t = mbr[l, m], mbd[l, m], mag[l, m]
            top = age[l, fa[l, v]] if fa[l, v] >= 0 else OLDAGE
            if not (age[l, v] - atol <= t <= top + atol):
                errs.append(f"locus {l}: mig {m} age {t} outside edge {v} "
                            f"[{age[l, v]}, {top}]")
            if not (bstart[b] - atol <= t <= bend[b] + atol):
                errs.append(f"locus {l}: mig {m} age {t} outside band {b} "
                            f"window [{bstart[b]}, {bend[b]}]")
        # per-edge trajectory check
        for v in range(N):
            migs = sorted((mag[l, m], mbd[l, m])
                          for m in range(mbr.shape[1]) if mbr[l, m] == v)
            cur = npop[l, v]
            for (t, b) in migs:
                tgt = tree.band_target[b]
                src = tree.band_source[b]
                if not anc[tgt, cur]:
                    errs.append(f"locus {l}: mig on edge {v} band {b} at {t}:"
                                f" lineage pop {cur} not under target {tgt}")
                if not (tau[tgt] - atol <= t <= pop_end[tgt] + atol):
                    errs.append(f"locus {l}: mig at {t} outside target pop "
                                f"{tgt} window")
                cur = src
            if fa[l, v] >= 0:
                fpop = npop[l, fa[l, v]]
                if not anc[fpop, cur]:
                    errs.append(f"locus {l}: edge {v} trajectory ends in pop "
                                f"{cur}, father pop {fpop} not ancestral")
    return errs


def check_likelihoods(sampler) -> List[str]:
    """Verify every bucket's carried lnld/lnp against a recomputation
    (analogue of checkLocusDataLikelihood, src/LocusDataLikelihood.c:717).

    A value passes within atol + rtol * |recomputed|: at float64 1e-8 and 0
    (gphocs_tpu's test); at float32 1e-3 and 1e-5.  The carried values take
    a kernel's and a rebuild's roundings in another order, and a locus's
    prior is a difference of terms some 1e3 times larger than itself, so
    float32 drifts by tens of ulps of those terms (3e-5 on a 4,000-locus
    run); a wrong move shifts a value by far more.  A sampler of C chains
    is checked chain by chain, as gphocs_tpu does."""
    from gphocs_tpu_torch.kernels.common import gen_log_prior
    from gphocs_tpu_torch.ops.pruning import data_log_likelihood

    f32 = sampler.dtype == torch.float32
    atol, rtol = (1e-3, 1e-5) if f32 else (1e-8, 0.0)
    C = getattr(sampler, "chains", 1)
    errs = []
    for k, (g, sq) in enumerate(zip(sampler.gens, sampler.seqs)):
        pre = f"bucket {k}: " if sampler.buckets > 1 else ""
        for what, fresh, carried in (
                ("data lnL", data_log_likelihood(g, sq), sampler.lnlds[k]),
                ("genealogy prior",
                 gen_log_prior(g, sampler.params, sampler.ctx),
                 sampler.lnps[k])):
            fresh = fresh.double()
            d = (fresh - carried.double()).abs()
            bad = (d > atol + rtol * fresh.abs()).reshape(C, -1).any(dim=1)
            dmax = d.reshape(C, -1).amax(dim=1)
            for c in bad.nonzero().flatten().tolist():
                chain = f"chain {c}: " if C > 1 else ""
                errs.append(f"{pre}{chain}carried {what} drift "
                            f"{float(dmax[c])}")
    return errs
