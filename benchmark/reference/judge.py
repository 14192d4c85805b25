"""The comparison that decides a run's `correct`.

The program hands over, once its window has closed, its final state for
every chain (genealogies, migration events, theta, tau, m, locus rates),
its carried per-locus lnld and lnp, the sums in its last trace row, and
the ages it held when the window opened.  The plain reference works out
every locus's patterns from the sequence file, and from the program's
genealogies its lnld, its ln prior and the state's validity.  Compared,
each against its limit (the configuration's file):

  lnld_gap  largest |carried lnld - reference lnld| over (chain, locus)
  lnp_gap   largest |carried lnp - reference lnp|
  sum_gap   largest relative gap between a trace row's lnld or lnp sum
            and the reference's sum, over the chains
  invalid   broken conditions of the state (validity.py); limit 0
  unmoved   (chain, locus) rows whose ages and migration ages are
            bitwise those of the window's start; limit 0
  kept_topology  the share of (chain, locus) rows whose topology (every
            node's father) is bitwise that of the window's start: the SPR
            sweep moves it, no other update does
  frozen_params  (chain, family) pairs of which every value is bitwise
            that of the window's start, the families being theta (every
            population), tau (every ancestral population) and the
            migration rates (every band); limit 0

The control puts the reference, computed in a lower precision, in the
program's place (`control_values`).  Plain torch and NumPy; nothing of the
program under test is imported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import likelihood, patterns, prior, validity
from benchmark.reference.control import Control

GEN = ("father", "lson", "rson", "age", "node_pop", "root", "mig_branch",
       "mig_band", "mig_age", "mut_rate", "valid")
ORDER = ("lnld_gap", "lnp_gap", "sum_gap", "invalid", "unmoved",
         "kept_topology", "frozen_params")
BLOCK = 8192
HUGE = float(np.finfo(np.float64).max)


def reference_values(prog: dict, pats: patterns.Patterns, ctl: Control,
                     device, dtype=torch.float64, block: int = BLOCK):
    """Per (chain, locus) row: the reference's lnld, lnp (numpy float64)
    and validity count (numpy int64), in blocks of rows; and the columns
    of each family of parameters that the sampler moves ("families")."""
    tree = prior.Tree(ctl, device)
    slot_pop = torch.tensor([s["pop"] for s in ctl.slots], device=device)
    rows = prog["age"].shape[0]
    L = pats.num_loci
    C = rows // L
    if C * L != rows:
        raise ValueError(f"{rows} rows for {L} loci")
    out = {k: np.zeros(rows) for k in ("lnld", "lnp")}
    out["invalid"] = np.zeros(rows, np.int64)
    out["families"] = {
        "theta": list(range(ctl.num_pops)),
        "tau": [p for p, pop in enumerate(ctl.pops) if pop.children],
        "mig_rate": list(range(len(ctl.bands)))}
    for lo in range(0, rows, block):
        r = np.arange(lo, min(rows, lo + block))
        loc, ch = r % L, r // L
        gen = {k: torch.as_tensor(prog[k][r], device=device) for k in GEN}
        par = {k: torch.as_tensor(prog[k][ch], device=device)
               for k in ("theta", "tau", "mig_rate", "sample_age")}
        leaf = torch.as_tensor(pats.leaf[loc], device=device)
        group = torch.as_tensor(pats.group[loc], device=device)
        count = torch.as_tensor(pats.count[loc], device=device)
        nph = torch.as_tensor(pats.nphases[loc], device=device)
        out["lnld"][r] = likelihood.log_likelihood(
            gen, leaf, group, count, nph, dtype).double().cpu().numpy()
        out["lnp"][r] = prior.log_prior(
            gen, par["theta"], par["tau"], par["mig_rate"], tree,
            dtype).double().cpu().numpy()
        bad = validity.violations(gen, par["theta"], par["tau"],
                                  par["mig_rate"], par["sample_age"],
                                  slot_pop, tree)
        bad = bad + (~gen["valid"]).to(bad.dtype)
        out["invalid"][r] = bad.cpu().numpy()
    return out


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of `prog` (the program's outputs, or the
    control's values in their place) against the reference's `ref`."""
    C = prog["lnld_sum"].shape[0]
    gaps = []
    for key in ("lnld", "lnp"):
        rsum = ref[key].reshape(C, -1).sum(axis=1)
        gaps.append(np.abs(np.asarray(prog[key + "_sum"], np.float64) - rsum)
                    / np.abs(rsum))
    same = ((prog["age"] == prog["age0"]).all(axis=1)
            & (prog["mig_age"] == prog["mig_age0"]).all(axis=1))
    kept = (prog["father"] == prog["father0"]).all(axis=1)
    frozen = sum(int((prog[f][:, cols] == prog[f + "0"][:, cols])
                     .all(axis=1).sum())
                 for f, cols in ref["families"].items() if cols)

    def worst(x):
        """The largest of x, a number that is not finite read as the
        largest float (so that the result stays valid JSON)."""
        return float(np.nan_to_num(np.max(x), nan=HUGE, posinf=HUGE))

    with np.errstate(invalid="ignore"):
        return {
            "lnld_gap": worst(np.abs(np.asarray(prog["lnld"], np.float64)
                                     - ref["lnld"])),
            "lnp_gap": worst(np.abs(np.asarray(prog["lnp"], np.float64)
                                    - ref["lnp"])),
            "sum_gap": worst(gaps),
            "invalid": int(ref["invalid"].sum()),
            "unmoved": int(same.sum()),
            "kept_topology": float(kept.mean()),
            "frozen_params": frozen,
        }


def control_values(prog: dict, pats, ctl, device, dtype) -> dict:
    """`prog` with its lnld, lnp and trace sums replaced by the
    reference's, computed in `dtype` (the control)."""
    low = reference_values(prog, pats, ctl, device, dtype)
    C = prog["lnld_sum"].shape[0]
    out = dict(prog)
    for key in ("lnld", "lnp"):
        vals = torch.as_tensor(low[key]).to(dtype)
        out[key] = vals.double().numpy()
        out[key + "_sum"] = vals.reshape(C, -1).sum(dim=1).double().numpy()
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]) in ORDER."""
    rows = [(k, nums[k], limits[k]) for k in ORDER]
    return all(v <= lim for _, v, lim in rows), rows
