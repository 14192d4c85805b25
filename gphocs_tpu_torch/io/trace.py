"""Trace-file writing and reading.

Format mirrors the reference (src/GPhoCS.c:1273-1313, 1763-1769): a
tab-separated header
    Sample  theta_<pop>...  tau_<anc>...  m_<src>-><tgt>...
    [tau_<ancientpop>...]  [Variance-Mut]  Data-ld-ln  Full-ld-ln
then one row per recorded sample; parameter values are scaled by their
print factors and written as %8.5f.
"""

from __future__ import annotations

from typing import List

import numpy as np

from gphocs_tpu_torch.model.poptree import PopTree


def trace_header(tree: PopTree, var_mut: bool = False) -> str:
    cols = ["Sample"]
    for name in tree.names:
        cols.append(f"theta_{name}")
    for p in range(tree.num_cur_pops, tree.num_pops):
        cols.append(f"tau_{tree.names[p]}")
    for b in range(tree.num_bands):
        cols.append(
            f"m_{tree.names[tree.band_source[b]]}->"
            f"{tree.names[tree.band_target[b]]}")
    for p in range(tree.num_cur_pops):
        if tree.update_sample_age[p] or tree.sample_age[p] > 0.0:
            cols.append(f"tau_{tree.names[p]}")
    for a in range(len(tree.admix_slot)):
        cols.append(
            f"A{tree.admix_slot[a]}[{tree.names[tree.admix_pops[a, 1]]}]")
    if var_mut:
        cols.append("Variance-Mut")
    cols += ["Data-ld-ln", "Full-ld-ln"]
    return "\t".join(cols)


def record_param_vals(tree: PopTree, theta, tau, sample_age, mig_rate,
                      rate_var=None, admix_coeff=None) -> List[float]:
    """Parameter vector in trace order (reference recordParamVals,
    src/GPhoCS.c:802-851)."""
    vals = list(np.asarray(theta))
    vals += list(np.asarray(tau)[tree.num_cur_pops:])
    vals += list(np.asarray(mig_rate))
    for p in range(tree.num_cur_pops):
        if tree.update_sample_age[p] or tree.sample_age[p] > 0.0:
            vals.append(float(sample_age[p]))
    if admix_coeff is not None:
        vals += list(np.asarray(admix_coeff))
    if rate_var is not None:
        vals.append(float(np.sqrt(rate_var)))
    return vals


def print_factors(tree: PopTree, var_mut: bool = False) -> np.ndarray:
    f = list(tree.theta_print)
    f += list(tree.tau_print[tree.num_cur_pops:])
    f += list(tree.mig_print)
    for p in range(tree.num_cur_pops):
        if tree.update_sample_age[p] or tree.sample_age[p] > 0.0:
            f.append(tree.tau_print[p])
    f += [1.0] * len(tree.admix_slot)
    if var_mut:
        f.append(1.0)
    return np.asarray(f)


def format_row(sample: int, vals, factors, lnl_full: float,
               lnl_data: float) -> str:
    parts = [str(sample)]
    for v, f in zip(vals, factors):
        parts.append(f"{v * f:8.5f}")
    parts.append(f"{lnl_full:.6f}")
    parts.append(f"{lnl_data:.6f}")
    return "\t".join(parts)


def read_trace(path: str):
    """Read a trace file into (column_names, [rows] float array)."""
    with open(path) as f:
        header = f.readline().split("\t")
        # the reference writes a double tab before the likelihood columns
        rows = [
            [float(x) for x in line.split()]
            for line in f if line.strip()
        ]
    return [h.strip() for h in header if h.strip()], np.asarray(rows)
