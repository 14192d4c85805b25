"""Convergence diagnostics: split-R̂ and effective sample size (a copy of
gphocs_tpu/tools/convergence.py on the port's trace reader).

The reference offers only acceptance-rate logs and eyeball regression of
readTrace block averages (manual §4/§10).  This module adds the standard
split-chain potential-scale-reduction statistic (Gelman-Rubin / BDA3) and
an autocorrelation-based ESS, applicable to one or more trace files
(`--chains C` writes chain 0's; Sampler.chain_rows holds every chain's).

    python -m gphocs_tpu_torch.tools.convergence trace1.out [trace2.out ...] \
        [-d burnin]
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np

from gphocs_tpu_torch.io.trace import read_trace


def split_rhat(chains: np.ndarray) -> float:
    """chains: [n_chains, n_samples].  Split each chain in half, compute
    the BDA3 potential scale reduction factor."""
    m, n = chains.shape
    half = n // 2
    if half < 2:
        return np.nan
    split = np.concatenate([chains[:, :half], chains[:, half:2 * half]], 0)
    w = split.var(axis=1, ddof=1).mean()
    b = half * split.mean(axis=1).var(ddof=1)
    if w <= 0:
        return np.nan
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def ess(x: np.ndarray) -> float:
    """Autocorrelation-time ESS (initial positive sequence estimator)."""
    x = np.asarray(x, float)
    n = len(x)
    x = x - x.mean()
    if x.std() == 0 or n < 8:
        return float(n)
    acf = np.correlate(x, x, "full")[n - 1:]
    acf = acf / acf[0]
    tau = 1.0
    for k in range(1, n // 2):
        if acf[k] + (acf[k + 1] if k + 1 < n else 0) < 0:
            break
        tau += 2 * acf[k]
    return float(max(n / tau, 1.0))


def diagnose(trace_paths: List[str], discard: int = 0):
    """Returns (param_names, {name: (rhat, min_ess, pooled_mean, pooled_sd)})."""
    all_rows = []
    cols = None
    for p in trace_paths:
        c, rows = read_trace(p)
        cols = c
        all_rows.append(rows[discard:])
    nmin = min(len(r) for r in all_rows)
    stacked = np.stack([r[:nmin] for r in all_rows])  # [chains, n, cols]
    out = {}
    for k, name in enumerate(cols[1:], start=1):
        ch = stacked[:, :, k]
        r = split_rhat(ch)
        e = sum(ess(ch[i]) for i in range(ch.shape[0]))
        out[name] = (r, e, ch.mean(), ch.std())
    return cols[1:], out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="convergence")
    ap.add_argument("traces", nargs="+")
    ap.add_argument("-d", "--discard", type=int, default=0)
    args = ap.parse_args(argv)
    names, out = diagnose(args.traces, args.discard)
    print(f"{'param':<16}{'R-hat':>8}{'ESS':>9}{'mean':>12}{'sd':>12}")
    worst = 0.0
    for name in names:
        r, e, m, s = out[name]
        worst = max(worst, r if np.isfinite(r) else 0)
        print(f"{name:<16}{r:8.3f}{e:9.0f}{m:12.5f}{s:12.5f}")
    print(f"worst R-hat: {worst:.3f} "
          f"({'OK' if worst < 1.05 else 'NOT CONVERGED'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
