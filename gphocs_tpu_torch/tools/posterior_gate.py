"""The posterior gate: the port's pooled chains against the marginals the C
reference recorded (GOLDEN_FUSED_r05.json, GOLDEN_2BAND_r05.json).

    python -m gphocs_tpu_torch.tools.posterior_gate [--case fused|2band]
        [--chains 12] [--iters 16000] [--burnin 1500] [--device cuda]
        [--x64] [--out PATH]

The data and settings are those of scripts/golden_compare.py (copied here,
so that nothing of the JAX package is imported): its control template with
base seed 1357, the true parameters `sample_pop_parameters(tree,
HostRng(loci + 1, 77))` with theta and tau times 8, and `loci` x 1000 bp
simulated with seed 77 by the port's io/simulate (100 loci; 80 and a
second band A->C for `--case 2band`, scripts/golden_2band.py).  One
`Sampler(chains=C)` runs C chains side by side for burn-in + iters
iterations at f32 (f64 with --x64); each chain drops the first third of
its rows, as the harness does.  For each of the golden file's marginals,

    z = (c_mean - port_mean) / sqrt(se^2 + se_port^2)

where `se` is the golden file's combined standard error of the C and JAX
chain means and se_port the standard error of the port's chain means
(sd / sqrt(C)); the gate is |z| < 3 for every marginal.  Prints every z,
the worst |z|, the run's wall time and it/s, and the card's name and power
limit, and writes them as JSON to --out.  Exits 1 where a marginal fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# scripts/golden_compare.py CTL_TEMPLATE
CTL_TEMPLATE = """
GENERAL-INFO-START
\tseq-file            {seq}
\ttrace-file          {trace}
\tlocus-mut-rate      CONST
\tmcmc-iterations\t  {iters}
\tburn-in  {burnin}
\trandom-seed  {seed}
\tmcmc-sample-skip 0
\tstart-mig 0
\titerations-per-log  1000
\tlogs-per-line       10
\tfind-finetunes\t\tFALSE
\tfinetune-coal-time\t0.01
\tfinetune-mig-time\t0.3
\tfinetune-theta\t\t0.04
\tfinetune-mig-rate\t0.02
\tfinetune-tau\t\t0.0000008
\tfinetune-mixing\t\t0.003
\ttau-theta-print\t\t10000.0
\ttau-theta-alpha\t\t1.0
\ttau-theta-beta\t\t10000.0
\tmig-rate-print\t\t0.001
\tmig-rate-alpha\t\t0.002
\tmig-rate-beta\t\t0.00001
GENERAL-INFO-END
CURRENT-POPS-START
\tPOP-START
\t\tname\t\tA
\t\tsamples\t\tone d
\tPOP-END
\tPOP-START
\t\tname\t\tB
\t\tsamples\t\ttwo d
\tPOP-END
\tPOP-START
\t\tname\t\tC
\t\tsamples\t\tthree d
\tPOP-END
\tPOP-START
\t\tname\t\tD
\t\tsamples\t\tfive d
\tPOP-END
CURRENT-POPS-END
ANCESTRAL-POPS-START
\tPOP-START
\t\tname\t\t\tAB
\t\tchildren\t\tA\t\tB
\t\ttau-initial\t0.000005
\t\ttau-beta\t\t20000.0
\t\tfinetune-tau\t\t\t0.0000008
\tPOP-END
\tPOP-START
\t\tname\t\t\tABC
\t\tchildren\t\tAB\t\tC
\t\ttau-initial\t0.00001
\t\ttau-beta\t\t20000.0
\t\tfinetune-tau\t\t\t0.0000008
\tPOP-END
\tPOP-START
\t\tname\t\t\troot
\t\tchildren\t\tABC\tD
\t\ttau-initial\t0.00005
\t\ttau-beta\t\t20000.0
\t\tfinetune-tau\t\t\t0.00000286
\tPOP-END
ANCESTRAL-POPS-END
MIG-BANDS-START
\tBAND-START
       source  D
       target  B
       mig-rate-print 0.1
\tBAND-END
MIG-BANDS-END
"""

_BAND_DB = """\tBAND-START
       source  D
       target  B
       mig-rate-print 0.1
\tBAND-END
"""
# scripts/golden_2band.py CTL_2BAND: a second band, A -> C
CTL_2BAND = CTL_TEMPLATE.replace(_BAND_DB, _BAND_DB + _BAND_DB.replace(
    "source  D", "source  A").replace("target  B", "target  C"))

# case: (control template, loci, golden file)
CASES = {"fused": (CTL_TEMPLATE, 100, "GOLDEN_FUSED_r05.json"),
         "2band": (CTL_2BAND, 80, "GOLDEN_2BAND_r05.json")}
SEED = 1357
DATA_SEED = 77
BOOST = 8.0


def write_data(work: str, template: str, loci: int) -> str:
    """The harness's data in `work`: `loci` x 1000 bp simulated with seed
    77 from the boosted prior draw.  Returns the sequence file's path."""
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.model import build_poptree
    from gphocs_tpu_torch.rng_host import HostRng
    from gphocs_tpu_torch.sampler.init import sample_pop_parameters

    seq = os.path.join(work, "seqs.txt")
    cfg = parse_control_text(template.format(seq=seq, trace="t.out",
                                             iters=1, burnin=0, seed=SEED))
    tree = build_poptree(cfg)
    tp = sample_pop_parameters(tree, HostRng(loci + 1, DATA_SEED))
    tp = tp._replace(theta=tp.theta * BOOST, tau=tp.tau * BOOST)
    simulate_seq_file(cfg, tree, seq, num_loci=loci, seq_len=1000,
                      seed=DATA_SEED, params=tp)
    return seq


def compare(cols, chain_rows, golden: dict) -> list:
    """The z of every golden marginal against the pooled chains (each
    chain's first third of rows dropped)."""
    keep = [r[r[:, 0] >= 0] for r in chain_rows]
    keep = [r[r.shape[0] // 3:] for r in keep]
    pooled = np.concatenate(keep)
    means = np.asarray([r.mean(axis=0) for r in keep])
    out = []
    for g in golden["results"]:
        k = cols.index(g["param"])
        mean = float(pooled[:, k].mean())
        se_port = float(means[:, k].std(ddof=1) / np.sqrt(len(keep)))
        z = (g["c_mean"] - mean) / np.sqrt(g["se"] ** 2 + se_port ** 2)
        out.append(dict(param=g["param"], c_mean=g["c_mean"],
                        port_mean=mean, port_sd=float(pooled[:, k].std()),
                        se=g["se"], se_port=se_port, z=float(z)))
    return out


def _card(device: str) -> str:
    if device != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=sorted(CASES), default="fused")
    ap.add_argument("--chains", type=int, default=12)
    ap.add_argument("--iters", type=int, default=16000)
    ap.add_argument("--burnin", type=int, default=1500)
    ap.add_argument("--loci", type=int, default=None,
                    help="default: the case's (100, or 80 for 2band)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--out", default=None, help="JSON result file")
    a = ap.parse_args(argv)

    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.sampler.driver import Sampler

    if a.device == "cuda" and not torch.cuda.is_available():
        print("posterior_gate: no CUDA device (--device cpu for the CPU)")
        return 1
    template, loci, golden_file = CASES[a.case]
    loci = a.loci or loci
    with open(os.path.join(ROOT, golden_file)) as f:
        golden = json.load(f)
    card = _card(a.device)
    dtype = torch.float64 if a.x64 else torch.float32
    with tempfile.TemporaryDirectory() as work:
        seq = write_data(work, template, loci)
        cfg = parse_control_text(template.format(
            seq=seq, trace=os.path.join(work, "trace.out"), iters=a.iters,
            burnin=a.burnin, seed=SEED))
        s = Sampler(cfg, dtype=dtype, device=a.device, chains=a.chains)
        t0 = time.perf_counter()
        cols, _ = s.run(trace_path=cfg.mcmc.trace_file)
        wall = time.perf_counter() - t0
    results = compare(cols, s.chain_rows, golden)
    worst = max(abs(r["z"]) for r in results)
    its = (a.iters + a.burnin) / wall
    print(f"posterior gate ({a.case}): {a.chains} chains x {a.iters} "
          f"iterations after {a.burnin} of burn-in, {loci} loci, "
          f"{'f64' if a.x64 else 'f32'}, on {card}")
    print(f"run() {wall:.1f} s: {its:.2f} it/s, "
          f"{a.chains * its:.2f} chain-it/s")
    print(f"{'param':<14}{'C mean':>14}{'port mean':>14}{'se':>10}"
          f"{'se port':>10}{'z':>8}")
    for r in results:
        print(f"{r['param']:<14}{r['c_mean']:14.5f}{r['port_mean']:14.5f}"
              f"{r['se']:10.5f}{r['se_port']:10.5f}{r['z']:8.2f}")
    ok = worst < 3.0
    print(f"worst |z| {worst:.3f}: {'passes' if ok else 'FAILS'} |z| < 3")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(case=a.case, golden=golden_file, chains=a.chains,
                           iters=a.iters, burnin=a.burnin, loci=loci,
                           dtype=str(dtype), device=a.device, card=card,
                           wall_s=wall, it_per_s=its, worst_abs_z=worst,
                           passes=ok, results=results), f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
