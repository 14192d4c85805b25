"""Control-file generation (a copy of gphocs_tpu/tools/controlgen.py on
the port's config.settings, config and model.newick): the programmatic
replacement for the reference's Java Swing ControlFileGenerator GUI
(ControlFileGenerator/src/CFG/...; tabs General / Tree (extended Newick) /
Mig-Bands / Load-Save).

Builds a RunConfig from a population tree given in extended-Newick form
plus per-population sample lists, then serializes it back to the
control-file grammar.  Round-trips through config.parse_control_text.

Extended Newick population-tree syntax (as in the GUI's Tree tab):
    ((A,B)AB,C)root
with internal node labels naming ancestral populations.

Usage:
    python -m gphocs_tpu_torch.tools.controlgen \\
        --tree "((A,B)AB,C)root" \\
        --samples "A:a1 d;B:b1 d;C:c1 h" \\
        --seq-file seqs.txt --band A-\\>B -o run.ctl
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from gphocs_tpu_torch.config.settings import (
    BandSpec,
    MCMCSettings,
    PopSpec,
    RunConfig,
)


def config_to_control_text(cfg: RunConfig) -> str:
    """Serialize a RunConfig to control-file text."""
    m = cfg.mcmc
    ft = m.finetunes
    lines = ["GENERAL-INFO-START", ""]

    def kv(key, val):
        lines.append(f"\t{key} {val}")

    kv("seq-file", m.seq_file)
    kv("trace-file", m.trace_file)
    if m.num_loci > 0:
        kv("num-loci", m.num_loci)
    if m.random_seed >= 0:
        kv("random-seed", m.random_seed)
    if m.mut_rate_mode == 0:
        kv("locus-mut-rate", "CONST")
    elif m.mut_rate_mode == 1:
        kv("locus-mut-rate", f"VAR {m.var_rates_alpha}")
    else:
        kv("locus-mut-rate", f"FIXED {m.rate_file}")
    kv("mcmc-iterations", m.mcmc_iterations)
    if m.burn_in:
        kv("burn-in", m.burn_in)
    if m.mcmc_sample_skip:
        kv("mcmc-sample-skip", m.mcmc_sample_skip)
    if m.start_mig:
        kv("start-mig", m.start_mig)
    kv("iterations-per-log", m.iterations_per_log)
    kv("logs-per-line", m.logs_per_line)
    if not m.do_mixing:
        kv("no-mixing", "TRUE")
    lines.append("")
    if m.find_finetunes:
        kv("find-finetunes", "TRUE")
        kv("find-finetunes-num-steps", m.find_finetunes_num_steps)
        kv("find-finetunes-samples-per-step", m.find_finetunes_samples_per_step)
    else:
        kv("find-finetunes", "FALSE")
    for name, v in [("coal-time", ft.coal_time), ("mig-time", ft.mig_time),
                    ("theta", ft.theta), ("mig-rate", ft.mig_rate),
                    ("mixing", ft.mixing)]:
        if v > 0:
            kv(f"finetune-{name}", f"{v:.10g}")
    if ft.locus_rate > 0:
        kv("finetune-locus-rate", f"{ft.locus_rate:.10g}")
    if ft.taus and ft.taus[0] > 0:
        kv("finetune-tau", f"{ft.taus[0]:.10g}")
    lines.append("")
    kv("tau-theta-print", m.tau_theta_print)
    kv("tau-theta-alpha", m.tau_theta_alpha)
    kv("tau-theta-beta", m.tau_theta_beta)
    kv("mig-rate-print", m.mig_rate_print)
    kv("mig-rate-alpha", m.mig_rate_alpha)
    kv("mig-rate-beta", m.mig_rate_beta)
    lines += ["", "GENERAL-INFO-END", "", "CURRENT-POPS-START", ""]
    for p in cfg.cur_pops:
        lines.append("\tPOP-START")
        lines.append(f"\t\tname {p.name}")
        samp = " ".join(f"{nm} {fmt}" for nm, fmt in p.samples)
        lines.append(f"\t\tsamples {samp}")
        if p.theta_alpha != m.tau_theta_alpha:
            lines.append(f"\t\ttheta-alpha {p.theta_alpha}")
        if p.theta_beta != m.tau_theta_beta:
            lines.append(f"\t\ttheta-beta {p.theta_beta}")
        if p.sample_age > 0 or p.update_sample_age:
            flag = "e" if p.update_sample_age else "f"
            lines.append(f"\t\tage {p.sample_age:.10g} {flag}")
        lines.append("\tPOP-END")
        lines.append("")
    lines += ["CURRENT-POPS-END", "", "ANCESTRAL-POPS-START", ""]
    for p in cfg.anc_pops:
        lines.append("\tPOP-START")
        lines.append(f"\t\tname {p.name}")
        lines.append(f"\t\tchildren {p.children[0]} {p.children[1]}")
        if p.tau_alpha != m.tau_theta_alpha:
            lines.append(f"\t\ttau-alpha {p.tau_alpha}")
        if p.tau_beta != m.tau_theta_beta:
            lines.append(f"\t\ttau-beta {p.tau_beta}")
        if p.tau_initial > 0:
            lines.append(f"\t\ttau-initial {p.tau_initial:.10g}")
        if p.finetune_tau > 0:
            lines.append(f"\t\tfinetune-tau {p.finetune_tau:.10g}")
        lines.append("\tPOP-END")
        lines.append("")
    lines += ["ANCESTRAL-POPS-END", "", "MIG-BANDS-START", ""]
    for b in cfg.bands:
        lines.append("\tBAND-START")
        lines.append(f"\t\tsource {b.source}")
        lines.append(f"\t\ttarget {b.target}")
        if b.mig_rate_alpha != m.mig_rate_alpha:
            lines.append(f"\t\tmig-rate-alpha {b.mig_rate_alpha}")
        if b.mig_rate_beta != m.mig_rate_beta:
            lines.append(f"\t\tmig-rate-beta {b.mig_rate_beta}")
        lines.append("\tBAND-END")
        lines.append("")
    lines += ["MIG-BANDS-END", ""]
    return "\n".join(lines)


def build_config(tree_newick: str, samples: dict,
                 bands: Optional[List[tuple]] = None,
                 **general) -> RunConfig:
    """Build a RunConfig from an extended-Newick population tree.

    samples: {current_pop_name: [(sample, 'h'|'d'), ...]}
    bands:   [(source, target), ...]
    general: MCMCSettings field overrides (e.g. seq_file=...,
             tau_theta_alpha=...).
    """
    from gphocs_tpu_torch.model.newick import parse_newick

    # parse with internal labels: reuse parse_newick but retain labels
    # by a simple recursive parse here (labels are required on internals)
    text = tree_newick.strip().rstrip(";")
    pos = 0

    def parse():
        nonlocal pos
        if text[pos] == "(":
            pos += 1
            a = parse()
            assert text[pos] == ","
            pos += 1
            b = parse()
            assert text[pos] == ")"
            pos += 1
            name = ""
            while pos < len(text) and text[pos] not in ":,();":
                name += text[pos]
                pos += 1
            if not name:
                raise ValueError("every ancestral pop needs a Newick label")
            return ("anc", name, a, b)
        name = ""
        while pos < len(text) and text[pos] not in ":,();":
            name += text[pos]
            pos += 1
        return ("cur", name)

    root = parse()
    cfg = RunConfig()
    m = MCMCSettings()
    for k, v in general.items():
        if not hasattr(m, k):
            raise ValueError(f"unknown GENERAL-INFO setting {k!r}")
        setattr(m, k, v)
    cfg.mcmc = m

    def walk(node):
        if node[0] == "cur":
            nm = node[1]
            samp = samples.get(nm)
            if not samp:
                raise ValueError(f"no samples for current pop {nm!r}")
            cfg.cur_pops.append(PopSpec(
                name=nm, samples=list(samp),
                theta_alpha=m.tau_theta_alpha, theta_beta=m.tau_theta_beta,
                theta_print=m.tau_theta_print))
            return nm
        _, nm, a, b = node
        ca = walk(a)
        cb = walk(b)
        cfg.anc_pops.append(PopSpec(
            name=nm, children=[ca, cb],
            theta_alpha=m.tau_theta_alpha, theta_beta=m.tau_theta_beta,
            theta_print=m.tau_theta_print,
            tau_alpha=m.tau_theta_alpha, tau_beta=m.tau_theta_beta,
            tau_print=m.tau_theta_print))
        return nm

    walk(root)
    for (src, tgt) in bands or []:
        cfg.bands.append(BandSpec(
            source=src, target=tgt, mig_rate_alpha=m.mig_rate_alpha,
            mig_rate_beta=m.mig_rate_beta, mig_rate_print=m.mig_rate_print))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(prog="controlgen")
    ap.add_argument("--tree", required=True,
                    help='extended Newick, e.g. "((A,B)AB,C)root"')
    ap.add_argument("--samples", required=True,
                    help='e.g. "A:a1 d;B:b1 d b2 h;C:c1 h"')
    ap.add_argument("--band", action="append", default=[],
                    help="migration band SRC->TGT (repeatable)")
    ap.add_argument("--seq-file", default="seqs.txt")
    ap.add_argument("--iterations", type=int, default=100000)
    ap.add_argument("--tau-theta-alpha", type=float, default=1.0)
    ap.add_argument("--tau-theta-beta", type=float, default=10000.0)
    ap.add_argument("--mig-rate-alpha", type=float, default=0.002)
    ap.add_argument("--mig-rate-beta", type=float, default=0.00001)
    ap.add_argument("--find-finetunes", action="store_true")
    ap.add_argument("-o", "--output", default="-")
    args = ap.parse_args(argv)

    samples = {}
    for part in args.samples.split(";"):
        pop, rest = part.split(":", 1)
        toks = rest.split()
        samples[pop.strip()] = list(zip(toks[::2], toks[1::2]))
    bands = []
    for b in args.band:
        src, tgt = b.replace("->", " ").split()
        bands.append((src, tgt))
    ft_kwargs = {}
    cfg = build_config(
        args.tree, samples, bands,
        seq_file=args.seq_file, mcmc_iterations=args.iterations,
        tau_theta_alpha=args.tau_theta_alpha,
        tau_theta_beta=args.tau_theta_beta,
        mig_rate_alpha=args.mig_rate_alpha,
        mig_rate_beta=args.mig_rate_beta,
        find_finetunes=args.find_finetunes, **ft_kwargs)
    text = config_to_control_text(cfg)
    # validate round trip
    from gphocs_tpu_torch.config import parse_control_text

    if not cfg.mcmc.find_finetunes:
        # default finetunes so validation passes when not auto-searching
        pass
    try:
        parse_control_text(text)
    except Exception as e:
        print(f"# warning: generated file needs edits: {e}")
    if args.output == "-":
        print(text)
    else:
        with open(args.output, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
