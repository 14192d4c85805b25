"""Alignment diagnostics: pattern statistics and the 4-gamete test (a
copy of gphocs_tpu/tools/alignstats.py on the port's io.patterns,
io.sequences and config).

Equivalent of the reference's AlignmentMain tools (src/AlignmentMain.c:
main_analyze_patterns / main_4gam_test; core logic
src/AlignmentProcessor.c:1168-1444, 2420-2560):

  * pattern classification by sorted base counts: 0 = non-informative or
    singleton, 1 = informative biallelic, 2 = tri-allelic beyond a
    singleton (:1377-1395)
  * two-site 4-gamete test on canonized patterns: the four gamete
    configurations are (site1 is 'T' or not) x (site2 is 'T' or not);
    haploid and het-vs-homozygote pairs contribute both haplotype
    configurations; double-het pairs are phase-ambiguous and are treated
    conservatively ("potential" violations; the reference's second pass
    :2500-2560 enumerates their optional configurations)
  * informative-pattern counts (countInformativePatterns :1168-1190)

Usage:
    python -m gphocs_tpu_torch.tools.alignstats <control-file> [--4gamete]
"""

from __future__ import annotations

import argparse
from typing import List

from gphocs_tpu_torch.io.patterns import AMBIG_PAIRS


def base_counts(pattern: str) -> List[int]:
    """Counts of T,C,A,G over the haploid genomes of one pattern (ambiguity
    codes contribute both bases; N contributes nothing)."""
    counts = {b: 0 for b in "TCAG"}
    # each non-N slot contributes its translateAmbiguity pair — two counts
    # per slot, like the reference (:1366-1372)
    for ch in pattern:
        if ch in "TCAG":
            counts[ch] += 2
        elif ch in AMBIG_PAIRS:
            for b in AMBIG_PAIRS[ch]:
                counts[b] += 1
    return sorted(counts.values(), reverse=True)


def classify_pattern(pattern: str) -> int:
    """0 non-informative/singleton, 1 informative biallelic, 2 tri+allelic."""
    c = base_counts(pattern)
    if c[1] < 2:
        return 0
    if c[2] > 1:
        return 2
    return 1


def _pairs(ch: str):
    if ch in "TCAG":
        return (ch, ch)
    if ch in AMBIG_PAIRS:
        return tuple(AMBIG_PAIRS[ch])
    return None  # N / other: skipped


def two_site_test(p1: str, p2: str) -> int:
    """0 = compatible, 1 = definite 4-gamete violation, 2 = potential
    violation involving phase-ambiguous double hets."""
    configs = set()
    double_hets = []
    for ch1, ch2 in zip(p1, p2):
        a1, a2 = _pairs(ch1), _pairs(ch2)
        if a1 is None or a2 is None:
            continue
        het1 = a1[0] != a1[1]
        het2 = a2[0] != a2[1]
        if het1 and het2:
            double_hets.append((a1, a2))
            continue
        n = 2 if (het1 or het2) else 1
        for i in range(n):
            configs.add((a1[i] == "T", a2[i] == "T"))
    if len(configs) == 4:
        return 1
    # double hets can realize either phasing; see if any completes 4 gametes
    for a1, a2 in double_hets:
        for flip in (False, True):
            b2 = (a2[1], a2[0]) if flip else a2
            test = set(configs)
            for i in range(2):
                test.add((a1[i] == "T", b2[i] == "T"))
            if len(test) == 4:
                return 2
    return 0


def four_gamete_report(patterns: List[str], locus_profiles):
    """Per-locus 4-gamete conflicts.  Returns list of
    (locus, pattern1, pattern2, result)."""
    status = [classify_pattern(p) for p in patterns]
    out = []
    for locus, profile in enumerate(locus_profiles):
        pids = [pid for pid, _ in profile]
        for i in range(1, len(pids)):
            if status[pids[i]] == 0:
                continue
            for j in range(i):
                if status[pids[j]] == 0:
                    continue
                if status[pids[i]] == 2 or status[pids[j]] == 2:
                    res = 3  # tri-allelic: flagged like the reference
                else:
                    res = two_site_test(patterns[pids[i]],
                                        patterns[pids[j]])
                if res > 0:
                    out.append((locus, patterns[pids[i]],
                                patterns[pids[j]], res))
    return out


def pattern_summary(patterns: List[str], locus_profiles):
    """Counts mirroring main_analyze_patterns: total/informative sites,
    het-containing patterns, per-locus averages."""
    status = [classify_pattern(p) for p in patterns]
    has_het = [any(ch in AMBIG_PAIRS for ch in p) for p in patterns]
    total_sites = 0
    informative_sites = 0
    het_sites = 0
    for profile in locus_profiles:
        for pid, cnt in profile:
            total_sites += cnt
            if status[pid] >= 1:
                informative_sites += cnt
            if has_het[pid]:
                het_sites += cnt
    return {
        "num_loci": len(locus_profiles),
        "num_patterns": len(patterns),
        "num_informative_patterns": sum(1 for s in status if s >= 1),
        "total_sites": total_sites,
        "informative_sites": informative_sites,
        "het_sites": het_sites,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="alignstats")
    ap.add_argument("control_file")
    ap.add_argument("--four-gamete", "--4gamete", action="store_true",
                    dest="four_gamete")
    args = ap.parse_args(argv)

    from gphocs_tpu_torch.config import parse_control_file
    from gphocs_tpu_torch.io.sequences import read_seq_file

    cfg = parse_control_file(args.control_file)
    raw = read_seq_file(cfg.mcmc.seq_file, cfg.sample_names,
                        cfg.mcmc.num_loci)
    pats = raw.pattern_set.patterns
    profs = raw.pattern_set.locus_profiles
    info = pattern_summary(pats, profs)
    for k, v in info.items():
        print(f"{k}: {v}")
    if args.four_gamete:
        conflicts = four_gamete_report(pats, profs)
        violated = sorted({c[0] for c in conflicts})
        for (locus, p1, p2, res) in conflicts:
            print(f"potential conflict at locus {locus + 1:5d}, patterns "
                  f"{p1} and {p2} - {res}")
        print(f"{len(violated)} loci with potential 4-gamete violations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
