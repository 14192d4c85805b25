"""Synthetic data generation: coalescent genealogies + JC sequence evolution.

Used for tests and benchmarks (the reference's bundled seqs-sample.txt is
not redistributable here, so golden comparisons against the C binary run
on data generated by this module).  Produces seq files in the reference's
format; diploid samples are written as a single genotype sequence with
IUPAC codes at heterozygous sites (reference translateToAmbiguity,
src/AlignmentProcessor.c:2346-2420).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from gphocs_tpu_torch.config.settings import RunConfig
from gphocs_tpu_torch.model.poptree import PopTree
from gphocs_tpu_torch.rng_host import HostRng
from gphocs_tpu_torch.sampler.init import random_genealogy, sample_pop_parameters
from gphocs_tpu_torch.state import Params

_BASES = "TCAG"
_AMBIG = {
    frozenset("TC"): "Y", frozenset("TG"): "K", frozenset("TA"): "W",
    frozenset("CG"): "S", frozenset("AC"): "M", frozenset("AG"): "R",
}


def _evolve_jc(father, lson, rson, age, root, seq_len, mut_scale, rs):
    """Simulate JC sequences down one genealogy; returns [S, seq_len] codes."""
    N = len(father)
    S = (N + 1) // 2
    codes = np.zeros((N, seq_len), np.int8)
    codes[root] = rs.randint(0, 4, seq_len)
    # children in decreasing age order => parents visited first
    order = sorted(range(N), key=lambda v: -age[v])
    for v in order:
        for son in (lson[v], rson[v]):
            if son < 0:
                continue
            t = mut_scale * (age[v] - age[son])
            p_change = 0.75 * (1.0 - np.exp(-4.0 * t / 3.0))
            mutate = rs.rand(seq_len) < p_change
            shift = rs.randint(1, 4, seq_len)
            codes[son] = np.where(mutate, (codes[v] + shift) % 4, codes[v])
    return codes[:S]


def simulate_seq_file(cfg: RunConfig, tree: PopTree, path: str,
                      num_loci: int, seq_len=500,
                      seed: int = 1234,
                      params: Optional[Params] = None) -> Params:
    """Write a synthetic sequence file for `num_loci` loci.

    Genealogies are simulated from the demographic prior (no migration);
    sequences then evolve under JC.  Returns the true parameters used.
    seq_len may be an int or a per-locus sequence of ints (ragged loci).
    """
    rng = HostRng(num_loci + 1, seed)
    rs = np.random.RandomState(seed)
    if params is None:
        params = sample_pop_parameters(tree, rng)

    sample_names = cfg.sample_names
    is_dip = cfg.is_diploid()
    S = len(sample_names)

    lens = ([int(seq_len)] * num_loci if np.isscalar(seq_len)
            else [int(x) for x in seq_len])
    assert len(lens) == num_loci
    lines = [str(num_loci)]
    for locus in range(num_loci):
        sl = lens[locus]
        fa, ls, rsn, age, _, root = random_genealogy(tree, params, rng, locus)
        codes = _evolve_jc(fa, ls, rsn, age, root, sl, 1.0, rs)
        out_names: List[str] = []
        out_seqs: List[str] = []
        s = 0
        while s < S:
            if is_dip[s]:
                g = []
                for site in range(sl):
                    b0, b1 = _BASES[codes[s, site]], _BASES[codes[s + 1, site]]
                    if b0 == b1:
                        g.append(b0)
                    else:
                        g.append(_AMBIG[frozenset((b0, b1))])
                out_names.append(sample_names[s])
                out_seqs.append("".join(g))
                s += 2
            else:
                out_names.append(sample_names[s])
                out_seqs.append("".join(_BASES[c] for c in codes[s]))
                s += 1
        lines.append(f"locus{locus} {len(out_names)} {sl}")
        for nm, sq in zip(out_names, out_seqs):
            lines.append(f"{nm} {sq}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return params


def simulate_ragged_file(path: str, num_loci: Optional[int] = None) -> None:
    """Write the ragged workload of config/samples.py (RAGGED_*) to `path`:
    SAMPLE_CTL's tree, loci of 100 to 4,000 bp.  num_loci cuts it (the
    lengths are the first num_loci draws)."""
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config import samples as C
    from gphocs_tpu_torch.model.poptree import build_poptree

    cfg = parse_control_text(C.SAMPLE_CTL)
    tree = build_poptree(cfg)
    lens = np.random.RandomState(C.RAGGED_LENGTH_SEED).choice(
        C.RAGGED_LENGTHS, size=C.RAGGED_LOCI, p=C.RAGGED_LENGTH_P)
    tp = sample_pop_parameters(tree, HostRng(C.RAGGED_LOCI + 1,
                                             C.RAGGED_PARAM_SEED))
    tp = tp._replace(theta=tp.theta * C.RAGGED_SCALE,
                     tau=tp.tau * C.RAGGED_SCALE)
    n = num_loci or C.RAGGED_LOCI
    simulate_seq_file(cfg, tree, path, num_loci=n, seq_len=lens[:n],
                      seed=C.RAGGED_SIM_SEED, params=tp)
