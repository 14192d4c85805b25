"""Site-pattern extraction: JC canonization, deduplication, het phasing.

Reimplements the semantics of the reference AlignmentProcessor
(src/AlignmentProcessor.c):

  * every alignment column is canonized under the 24 base permutations of
    the Jukes-Cantor symmetry group, greedily mapping each base to the
    lowest symbol achievable by a still-consistent permutation
    (cannonizeJCpattern, :1595-1660; symbol order "TCAGYWKMSRVDBHN", :61)
  * canonized patterns are deduplicated into a global pattern set with
    per-locus (patternId, count) profiles (processLocusAlignment, :871-960)
  * per locus, 2-way ambiguity codes in diploid samples expand into all
    2^k phasings, except that singleton-count patterns may leave one het
    per diploid arbitrarily phased ("symmetry breaking": each diploid is
    arbitrarily phased at <= 1 column per locus —
    computeHetSymmetryBreaks :1706-1830, getAllPhases :2242-2290)

The output is the tensorized SeqData (leaf base codes 0..3=TCAG, 4=N,
phase-group segment ids + counts).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

# canonized symbol order (reference src/AlignmentProcessor.c:61)
CANON_SYMBOLS = "TCAGYWKMSRVDBHN"
_SYM_INDEX = {c: i for i, c in enumerate(CANON_SYMBOLS)}

# IUPAC 2-way ambiguity -> base pair (reference translateAmbiguity :2302-2340)
AMBIG_PAIRS = {
    "Y": "TC", "K": "TG", "W": "TA", "S": "CG", "M": "AC", "R": "AG",
}

_BASE_CODE = {"T": 0, "C": 1, "A": 2, "G": 3, "N": 4}


def _build_transformations() -> np.ndarray:
    """24 x 15 permutation table over canonized symbols
    (reference initializeBaseTransformations :1518-1593)."""
    import itertools

    # base permutation rows in the reference's explicit order are just all
    # permutations of (0,1,2,3); the ambiguity extension below is
    # order-insensitive, so itertools order is fine for canonization
    # (the greedy minimum over live permutations is permutation-order
    # independent).
    perms = list(itertools.permutations(range(4)))
    table = np.zeros((24, 15), int)
    for pi, perm in enumerate(perms):
        for b in range(4):
            table[pi][b] = perm[b]
            # 3-way ambiguities (V,D,B,H at 10..13): complement of one base
            table[pi][b + 10] = perm[b] + 10
        table[pi][14] = 14  # N
        for b1 in range(4):
            for b2 in range(b1 + 1, 4):
                amb = 2 * b1 + b2 + 3
                if amb == 10:
                    amb = 9
                m1, m2 = sorted((perm[b1], perm[b2]))
                ambm = 2 * m1 + m2 + 3
                if ambm == 10:
                    ambm = 9
                table[pi][amb] = ambm
    return table


_TRANSFORMS = _build_transformations()


@functools.lru_cache(maxsize=1 << 16)
def canonize_column(column: str) -> str:
    """Greedy JC canonization of one alignment column
    (reference cannonizeJCpattern :1595-1660).  Memoized: an alignment
    repeats a few hundred distinct columns millions of times."""
    live = np.ones(24, bool)
    out = []
    for ch in column:
        if ch not in _SYM_INDEX:
            raise ValueError(f"illegal base symbol {ch!r}")
        base = _SYM_INDEX[ch]
        maps = _TRANSFORMS[live][:, base]
        m = maps.min()
        if m > 14:
            raise ValueError(f"no valid mapping for column {column!r}")
        live = live & (_TRANSFORMS[:, base] == m)
        out.append(CANON_SYMBOLS[m])
    return "".join(out)


class PatternSet:
    """Global deduplicated pattern set + per-locus profiles
    (reference AlignmentData, src/AlignmentProcessor.h:43-51)."""

    def __init__(self):
        self.patterns: List[str] = []
        self._index: Dict[str, int] = {}
        # per locus: list of (pattern_id, count)
        self.locus_profiles: List[List[Tuple[int, int]]] = []

    def add_locus(self, columns: List[str]):
        profile: Dict[int, int] = {}
        order: List[int] = []
        for col in columns:
            if all(c == "N" for c in col):
                continue  # all-missing columns are dropped (:906-910)
            pat = canonize_column(col)
            pid = self._index.get(pat)
            if pid is None:
                pid = len(self.patterns)
                self.patterns.append(pat)
                self._index[pat] = pid
            if pid not in profile:
                profile[pid] = 0
                order.append(pid)
            profile[pid] += 1
        self.locus_profiles.append([(pid, profile[pid]) for pid in order])


def compute_het_symmetry_breaks(patterns: List[str], counts: List[int],
                                is_diploid: List[bool]) -> List[List[bool]]:
    """Greedy selection of hets to phase arbitrarily
    (reference computeHetSymmetryBreaks :1706-1830).

    Only singleton-count patterns are eligible.  Patterns are repeatedly
    chosen by score 2^{remaining hets} (ties: first pattern), and one het
    (the last in its live list) marked broken, until each chosen pattern's
    supply is exhausted.  A diploid sample may end up arbitrarily phased in
    at most one column per locus.
    """
    n = len(patterns)
    S = len(is_diploid)
    breaks = [[False] * S for _ in range(n)]
    live_hets: List[List[int]] = []
    scores = [-1.0] * n
    for p in range(n):
        hets = []
        if counts[p] <= 1:
            for s in range(S):
                if is_diploid[s] and patterns[p][s] in AMBIG_PAIRS:
                    hets.append(s)
        live_hets.append(hets)
        if hets:
            scores[p] = float(2 ** len(hets))  # score 2^{num hets} (:1770-1785)
    # NB: reference marks only samples at even index (first haploid slot of
    # the diploid pair); `s` here is the first slot by construction of the
    # caller, which passes het flags on first slots only.
    while True:
        best = -1.0
        chosen = -1
        for p in range(n):
            if scores[p] > best:
                best = scores[p]
                chosen = p
        if best <= 0.0:
            break
        s = live_hets[chosen].pop()
        breaks[chosen][s] = True
        if not live_hets[chosen]:
            scores[chosen] = -1.0
        else:
            scores[chosen] /= 2.0
        # a diploid may be arbitrarily phased in at most one column per
        # locus: remove this sample from every other pattern's live list
        # (reference :1838-1862)
        for p in range(n):
            if p == chosen or scores[p] <= 0.0:
                continue
            if s in live_hets[p]:
                live_hets[p].remove(s)
                if not live_hets[p]:
                    scores[p] = -1.0
    return breaks


def phase_pattern(pattern: str, is_diploid: List[bool],
                  break_mask: List[bool]) -> List[str]:
    """Expand one canonized pattern into its phased variants
    (reference processHetPatterns + getAllPhases).

    Diploid pairs occupy consecutive slots (first slot carries the genotype
    character, second slot is a placeholder).  Each 2-way het that is not
    symmetry-broken doubles the number of phasings; the enumeration order
    (Gray-code-like alternation, first het flips fastest) follows
    getAllPhases (:2242-2290).
    """
    S = len(pattern)
    base = [""] * S
    flip_slots = []  # first-slot index of each het to enumerate
    s = 0
    while s < S:
        ch = pattern[s]
        if is_diploid[s]:
            if ch in AMBIG_PAIRS:
                b0, b1 = AMBIG_PAIRS[ch]
                base[s], base[s + 1] = b0, b1
                if not break_mask[s]:
                    flip_slots.append(s)
            elif ch in "TCAG":
                base[s] = base[s + 1] = ch
            else:
                base[s] = base[s + 1] = "N"
            s += 2
        else:
            if ch not in "TCAGN":
                # the reference exits fatally on ambiguity codes in haploid
                # samples (src/LocusDataLikelihood.c:1382-1386)
                raise ValueError(
                    f"ambiguity code {ch!r} in haploid sample slot {s}")
            base[s] = ch
            s += 1
    out = ["".join(base)]
    # getAllPhases flips hets in a reflected-binary order; any enumeration
    # of the 2^k phasings yields the same likelihood (the root sum averages
    # the group), so plain binary order is used here.
    for mask in range(1, 1 << len(flip_slots)):
        col = list(base)
        for i, s in enumerate(flip_slots):
            if (mask >> i) & 1:
                col[s], col[s + 1] = col[s + 1], col[s]
        out.append("".join(col))
    return out


def build_locus_phased(patterns: List[str], counts: List[int],
                       is_diploid: List[bool]):
    """Phase all patterns of one locus.

    Returns (phased_patterns [list of str], group_id [per phased pattern],
    group_counts [per group], group_nphases [per group])."""
    first_slots = []
    s = 0
    while s < len(is_diploid):
        if is_diploid[s]:
            first_slots.append(s)
            s += 2
        else:
            s += 1
    breaks = compute_het_symmetry_breaks(patterns, counts, is_diploid)
    phased: List[str] = []
    group_id: List[int] = []
    group_counts: List[int] = []
    group_nphases: List[int] = []
    for g, (pat, cnt) in enumerate(zip(patterns, counts)):
        variants = phase_pattern(pat, is_diploid, breaks[g])
        for v in variants:
            phased.append(v)
            group_id.append(g)
        group_counts.append(cnt)
        group_nphases.append(len(variants))
    return phased, group_id, group_counts, group_nphases


def encode_leaf_bases(phased: List[str]) -> np.ndarray:
    """[P, S] int8 base codes from phased pattern strings."""
    P = len(phased)
    S = len(phased[0]) if P else 0
    out = np.full((P, S), 4, np.int8)
    for p, pat in enumerate(phased):
        for s, ch in enumerate(pat):
            out[p, s] = _BASE_CODE.get(ch, 4)
    return out
