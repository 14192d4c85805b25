"""A plain reading of a G-PhoCS sequence file into phased site patterns.

What G-PhoCS does with an alignment (v1.3.2, src/AlignmentProcessor.c),
written here from its definition:

  * a column is the symbols of the samples at one site, a sample absent
    from the locus reading N; a column of N alone is dropped;
  * a column is replaced by its canonical form under the 24 permutations
    of the bases that leave Jukes-Cantor unchanged: the image, over all
    permutations, that comes first in the symbol order TCAGYWKMSRVDBHN,
    compared from the first sample on (an ambiguity code maps to the code
    of its permuted bases);
  * equal canonical columns of a locus merge into one pattern with their
    count, the patterns in the order of their first column;
  * a diploid sample's genotype is phased into its two haploid slots: a
    heterozygous code (Y, W, K, M, S, R) into both orders of its bases,
    each pattern thus standing for 2^h phased patterns, except where
    symmetry breaking fixes one order.  Symmetry breaking takes only
    patterns seen once in the locus, and repeatedly picks the first of the
    patterns with the highest score (2 to the number of its hets still
    open), fixes its open het of the highest slot (its bases in the code's
    order, first slot first), halves its score or drops it once no het is
    open, and closes that sample's hets in every other pattern, dropping a
    pattern whose last open het that was: so each diploid sample is
    phased arbitrarily in at most one column of a locus.

The result holds, per locus, the phased patterns' leaf bases (0..3 =
TCAG, 4 = N), the pattern each phased pattern stands for, and each
pattern's count and number of phasings.  Nothing of the program under test
is imported.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from benchmark.reference.control import Control

SYMBOLS = "TCAGYWKMSRVDBHN"
N_SYM = len(SYMBOLS)
NONE = N_SYM - 1            # N
# the bases of each two-base code, in the order G-PhoCS's translation
# table gives them (a fixed phase puts the first in the first slot)
_PAIRS = {"Y": "TC", "W": "TA", "K": "TG", "M": "AC", "S": "CG", "R": "AG"}
_BASE = {b: i for i, b in enumerate("TCAG")}


def _image_table() -> np.ndarray:
    """[24, 15]: the symbol that each base permutation maps a symbol to."""
    code_of = {frozenset(v): SYMBOLS.index(k) for k, v in _PAIRS.items()}
    out = np.zeros((24, N_SYM), np.int64)
    for pi, perm in enumerate(itertools.permutations(range(4))):
        for s, ch in enumerate(SYMBOLS):
            if s < 4:
                out[pi, s] = perm[s]
            elif ch in _PAIRS:
                out[pi, s] = code_of[frozenset(
                    "TCAG"[perm[_BASE[b]]] for b in _PAIRS[ch])]
            elif ch == "N":
                out[pi, s] = NONE
            else:  # V D B H: all bases but T, C, A, G in turn
                out[pi, s] = 10 + perm[s - 10]
    return out


IMAGES = _image_table()
_LOOKUP = np.full(256, -1, np.int64)
for _i, _c in enumerate(SYMBOLS):
    _LOOKUP[ord(_c)] = _LOOKUP[ord(_c.lower())] = _i
for _c, _t in (("U", "T"), ("-", "N"), ("?", "N")):
    _LOOKUP[ord(_c)] = _LOOKUP[ord(_c.lower())] = SYMBOLS.index(_t)


def canonical_table(g: int) -> np.ndarray:
    """Canonical code of every column of g samples, a column's code being
    its symbols read as a base-15 number, the first sample the most
    significant digit (so that codes order as columns do)."""
    codes = np.arange(N_SYM ** g)
    digits = (codes[:, None] // N_SYM ** np.arange(g - 1, -1, -1)) % N_SYM
    weights = N_SYM ** np.arange(g - 1, -1, -1)
    images = IMAGES[:, digits] @ weights                # [24, 15^g]
    return images.min(axis=0)


@dataclass
class Patterns:
    """Per locus l: leaf[l, q] the S leaf bases of phased pattern q
    (rows past the locus's own count are padding), group[l, q] the pattern
    it stands for (-1 on padding), count[l, g] and nphases[l, g] of
    pattern g (0 and 1 on padding)."""

    leaf: np.ndarray      # [L, Q, S] int8
    group: np.ndarray     # [L, Q] int64
    count: np.ndarray     # [L, G] float64
    nphases: np.ndarray   # [L, G] float64

    @property
    def num_loci(self) -> int:
        return self.leaf.shape[0]


def read_alignments(path: str, ctl: Control) -> Iterator[np.ndarray]:
    """Per locus, [bp, g] symbol indices of the control file's samples
    (g = one per sample, a diploid's genotype included once), one locus
    at a time."""
    names = [s["name"] for s in ctl.slots if s["first"]]
    col = {n: i for i, n in enumerate(names)}
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    pos = 0

    def line():
        nonlocal pos
        while not lines[pos].strip():
            pos += 1
        pos += 1
        return lines[pos - 1].split()

    for _ in range(int(line()[0])):
        _, nsamp, bp = line()
        bp = int(bp)
        out = np.full((bp, len(names)), NONE, np.int64)
        for _ in range(int(nsamp)):
            name, seq = line()
            sym = _LOOKUP[np.frombuffer(seq, np.uint8)]
            if len(sym) != bp or (sym < 0).any():
                raise ValueError(f"bad sequence of {name!r}")
            if name.decode() in col:
                out[:, col[name.decode()]] = sym
        yield out


def _breaks(hets: List[List[int]], counts: List[int]) -> List[set]:
    """The symmetry-breaking rule (module docstring); hets[p] the
    samples (in slot order) with a heterozygous code in pattern p."""
    live = [list(h) if c <= 1 else [] for h, c in zip(hets, counts)]
    score = [2.0 ** len(h) if h else -1.0 for h in live]
    fixed = [set() for _ in hets]
    while True:
        best = max(range(len(score)), key=lambda p: (score[p], -p),
                   default=None)
        if best is None or score[best] <= 0:
            return fixed
        s = live[best].pop()
        fixed[best].add(s)
        score[best] = score[best] / 2 if live[best] else -1.0
        for p in range(len(live)):
            if p != best and score[p] > 0 and s in live[p]:
                live[p].remove(s)
                if not live[p]:
                    score[p] = -1.0


def _phasings(digits, slots, first_slot, fixed):
    """The phased leaf columns ([S] codes) of one canonical column."""
    S = len(slots)
    base = np.full(S, 4, np.int8)
    flip = []
    for k, s in enumerate(first_slot):
        ch = SYMBOLS[digits[k]]
        second = s + 1 if slots[s]["diploid"] else None
        if ch in "TCAG":
            base[s] = _BASE[ch]
            if second is not None:
                base[second] = _BASE[ch]
        elif ch in _PAIRS:
            if second is None:
                raise ValueError("ambiguity code in a haploid sample")
            base[s], base[second] = (_BASE[b] for b in _PAIRS[ch])
            if k not in fixed:
                flip.append((s, second))
        elif ch != "N":
            raise ValueError(f"symbol {ch!r} is not read by this reference")
    out = []
    for mask in range(1 << len(flip)):
        col = base.copy()
        for i, (a, b) in enumerate(flip):
            if mask >> i & 1:
                col[a], col[b] = col[b], col[a]
        out.append(col)
    return out


def build(path: str, ctl: Control) -> Patterns:
    slots = ctl.slots
    first_slot = [i for i, s in enumerate(slots) if s["first"]]
    g = len(first_slot)
    table = canonical_table(g)
    weights = N_SYM ** np.arange(g - 1, -1, -1)
    all_n = int((N_SYM ** g - 1))
    per_locus = []
    for cols in read_alignments(path, ctl):
        code = table[cols @ weights]
        code = code[code != all_n]
        uniq, first, cnt = np.unique(code, return_index=True,
                                     return_counts=True)
        order = np.argsort(first)
        uniq, cnt = uniq[order], cnt[order]
        digits = (uniq[:, None] // weights) % N_SYM
        hets = [[k for k in range(g) if slots[first_slot[k]]["diploid"]
                 and SYMBOLS[d[k]] in _PAIRS] for d in digits]
        fixed = _breaks(hets, cnt.tolist())
        phased = [_phasings(d, slots, first_slot, f)
                  for d, f in zip(digits, fixed)]
        per_locus.append((phased, cnt))
    L = len(per_locus)
    Q = max([1] + [sum(len(ph) for ph in p) for p, _ in per_locus])
    G = max([1] + [len(c) for _, c in per_locus])
    leaf = np.full((L, Q, len(slots)), 4, np.int8)
    group = np.full((L, Q), -1, np.int64)
    count = np.zeros((L, G))
    nphases = np.ones((L, G))
    for l, (phased, cnt) in enumerate(per_locus):
        q = 0
        for gi, cols in enumerate(phased):
            for c in cols:
                leaf[l, q] = c
                group[l, q] = gi
                q += 1
            nphases[l, gi] = len(cols)
        count[l, :len(cnt)] = cnt
    return Patterns(leaf=leaf, group=group, count=count, nphases=nphases)
