"""Sequence file reading and SeqData tensor assembly.

File format (reference src/AlignmentProcessor.c:468-730, manual §5):

    <numLoci>
    <locusName> <numSamples> <seqLength>
    <sampleName> <sequence>
    ...

Sample names are matched against the control file's sample list; samples
absent from a locus become all-'N'.  A diploid sample occupies two haploid
slots; its (single) genotype sequence is stored at the first slot and the
second is treated as missing at the column level (the genotype is split
into a base pair during phasing — io/patterns.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from gphocs_tpu_torch.io.patterns import (
    PatternSet,
    build_locus_phased,
    encode_leaf_bases,
)
from gphocs_tpu_torch.state import SeqData

VALID_BASES = set("TCAGUYRWSKMBDHVN-")

_NORMALIZE = {"U": "T", "-": "N"}


@dataclass
class RawAlignments:
    num_loci: int
    locus_names: List[str]
    pattern_set: PatternSet


def read_seq_file(path: str, sample_names: List[str],
                  num_loci_limit: int = -1,
                  use_native: bool = True) -> RawAlignments:
    """Read + canonize a sequence file into a deduplicated PatternSet.

    Uses the C++ ingest module (cpp/ingest.cpp, built by io/native.py)
    when available, the canonization loop being the data-loading hot
    spot, with this pure-Python reader as the fallback."""
    if use_native:
        from gphocs_tpu_torch.io.native import read_seq_file_native

        try:
            res = read_seq_file_native(path, sample_names, num_loci_limit)
        except ValueError:  # the Python reader says what is wrong
            res = None
        if res is not None:
            patterns, profiles = res
            pset = PatternSet()
            pset.patterns = patterns
            pset._index = {p: i for i, p in enumerate(patterns)}
            pset.locus_profiles = profiles
            return RawAlignments(
                num_loci=len(profiles),
                locus_names=[f"locus{i}" for i in range(len(profiles))],
                pattern_set=pset)

    with open(path) as f:
        toks = f.read().split()
    pos = 0

    def next_tok() -> str:
        nonlocal pos
        if pos >= len(toks):
            raise ValueError("unexpected end of sequence file")
        t = toks[pos]
        pos += 1
        return t

    num_loci = int(next_tok())
    if 0 < num_loci_limit < num_loci:
        num_loci = num_loci_limit

    S = len(sample_names)
    name_index = {}
    for i, nm in enumerate(sample_names):
        if nm:
            name_index[nm] = i

    pset = PatternSet()
    locus_names = []
    for locus in range(num_loci):
        lname = next_tok()
        nsamp = int(next_tok())
        slen = int(next_tok())
        seqs: List[Optional[str]] = [None] * S
        for _ in range(nsamp):
            sname = next_tok()
            seq = next_tok().upper()
            if len(seq) != slen:
                raise ValueError(
                    f"locus {lname!r}: sequence of {sname!r} has length "
                    f"{len(seq)}, expected {slen}")
            bad = set(seq) - VALID_BASES
            if bad:
                raise ValueError(
                    f"locus {lname!r}: illegal characters {bad} in "
                    f"sequence of {sname!r}")
            for a, b in _NORMALIZE.items():
                seq = seq.replace(a, b)
            idx = name_index.get(sname)
            if idx is not None:
                seqs[idx] = seq
        columns = []
        for site in range(slen):
            col = "".join(
                (seqs[s][site] if seqs[s] is not None else "N")
                for s in range(S))
            columns.append(col)
        pset.add_locus(columns)
        locus_names.append(lname)
    return RawAlignments(num_loci=num_loci, locus_names=locus_names,
                         pattern_set=pset)


def _phase_all(raw: RawAlignments, is_diploid: List[bool]):
    """Phase het patterns for every locus; returns the per-locus tuples."""
    pset = raw.pattern_set
    per_locus = []
    for locus in range(raw.num_loci):
        profile = pset.locus_profiles[locus]
        pats = [pset.patterns[pid] for pid, _ in profile]
        counts = [c for _, c in profile]
        per_locus.append(build_locus_phased(pats, counts, is_diploid))
    return per_locus


def _assemble(per_locus, S: int, P: int, dtype) -> SeqData:
    """Assemble SeqData tensors padded to P phased patterns."""
    L = len(per_locus)
    leaf_base = np.full((L, S, P), 4, np.int8)
    group_id = np.tile(np.arange(P, dtype=np.int32), (L, 1))
    group_count = np.zeros((L, P), dtype)
    group_nphases = np.ones((L, P), dtype)
    pattern_valid = np.zeros((L, P), bool)
    for locus, (phased, gid, gcounts, gph) in enumerate(per_locus):
        n = len(phased)
        if n:
            leaf_base[locus, :, :n] = encode_leaf_bases(phased).T
            group_id[locus, :n] = np.asarray(gid, np.int32)
            pattern_valid[locus, :n] = True
        for g, (c, k) in enumerate(zip(gcounts, gph)):
            group_count[locus, g] = c
            group_nphases[locus, g] = k
    return SeqData(leaf_base=leaf_base, group_id=group_id,
                   group_count=group_count, group_nphases=group_nphases,
                   pattern_valid=pattern_valid,
                   group_members=group_members(group_id))


def group_members(group_id: np.ndarray) -> np.ndarray:
    """[L, J, P] pattern indices of the phase groups: entry [l, j, g] is
    the j-th pattern of group g of locus l, or P where the group has fewer
    than j + 1 patterns; J is the largest group.  Group ids never decrease
    along the pattern axis (the padding patterns have ids P_valid, ...,
    P - 1), so a group's patterns are contiguous."""
    L, P = group_id.shape
    size = np.zeros((L, P), np.int64)
    np.add.at(size, (np.arange(L)[:, None], group_id), 1)
    start = np.cumsum(size, axis=1) - size
    j = np.arange(max(1, int(size.max())))[None, :, None]
    return np.where(j < size[:, None, :], start[:, None, :] + j, P)


def build_seq_data(raw: RawAlignments, is_diploid: List[bool],
                   pad_patterns: Optional[int] = None,
                   dtype=np.float64) -> SeqData:
    """Phase het patterns per locus and assemble the padded SeqData tensors."""
    per_locus = _phase_all(raw, is_diploid)
    max_p = max([1] + [len(p[0]) for p in per_locus])
    P = pad_patterns or max_p
    if P < max_p:
        raise ValueError(f"pad_patterns={P} below max patterns {max_p}")
    return _assemble(per_locus, len(is_diploid), P, dtype)


def build_seq_data_buckets(raw: RawAlignments, is_diploid: List[bool],
                           num_buckets: int, dtype=np.float64):
    """Bucketed assembly for ragged loci (the reference keeps exact
    per-locus profiles, src/AlignmentProcessor.h:25-31; fixed-shape
    tensors pad — bucketing pads only to each bucket's own max).

    Loci are sorted by phased-pattern count and split into num_buckets
    contiguous groups of near-equal size.  Returns
    (perm, sizes, [SeqData per bucket]) where perm maps sorted position
    -> original locus index (apply `arr[perm]` to reorder per-locus
    arrays into bucket order).
    """
    per_locus = _phase_all(raw, is_diploid)
    L = len(per_locus)
    num_buckets = max(1, min(num_buckets, L))
    counts = np.array([max(1, len(p[0])) for p in per_locus])
    perm = np.argsort(counts, kind="stable")
    bounds = _bucket_bounds(counts[perm], num_buckets)
    sizes, seqs = [], []
    S = len(is_diploid)
    for b in range(len(bounds) - 1):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        if hi <= lo:
            continue
        sub = [per_locus[i] for i in perm[lo:hi]]
        P = max(1, max(len(p[0]) for p in sub))
        sizes.append(hi - lo)
        seqs.append(_assemble(sub, S, P, dtype))
    return perm, sizes, seqs


def _bucket_bounds(sorted_counts: np.ndarray, num_buckets: int) -> list:
    """Bucket boundaries minimizing total padded cells sum_k L_k * Pmax_k.

    Phased-pattern counts are extremely heavy-tailed (a single 2^k
    phasing-expansion whale can be ~1000x the median), so equal-SIZE
    buckets waste orders of magnitude of memory/compute padding the top
    bucket; the exact DP below isolates whales in their own (tiny)
    buckets.  Useful boundaries only occur where the sorted count value
    changes, so the DP runs over the <=O(distinct values) candidate
    positions."""
    L = len(sorted_counts)
    # candidate boundary positions: 0, L, and every value change
    cand = [0] + [i for i in range(1, L)
                  if sorted_counts[i] != sorted_counts[i - 1]] + [L]
    cand = sorted(set(cand))
    m = len(cand)

    def seg_cost(a, b):  # cand[a]..cand[b] as one bucket
        lo, hi = cand[a], cand[b]
        return (hi - lo) * int(sorted_counts[hi - 1])

    INF = float("inf")
    K = min(num_buckets, m - 1)
    dp = [[INF] * m for _ in range(K + 1)]
    back = [[0] * m for _ in range(K + 1)]
    dp[0][0] = 0.0
    for k in range(1, K + 1):
        for b in range(1, m):
            for a in range(b):
                if dp[k - 1][a] == INF:
                    continue
                c = dp[k - 1][a] + seg_cost(a, b)
                if c < dp[k][b]:
                    dp[k][b] = c
                    back[k][b] = a
    # best k <= K ending at L
    best_k = min(range(1, K + 1), key=lambda k: dp[k][m - 1])
    bounds = [cand[m - 1]]
    b = m - 1
    for k in range(best_k, 0, -1):
        b = back[k][b]
        bounds.append(cand[b])
    return list(reversed(bounds))
