"""Coalescent-statistics diagnostic outputs (twin of
gphocs_tpu/tools/coalstats_out.py, on the port's ops.coalstats.segments).

Working implementation of the reference's dormant coal-stats machinery
(printCoalStats src/GPhoCS.c:911-1040; computeFlatStats :2278,
computeNodeStats :2172, recalcStats_partitioned :2523 of src/patch.c —
disabled there by `recordCoalStats && 0` at :1771):

  * flat stats: the single-population null model — total sum n(n-1) dt
    and total coalescent count with all populations merged;
  * node stats: per leaf-pair LCA ages (model-violation diagnosis);
  * partitioned stats: each population's time window split into
    `num-pop-partitions` equal slices with per-slice sum n(n-1) dt.

Enabled with `coal-stats-file <path>` (+ optional `num-pop-partitions`).
A row covers every locus of the state: with pattern buckets, the loci of
all buckets, as they are now.
"""

from __future__ import annotations

import numpy as np
import torch

from gphocs_tpu_torch.kernels.common import pop_end
from gphocs_tpu_torch.ops.coalstats import segments
from gphocs_tpu_torch.state import GenState, Params


def _overlap_sum(lo, hi, present):
    """sum over ordered pairs of segment overlaps minus the segments'
    lengths, over the last axis (pairs within one locus and population)."""
    pair = torch.clamp(
        torch.minimum(hi[..., :, None], hi[..., None, :])
        - torch.maximum(lo[..., :, None], lo[..., None, :]), min=0.0)
    pair = pair * (present[..., :, None] & present[..., None, :])
    length = torch.clamp(hi - lo, min=0.0)
    return pair.sum(dim=(-2, -1)) - length.sum(dim=-1)


def flat_stats(gen: GenState, band_source, oldage=999.0) -> torch.Tensor:
    """[L] total coal stat with all pops merged; counts are S-1 per locus."""
    segs = segments(gen, band_source, oldage)
    zero = torch.zeros_like(segs.start)
    lo = torch.where(segs.valid, segs.start, zero)
    hi = torch.where(segs.valid, segs.end, zero)
    return _overlap_sum(lo, hi, segs.valid)


def pairwise_lca_ages(gen: GenState) -> torch.Tensor:
    """[L, S, S] age of the LCA of every leaf pair
    (reference computePairwiseLCAs, src/LocusDataLikelihood.c:1685)."""
    L, N = gen.father.shape
    S = (N + 1) // 2
    dev = gen.father.device
    nodes = torch.arange(N, device=dev)
    # anc[l, v, u]: v is an ancestor of u, or u itself
    anc = torch.eye(N, dtype=torch.bool, device=dev).repeat(L, 1, 1)
    fa = torch.where(gen.father < 0, nodes[None, :], gen.father)
    cur = nodes[None, :].repeat(L, 1)
    for _ in range(N):  # climb to the root (N bounds the depth)
        cur = torch.gather(fa, 1, cur)
        anc[torch.arange(L, device=dev)[:, None], cur, nodes[None, :]] = True
    # LCA(i, j) = the common ancestor with the least age
    common = anc[:, :, :S, None] & anc[:, :, None, :S]   # [L, N, S, S]
    age_big = torch.where(common, gen.age[:, :, None, None],
                          torch.full_like(gen.age[:, :, None, None],
                                          float("inf")))
    return age_big.min(dim=1).values


def partitioned_stats(gen: GenState, params: Params, ctx,
                      num_partitions) -> torch.Tensor:
    """[L, P, K] per-pop per-time-slice sum n(n-1) dt."""
    segs = segments(gen, ctx.band_source, ctx.oldage)
    tau = params.tau
    pe = pop_end(ctx, tau)
    present = segs.valid[:, None, :] & ctx.is_ancestral[
        :, segs.base_pop].permute(1, 0, 2)
    zero = torch.zeros((), dtype=tau.dtype, device=tau.device)
    out = []
    for k in range(num_partitions):
        lo_k = tau + (pe - tau) * (k / num_partitions)
        hi_k = tau + (pe - tau) * ((k + 1) / num_partitions)
        lo = torch.maximum(
            torch.maximum(segs.start[:, None, :], tau[None, :, None]),
            lo_k[None, :, None])
        hi = torch.minimum(
            torch.minimum(segs.end[:, None, :], pe[None, :, None]),
            hi_k[None, :, None])
        lo = torch.where(present, lo, zero)
        hi = torch.where(present, hi, zero)
        out.append(_overlap_sum(lo, hi, present))
    return torch.stack(out, dim=2)


def write_coal_stats_row(f, iteration, gens, params: Params, ctx, tree,
                         num_partitions: int = 1, mesh=None):
    """One diagnostics row: flat totals + per-pop partitioned totals +
    mean pairwise LCA ages over loci.  `gens`: the state's GenState, or a
    sequence of them (the pattern buckets), taken together.  On a loci
    mesh (a parallel/mesh.LociMesh) the sums cover every rank's loci (one
    all-reduce, which every rank makes), and f is rank 0's file (None on
    the others, which write nothing)."""
    if isinstance(gens, GenState):
        gens = [gens]

    def loci(fn):
        return np.concatenate([fn(g).cpu().numpy() for g in gens])

    fl = loci(lambda g: flat_stats(g, ctx.band_source, ctx.oldage))
    part = loci(lambda g: partitioned_stats(g, params, ctx, num_partitions))
    lca = loci(pairwise_lca_ages)
    if mesh is None:
        fl, lca = fl.sum(), lca.mean(axis=0)
        part = np.array([[part[:, p, k].sum() for k in range(part.shape[2])]
                         for p in range(part.shape[1])])
    else:
        from gphocs_tpu_torch.kernels.common import maybe_psum

        n = lca.shape[0]
        fl, part, lca, n = (x.cpu().numpy() for x in maybe_psum(
            [torch.as_tensor(x, dtype=torch.float64) for x in (
                fl.sum(dtype=np.float64), part.sum(axis=0, dtype=np.float64),
                lca.sum(axis=0, dtype=np.float64), n)], mesh))
        lca = lca / n
    if f is None:
        return
    S = lca.shape[0]
    cols = [str(iteration), f"{fl:.8g}"]
    for p in range(part.shape[0]):
        for k in range(num_partitions):
            cols.append(f"{part[p, k]:.8g}")
    for i in range(S):
        for j in range(i + 1, S):
            cols.append(f"{lca[i, j]:.8g}")
    f.write("\t".join(cols) + "\n")


def coal_stats_header(tree, num_partitions: int = 1):
    cols = ["Sample", "flat-coal-stat"]
    for name in tree.names:
        for k in range(num_partitions):
            cols.append(f"coal-stat_{name}_{k}")
    S = tree.num_samples
    for i in range(S):
        for j in range(i + 1, S):
            cols.append(f"lca_{i}_{j}")
    return "\t".join(cols)
