"""Bytes and floating-point operations of one launch of each sweep kernel
on a state of the sampler: the yardstick of the kernels' roofline shares.

A frozen copy of the port's first operation model (`op_models` of the
repository's chip check), which holds the state's tensors of one launch
and follows the kernels' loops.  Each input byte is read once and each
output byte written once; add, multiply, compare, divide, exp and log are
one operation each.  Per locus, with N nodes (S leaves), M migration
slots of which m are active, PP populations, B bands, P patterns:

  node       one node's conditional: 38 P + 16
  lnld       root log-likelihood: 9 P
  node_age   per internal node: 60 + 6 (N + m) + depth * node + lnld
  mig_age    50 per slot; per active event 2 M + 6 B + 6 (N + m) per
             population whose lineage set the event changes
  rubber_band  6 (N + M) + 2 m M + (N - S) node + lnld + 4 PP (N + m)
             + 5 sum_r n_r^2 (n_r the lineage pieces present in r)
             + 6 B (N + m)
  spr        per non-root node: K log2 K (K = N + M + PP + 2 B + 1)
             + 2 depth * node + lnld + 20; per walk trip:
             K (10 + 2 N) + K log2 K + 2 N + 40.

Departures from the copied model, both to count no more than the state
needs: the walk's trips are not counted (the program reports only the
largest draw offset of a launch, not each locus's trips, so any count
would be a guess), and with C chains each locus reads its own chain's
tau.  The bound of a launch is the larger of bytes / HBM bandwidth and
operations / float32 peak (peaks.json).  Nothing of the program under
test is imported: the state's tensors are read as they are.
"""

from __future__ import annotations

import json
import math
import os

import torch

from benchmark.reference import prior
from benchmark.reference.control import Control

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)


def bound_s(nbytes: float, ops: float, dtype: str = "float32") -> float:
    pk = peaks()
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["flops_per_s"][dtype])


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def models(gen, seq, lrng, lnld, cond, params, ctl: Control) -> dict:
    """{kernel: (bytes, operations)} of one launch on one pattern bucket's
    state (gen, seq, its per-locus random streams, lnld, cond as the
    sampler holds them: per-locus tensors chain-major) under the
    parameters ([C, P] or [P])."""
    L, N, P, _ = cond.shape
    # the streams' per-locus tensors (a counter key, or Wichmann-Hill's
    # three seeds); a counter shared by the loci is not counted
    key = [x for x in lrng if x.dim() and x.shape[0] == L]
    S = (N + 1) // 2
    M = gen.mig_branch.shape[1]
    PP, B = ctl.num_pops, len(ctl.bands)
    K = N + M + PP + 2 * B + 1
    dev = cond.device
    tree = prior.Tree(ctl, dev)
    topo = (gen.lson, gen.rson, gen.father, gen.node_pop, gen.root)
    migs = (gen.mig_branch, gen.mig_band, gen.mig_age)
    seqs = (seq.group_id, seq.group_count, seq.group_nphases,
            seq.pattern_valid)
    per_locus = (gen.mut_rate, gen.valid)
    int_l = L * 4                       # one int32 per locus
    node = 38.0 * P + 16.0
    lnld_ops = 9.0 * P
    m = (gen.mig_branch >= 0).sum(dim=1).double()
    depth = torch.zeros((L, N), dtype=torch.float64, device=dev)
    cur = torch.arange(N, device=dev).expand(L, N)
    for _ in range(N):
        on = cur >= 0
        depth += (on & (cur >= S)).double()
        cur = torch.where(on, torch.gather(gen.father, 1, cur.clamp(min=0)),
                          cur)
    out = {}
    ops = (depth[:, S:] * node + (60.0 + lnld_ops)
           + 6.0 * (N + m[:, None])).sum()
    out["node_age"] = (
        _nbytes(gen.age, *topo, *migs, *per_locus, *seqs, *key, lnld, lnld,
                cond) + _nbytes(cond, gen.age, lnld, lnld) + 2 * int_l,
        float(ops))
    if B:
        src, tgt = tree.src, tree.tgt
        changed = (tree.anc[:, src] != tree.anc[:, tgt]).sum(dim=0).double()
        act = gen.mig_branch >= 0
        per_event = (2.0 * M + 6.0 * B + 6.0 * (N + m[:, None])
                     * changed[torch.where(act, gen.mig_band, 0)])
        ops = 50.0 * M * L + torch.where(act, per_event, 0.0).sum()
        out["mig_age"] = (
            _nbytes(gen.age, gen.father, gen.node_pop, *migs, gen.valid,
                    *key, lnld) + _nbytes(gen.mig_age, lnld) + 2 * int_l,
            float(ops))
    tau = params.tau if params.tau.dim() == 2 else params.tau[None]
    C = tau.shape[0]
    rows_tau = tau.repeat_interleave(L // C, dim=0).double()
    g = {f: getattr(gen, f) for f in gen._fields}
    lo, hi, pop, valid = prior.pieces(g, tree, torch.float64)
    ws, we = tree.windows(rows_tau)
    plo = torch.maximum(lo[:, None, :], ws[:, :, None])
    phi = torch.minimum(hi[:, None, :], we[:, :, None])
    present = valid[:, None, :] & tree.anc[:, pop].permute(1, 0, 2) \
        & (phi > plo)
    n_r = present.sum(dim=2).double()
    ops = (L * (6.0 * (N + M) + (N - S) * node + lnld_ops)
           + (2.0 * m * M + (4.0 * PP + 6.0 * B) * (N + m)).sum()
           + 5.0 * (n_r ** 2).sum())
    out["rubber_band"] = (
        _nbytes(gen.age, *topo, *migs, *per_locus, *seqs, cond)
        + _nbytes(gen.age, gen.mig_age, cond, lnld, lnld) + 3 * int_l,
        float(ops))
    lgk = math.log2(K)
    not_root = torch.arange(N, device=dev)[None, :] != gen.root[:, None]
    fdepth = torch.gather(depth, 1, gen.father.clamp(min=0))
    ops = torch.where(not_root, K * lgk + 2.0 * fdepth * node + lnld_ops
                      + 20.0, 0.0).sum()
    out["spr"] = (
        _nbytes(gen.age, *topo, *migs, *per_locus, *seqs, *key, lnld, cond)
        + _nbytes(cond, gen.age, *topo, *migs, lnld) + 2 * int_l,
        float(ops))
    return out
