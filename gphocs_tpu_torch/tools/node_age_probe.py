"""Where the node-age kernel and its plain version decide a move
differently at f32, step by step, on one CUDA card.

    python -m gphocs_tpu_torch.tools.node_age_probe [--loci 4000]
        [--states 4] [--every 10]

Builds the kernels with -DSWEEP_PROBE (csrc/node_age.cu then writes every
step's proposal, prior delta, likelihood delta, uniform, log acceptance
ratio and decision), makes the dense ragged state of chip_smoke.py's phase
6 at f32 (the ragged workload of config/samples.py, one bucket, seed 111,
53 iterations), and runs the kernel and the plain version
(kernels/node_age.py, with its per-step record) on it, then on the states
`every` iterations further on, `states` states in all.

For each step it counts the loci whose earlier decisions all agree and,
among them, those where the two sides give equal bits for the proposal,
the prior delta and the proposed lnld; and it recomputes the overlap
integral of node_age_move_delta and the group terms of lnld_from_cond
here, in index order (utils.ordered_sum, the kernel's order), against the
kernel's bits.  Every decision that differs is printed from both sides
with |lnacc - log u|.  Before the plain version summed in index order
(PERF.md, PR 6), torch.sum's tree order on CUDA decided about one move in
10^4 of this state differently at f32.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

COLS = ("tnew", "dlnp", "dlnld", "u", "lnacc", "accept", "lnld_prop",
        "integral")


def _integral_ordered(gen, ctx, node, tnew):
    """The overlap integral of ops/coalstats.node_age_move_delta, its
    segment terms added in index order."""
    import torch
    from gphocs_tpu_torch.ops.coalstats import segments
    from gphocs_tpu_torch.utils import ordered_sum

    t = gen.age[:, node]
    pop = gen.node_pop[:, node]
    w0, w1 = torch.minimum(t, tnew), torch.maximum(t, tnew)
    segs = segments(gen, ctx.band_source, ctx.oldage)
    present = segs.valid & ctx.is_ancestral[pop[:, None], segs.base_pop]
    lo = torch.maximum(segs.start, w0[:, None])
    hi = torch.minimum(segs.end, w1[:, None])
    return ordered_sum(torch.where(present, torch.clamp(hi - lo, min=0.0),
                                   torch.zeros_like(lo)))


def _lnld_ordered(cond, gen, seq):
    """lnld_from_cond with its group terms added in index order."""
    import torch
    from gphocs_tpu_torch.ops.likelihood_cache import _group_sums
    from gphocs_tpu_torch.ops.pruning import sum4
    from gphocs_tpu_torch.utils import ordered_sum

    L, N, P, _ = cond.shape
    S = (N + 1) // 2
    ar = torch.arange(L, device=cond.device)
    root_sum = sum4(cond[ar, gen.root])
    root_sum = torch.where(seq.pattern_valid, root_sum,
                           torch.zeros_like(root_sum))
    seg = _group_sums(root_sum, seq)
    safe = torch.where(seq.group_count > 0, seg, torch.ones_like(seg))
    return ordered_sum(seq.group_count * (
        torch.log(safe) - torch.log(4.0 * seq.group_nphases)
        - (S - 1) * math.log(4.0)))


def probe(s, label):
    """Kernel against plain version on the sampler s's state."""
    import torch
    from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
    from gphocs_tpu_torch.ops import cuda_lib, sweeps

    g, pr, sq, r, c = s.gen, s.params, s.seq, s.lrng, s.ctx
    L, N = g.father.shape
    p = sweeps.prepare_node_age(g, pr, sq, r, c, s.ft.coal_time, s.lnld,
                                s.lnp, s.cond)
    buf = torch.zeros((L, cuda_lib.MAXN, 8), dtype=torch.float64,
                      device=g.age.device)
    p.args.prof = buf.data_ptr()
    p.launch(g.age.device)
    rec = []
    q = update_internal_node_ages(g, pr, sq, r, c, s.ft.coal_time, s.lnld,
                                  s.lnp, s.cond, record=rec)
    torch.cuda.synchronize()
    acc_k = int(p.out["acc"].sum())
    print(f"{label}: accepts kernel {acc_k}, plain {int(q[5])}")
    same = torch.ones(L, dtype=torch.bool, device=g.age.device)
    dt = g.age.dtype
    for i, st in enumerate(rec):
        k = buf[:, i, :]
        # the kernel's values at the sampler's dtype (exact: a widened f32)
        kv = {n: k[:, j].to(dt) for j, n in enumerate(COLS)}
        acc_p = st["accept"]
        acc_kk = kv["accept"] > 0
        pv = {"tnew": st["tnew"], "dlnp": st["dlnp"],
              "dlnld": st["lnld_prop"] - st["lnld"], "u": st["u"],
              "lnacc": st["lnacc"], "lnld_prop": st["lnld_prop"]}
        integ = _integral_ordered(st["gen"], c, st["node"], st["tnew"])
        lnld_o = _lnld_ordered(st["cond_prop"], st["gen"], sq)
        n = int(same.sum())
        parts = [f"step {i} (node {st['node']}): {n} loci with equal "
                 "history;"]
        for name in ("tnew", "dlnp", "u", "lnld_prop"):
            eq = int(((kv[name] == pv[name]) & same).sum())
            parts.append(f"{name} equal {eq}")
        eq_i = int(((kv["integral"] == integ) & same).sum())
        eq_l = int(((kv["lnld_prop"] == lnld_o) & same).sum())
        parts.append(f"| index-order sums: integral equal {eq_i}, "
                     f"lnld_prop equal {eq_l}")
        print("  " + " ".join(parts))
        differ = same & (acc_p != acc_kk)
        for l in differ.nonzero().flatten().tolist():
            print(f"  DECISION DIFFERS at locus {l}, step {i} (node "
                  f"{st['node']}), P = {int(sq.pattern_valid[l].sum())} "
                  "valid patterns:")
            for side, vals in (("kernel", kv), ("plain ", pv)):
                lnacc = float(vals["lnacc"][l])
                u = float(vals["u"][l])
                print(f"    {side}: tnew {float(vals['tnew'][l])!r} dlnp "
                      f"{float(vals['dlnp'][l])!r} lnld_prop - lnld "
                      f"{float(vals['dlnld'][l])!r} u {u!r} lnacc "
                      f"{lnacc!r} log u {math.log(u)!r} |lnacc - log u| "
                      f"{abs(lnacc - math.log(u)):.3e}")
            print(f"    plain, index-order sums: integral "
                  f"{float(integ[l])!r} (kernel {float(kv['integral'][l])!r})"
                  f"; lnld_prop {float(lnld_o[l])!r} (kernel "
                  f"{float(kv['lnld_prop'][l])!r}, plain "
                  f"{float(pv['lnld_prop'][l])!r})")
        same = same & (acc_p == acc_kk)
    return acc_k != int(q[5])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loci", type=int, default=4000)
    ap.add_argument("--states", type=int, default=4)
    ap.add_argument("--every", type=int, default=10)
    a = ap.parse_args(argv)

    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.io.simulate import simulate_ragged_file
    from gphocs_tpu_torch.ops import cuda_lib
    from gphocs_tpu_torch.sampler.driver import Sampler
    from gphocs_tpu_torch.tools.profile_main import _card

    if not torch.cuda.is_available():
        print("node_age_probe: no CUDA device")
        return 1
    cuda_lib.NVCC_FLAGS += ("-DSWEEP_PROBE",)  # before the first build
    print(f"card: {_card()}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ragged.txt")
        simulate_ragged_file(path, num_loci=a.loci)
        cfg = parse_control_text(SAMPLE_CTL)
        cfg.mcmc.random_seed = 111
        s = Sampler(cfg, seq_path=path, dtype=torch.float32, device="cuda")
        s.initialize()
    s._sample_mig_rates_device()
    s.step_chunk(3, do_migrate=True)
    s.step_chunk(25, do_migrate=True)
    s.step_chunk(25, do_migrate=True)
    it = 53
    found = 0
    for k in range(a.states):
        found += probe(s, f"dense ragged state after {it} iterations "
                          f"(L = {s.num_loci}, P = {s.seq.group_id.shape[1]}, "
                          "f32)")
        if k + 1 < a.states:
            s.step_chunk(a.every, do_migrate=True)
            it += a.every
    print(f"states whose accept counts differ: {found} of {a.states}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
