"""Smoke run of gphocs_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (each prints its lines; any failure raises, and the
script then exits non-zero without the final line):

  1. versions of torch, CUDA and nvcc, and the card's name and power limit;
  2. the build of the CUDA kernels from gphocs_tpu_torch/csrc/ (one nvcc
     per source, started together), and what ptxas reports for each
     kernel (registers, stack frame, spills);
  3. each kernel against its plain PyTorch version on the card at f64, on
     a warmed 64-locus x 300 bp state of SAMPLE_CTL with a hot migration
     band, at 8 loci per block and at 3 (the last block partial; SPR
     against its plain version at sync_group = 1, a locus walking on its
     own): equal counter advance and accept counts, equal SPR topology and
     migration integer arrays, ages within 1e-12, lnld/lnp within 1e-9,
     conditionals within 1e-10; the rubber band's sample-age mode the same
     way on a warmed 64-locus state of SAMPLE_AGE_CTL (population D has an
     estimated sample age), for new ages below and above the old one, with
     proposals that do and do not run into a conflict: equal Jacobian
     counts and conflict flag; the outputs of every kernel and of both
     rubber-band modes at the two block sizes must be bitwise equal to each
     other, and so must those of the variant that keeps the conditionals in
     device memory (forced here; chosen by the wrapper where a locus does
     not fit in shared memory); then (3b) one f32 pass per kernel and mode
     (finite outputs, carried lnld within 1e-3 relative of a plain
     rebuild); then (3c) every kernel at f64 on a 64-locus x 16,000 bp
     state of WIDE_CTL (16 samples: N = 31, SPR grid K = 51, more than 8
     patterns), where every lane loop of the kernels takes more than one
     turn;
  4. the main path on the standard workload (SAMPLE_CTL, 1000 loci x
     1000 bp simulated with seed 20260817) at f32: Sampler.initialize,
     run() with a trace file for 50 iterations, 3 warm-up iterations and a
     timed step_chunk(25); launch counts checked against the schedule;
     carried lnld checked against a from-scratch rebuild; then (4b) each
     kernel against its plain version on the main path's own state at
     f32, with the criteria of phase 3 at F32_TOL, and each kernel's time
     beside its plain version's on that state (`ms`: CUDA events around
     the wrapper call; `device_ms`: events around the launch alone with
     the arguments prebuilt; and the device operations the wrapper puts
     on the stream besides its kernel, counted by torch.profiler); then
     (4c) the same
     sampler made hot (band rate 2e5, stepped until migrations are
     present) and the kernels held against their plain versions again at
     f32 (F32_TOL) and on an f64 copy (F64_TOL), every sweep now required
     to accept moves;
  5. the ancient-sample path at the same size and on the same sequence
     file (SAMPLE_AGE_CTL: `age 0.00002 e` on population D), driven as in
     phase 4, with the launch counts of its schedule (the rubber band 3
     times per iteration in tau mode and once in sample-age mode), the
     sample age moved, D's leaves at the sample age in every locus, the
     carried lnld equal to a rebuild; the sample-age kernel held against
     its plain version on that state at f32 and timed there, then on the
     heated state at f32 and on an f64 copy, together with the other
     kernels; then (5b) the same path with `locus-mut-rate VAR 1.0`
     (SAMPLE_AGE_VAR_CTL): rate moves accepted, mean rate 1, lnld equal to
     a rebuild;
  6. the ragged path (the ragged workload of config/samples.py RAGGED_*,
     simulated with the port's io/simulate: SAMPLE_CTL, 4,000 loci of 100
     to 4,000 bp) in 4 pattern buckets at f32, driven as in phase 4, with
     every sweep launched once per bucket and iteration (the rubber band
     3 times); the buckets' pattern capacities and cells against the dense
     run; it/s of the bucketed and the dense sampler in turns (bucketed,
     dense, dense, bucketed); every bucket's kernels against their plain
     versions at f32 (F32_TOL), then with a hot band at f32 and on an f64
     copy (F64_TOL);
     (6b) `python -m gphocs_tpu_torch` on the same file in subprocesses,
     4 buckets, 40 iterations with --debug-check, a checkpoint every 20
     iterations and a coal-stats file, beside a 20-iteration run of the
     same command; then a run resumed from a copy of the latter's
     checkpoint: trace rows 21-40 and the final checkpoint's arrays must be
     bitwise equal to the uninterrupted run's, every run must exit 0, and
     the coal-stats file must hold one finite row per iteration;
     (6c) S32_CTL (32 samples: N = 63, the kernels' MAXN) with an estimated
     sample age on D, 1000 loci x 1,000 bp (the data of the JAX package's
     S = 32 bench, scripts/bench_samples.py) in 8 buckets at f64, warmed and
     heated: per bucket the shared-memory plan of each kernel, and every
     kernel and the sample-age mode against their plain versions at
     F64_TOL, the buckets with hundreds of patterns keeping their
     conditionals in device memory;
  7. four chains side by side (`Sampler(chains=4)`) on the standard
     workload at f32: run() with a trace and --debug-check's state check
     for 10 iterations and 3 more, each sweep kernel launched once per
     sweep for all chains (the schedule of one chain), chain 0's rows in
     the trace and every chain's in `chain_rows`; the device operations of
     an iteration at C = 1 and C = 4 (torch.profiler); it/s at C = 1 and
     C = 4 in turns (1, 4, 4, 1); every kernel against its plain version
     on the 4-chain state made hot, at F32_TOL and on an f64 copy at
     F64_TOL (each chain's band rate its own), and each kernel's wrapper
     time there; every kernel and the
     sample-age mode on 4 chains x 64 loci of SAMPLE_AGE_CTL at F32_TOL and
     on an f64 copy; chain c of a 4-chain f64 run of 5 iterations against
     the one-chain run with seed base + 7919 c (equal integers, counters
     and accepts, reals within F64_TOL); and a 4-chain checkpoint at
     iteration 10 resumed to 20, every chain's rows and the final
     checkpoint bitwise equal to the uninterrupted run's;
  8. one JSON line per path with its it/s (the ragged ones with both
     readings and their pattern cells, the chains with their chain-it/s
     and device operations per iteration), the card's line, one JSON line
     with the kernels (launches on the paths, error against the plain
     version, time, the time on the 4 chains' state, the plain version's
     time, and the least time the card could take: `bound_ms`), then the
     result line.

The launch counts are set to 0 just before each path is driven and read
just after; a kernel's `launches` is the sum over the paths.

`bound_ms` is the larger of two times: the bytes of the wrapper's input
and output tensors (each once) over 3.35 TB/s, and a count of the
floating-point operations (add, multiply, compare, divide, exp and log
each as one) that the sweep does on this run's state over 67 TFLOP/s
(f32 outside the tensor cores), both NVIDIA's published H100 SXM peaks.
The operation count follows the kernels' loops with the data-dependent
terms read from the state (root-path depths, migration events per locus,
lineage segments per population, SPR walk trips from the counter
advance, which is that of the locus with the most trips); `op_models`
below states it.  No single PyTorch call computes
one of these sweeps, so `library_ms` is null for every kernel.

What was cut to keep the run short: the three paths of phases 4-5b read
one simulated sequence file, phase 5b drives its path but does not repeat
the kernel comparisons of phase 5 (the kernels do not read the VAR
setting), and phase 6c runs S32_CTL with D's sample age estimated, so that
one state serves both rubber-band modes.

It needs one CUDA card; without one it exits with status 1 and prints no
result.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKLOAD_LOCI = 1000
WORKLOAD_BP = 1000
WORKLOAD_SEED = 20260817
RUN_ITERS = 50
WARMUP = 3
TIMED = 25
TAU_PROPOSALS = 3  # ancestral populations of SAMPLE_CTL
SAMPLE_AGE_POP = 3  # population D of SAMPLE_AGE_CTL
# sample-age proposals of the kernel checks: the share of the way from the
# old age to 0 (negative) or to the upper bound (positive)
SAMPLE_AGE_STEPS = (-0.9, -0.2, 0.01, 0.3)
# phase 6: the ragged workload in pattern buckets; 6b: the command line
RAGGED_BUCKETS = 4
CHAINS = 4          # phase 7
CHAIN_ITERS = 10    # phase 7's run() with a trace
CHAIN_CHECK = 5     # f64 iterations of the chains held against one chain
CHAIN_CKPT = 10     # phase 7's checkpoint, resumed to 2 * CHAIN_CKPT
CHAIN_CKPT_LOCI = 250
CLI_ITERS = 40
CLI_CHECKPOINT = 20
# phase 6c: S = 32 (N = 63, the kernels' MAXN) at f64, on the data of the
# JAX package's S = 32 bench (scripts/bench_samples.py: 1000 loci x 1000 bp,
# seed 29), whose heavy tail of phased patterns reaches the hundreds
S32_LOCI = 1000
S32_BP = 1000
S32_SEED = 29
S32_BUCKETS = 8

# published H100 SXM peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# kernel-vs-plain tolerances (max abs difference).  F64_TOL are the
# Pallas-vs-XLA tolerances of the JAX package's tests; F32_TOL allow ~100
# f32 ulps at the values' sizes (ages ~1e-3, per-locus lnld ~1e3,
# conditionals O(1)).  A wrong move shifts a value far beyond either,
# and the counters, accept counts and integer arrays must be equal.
F64_TOL = {"age": 1e-12, "lnld": 1e-9, "cond": 1e-10, "tau": 1e-15}
F32_TOL = {"age": 1e-7, "lnld": 1e-2, "cond": 1e-5, "tau": 1e-9}


def log(msg=""):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def same(a, b):
    """Equal shapes and values (counters, counts, flags: [C] for C
    chains)."""
    import torch

    return bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b)))


def maxdiff(a, b):
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


class Compare:
    """Collects kernel-vs-plain comparisons; raises on the first miss."""

    def __init__(self):
        self.err = {}

    def close(self, kernel, name, a, b, tol):
        d = maxdiff(a, b)
        self.err[kernel] = max(self.err.get(kernel, 0.0), d)
        log(f"    {name:12s} max |kernel - plain| = {d:.3e} (tol {tol:g})")
        check(d <= tol, f"{kernel}: {name} differs by {d:.3e} > {tol:g}")

    def equal(self, kernel, name, a, b):
        import torch

        same = bool(torch.equal(a, b))
        log(f"    {name:12s} equal: {same}")
        check(same, f"{kernel}: {name} differs")


def warm_state(device, dtype, path, num_loci=64, ctl=None, seq_len=300,
               chains=1):
    """A warmed num_loci x seq_len bp Sampler on the control text `ctl`
    (SAMPLE_CTL by default) with a hot band and migrations present (also
    the fixture of tests/test_torch_csrc_host.py); with `chains`, that many
    chains side by side, each with migrations."""
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.model import build_poptree
    from gphocs_tpu_torch.sampler.driver import Sampler

    ctl = ctl or SAMPLE_CTL
    cfg = parse_control_text(ctl)
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=num_loci,
                      seq_len=seq_len, seed=11)
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = 17
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=path, dtype=dtype, device=device,
                chains=chains)
    s.initialize()
    s._sample_mig_rates_device()
    heat(s)
    return s


def heat(s):
    """Set s's band rates hot (2e5) and step until migrations are present
    (in every bucket of a bucketed sampler, in every chain)."""
    import torch
    from gphocs_tpu_torch.kernels.common import gen_log_prior

    def migs():
        return min(int((g.mig_branch >= 0).reshape(s.chains, -1).sum(
            dim=1).min()) for g in s.gens)

    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)
    for _ in range(8):
        s.step_chunk(5, do_migrate=True)
        if migs() > 0:
            break
    check(migs() > 0, "no migrations in warmup")


def spread_rates(s):
    """Give each chain of a hot chain state a band rate of its own (heat
    sets them all to 2e5): chain c's times 1 - 0.1 c."""
    import torch
    from gphocs_tpu_torch.kernels.common import gen_log_prior

    scale = 1.0 - 0.1 * torch.arange(s.chains, dtype=s.dtype,
                                     device=s.params.mig_rate.device)
    s.params = s.params._replace(mig_rate=s.params.mig_rate * scale[:, None])
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)


def bucket_view(s, k):
    """Bucket k of the sampler s as a state for kernel_checks."""
    import types

    return types.SimpleNamespace(
        gen=s.gens[k], params=s.params, seq=s.seqs[k], ctx=s.ctx, ft=s.ft,
        lrng=s.lrngs[k], grng=s.grng, tree=s.tree, cond=s.conds[k],
        lnld=s.lnlds[k], lnp=s.lnps[k])


def tau_bounds(s, pop):
    """(taub0, taub1, tauold, taunew) of a rubber-band proposal for pop
    (each [C] for C chains)."""
    import torch

    pr, c = s.params, s.ctx
    s0, s1 = c.pop_sons[pop, 0], c.pop_sons[pop, 1]
    taub0 = torch.maximum(torch.maximum(pr.tau[..., s0], pr.tau[..., s1]),
                          torch.maximum(pr.sample_age[..., s0],
                                        pr.sample_age[..., s1]))
    taub1 = (torch.full_like(taub0, c.oldage)
             if pop == s.tree.num_pops - 1
             else pr.tau[..., c.father_pop[pop]])
    tauold = pr.tau[..., pop]
    return taub0, taub1, tauold, tauold + 0.3 * (tauold - taub0)


def sample_age_bounds(s, pop, step):
    """(taub0, taub1, tauold, taunew) of a sample-age proposal for the
    current population pop: the new age lies `step` of the way from the
    old one to the upper bound (step > 0) or to 0 (step < 0)."""
    import torch

    pr, c = s.params, s.ctx
    tauold = pr.sample_age[..., pop]
    taub0 = torch.zeros_like(tauold)
    taub1 = pr.tau[..., c.father_pop[pop]]
    room = (taub1 - tauold) if step > 0 else tauold
    return taub0, taub1, tauold, tauold + step * room


def kernel_checks(s, cmp, tol, need_moves=True, cond_scale=1.0):
    """Each kernel against its plain version on the same inputs.

    `s` holds a state (a Sampler, or a cast_state copy); `tol` is F64_TOL
    or F32_TOL.  With need_moves, every sweep must accept some moves, so
    that the comparison covers accepted moves and not only rejections.
    Conditionals are compared after division by cond_scale (deep trees
    carry the x4 rescale of every level).  A state of C chains compares
    every chain's counters, counts and flags ([C]).  Returns the kernels'
    outputs (node age, migration age, SPR, then the rubber band per
    population), for comparisons between launch shapes."""
    from gphocs_tpu_torch.kernels.mig_age import update_mig_ages
    from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
    from gphocs_tpu_torch.kernels.spr import update_spr
    from gphocs_tpu_torch.kernels.tau import (rubber_band_eval_plain,
                                              update_taus, update_taus_fused)
    from gphocs_tpu_torch.ops import sweeps

    g, pr, sq, r, c = s.gen, s.params, s.seq, s.lrng, s.ctx
    ld, lp, cond = s.lnld, s.lnp, s.cond
    t_age, t_ld, t_cond = tol["age"], tol["lnld"], tol["cond"]

    log("  node_age")
    k = sweeps.node_age_sweep(g, pr, sq, r, c, s.ft.coal_time, ld, lp, cond)
    q = update_internal_node_ages(g, pr, sq, r, c, s.ft.coal_time, ld, lp,
                                  cond)
    check(same(k[1].ctr, q[1].ctr), "node_age: counter")
    check(same(k[5], q[5]), f"node_age: accepts {k[5].tolist()} "
          f"{q[5].tolist()}")
    check(int(k[5].min()) > 0 or not need_moves, "node_age: no accepts")
    log(f"    accepts {k[5].tolist()}, counter {k[1].ctr.tolist()}")
    cmp.close("node_age", "age", k[0].age, q[0].age, t_age)
    cmp.close("node_age", "lnld", k[2], q[2], t_ld)
    cmp.close("node_age", "lnp", k[3], q[3], t_ld)
    cmp.close("node_age", "cond", k[4] / cond_scale, q[4] / cond_scale,
              t_cond)
    outs = [k[0].age, k[1].ctr, *k[2:]]

    log("  mig_age")
    k = sweeps.mig_age_sweep(g, pr, r, c, s.ft.mig_time, lp)
    q = update_mig_ages(g, pr, r, c, s.ft.mig_time, lp)
    check(same(k[1].ctr, q[1].ctr), "mig_age: counter")
    check(same(k[3], q[3]), f"mig_age: accepts {k[3].tolist()} "
          f"{q[3].tolist()}")
    check(int(k[3].min()) > 0 or not need_moves, "mig_age: no accepts")
    log(f"    accepts {k[3].tolist()}, counter {k[1].ctr.tolist()}")
    cmp.close("mig_age", "mig_age", k[0].mig_age, q[0].mig_age, t_age)
    cmp.close("mig_age", "lnp", k[2], q[2], t_ld)
    outs += [k[0].mig_age, k[1].ctr, *k[2:]]

    log("  spr (plain at sync_group=1)")
    k = sweeps.spr_sweep(g, pr, sq, r, c, ld, cond)
    q = update_spr(g, pr, sq, r, c, ld, cond, sync_group=1)
    outs += [k[0].age, k[0].mig_age, k[1].ctr, k[2], k[3], k[4],
             *(getattr(k[0], f) for f in ("father", "lson", "rson", "root",
                                          "node_pop", "mig_branch",
                                          "mig_band"))]
    check(same(k[1].ctr, q[1].ctr),
          f"spr: counter {k[1].ctr.tolist()} {q[1].ctr.tolist()}")
    check(same(k[4], q[4]), f"spr: accepts {k[4].tolist()} {q[4].tolist()}")
    check(int(k[4].min()) > 0 or not need_moves, "spr: no accepts")
    log(f"    accepts {k[4].tolist()}, counter {k[1].ctr.tolist()}")
    for f in ("father", "lson", "rson", "root", "node_pop", "mig_branch",
              "mig_band"):
        cmp.equal("spr", f, getattr(k[0], f), getattr(q[0], f))
    cmp.close("spr", "age", k[0].age, q[0].age, t_age)
    cmp.close("spr", "mig_age", k[0].mig_age, q[0].mig_age, t_age)
    cmp.close("spr", "lnld", k[2], q[2], t_ld)
    cmp.close("spr", "cond", k[3] / cond_scale, q[3] / cond_scale, t_cond)

    log("  rubber_band")
    for pop in range(s.tree.num_cur_pops, s.tree.num_pops):
        b = tau_bounds(s, pop)
        k = sweeps.rubber_band_eval(g, pr, sq, c, pop, False, *b, cond)
        q = rubber_band_eval_plain(g, pr, sq, c, pop, False, *b, cond)
        check(same(k[5], q[5]) and same(k[6], q[6]),
              f"rubber_band: Jacobian counts, pop {pop}")
        check(same(k[7], q[7]), f"rubber_band: conflict, pop {pop}")
        log(f"    pop {pop}: ntj0 {k[5].tolist()} ntj1 {k[6].tolist()} "
            f"conflict {k[7].tolist()}")
        cmp.close("rubber_band", "age", k[0], q[0], t_age)
        cmp.close("rubber_band", "mig_age", k[1], q[1], t_age)
        cmp.close("rubber_band", "cond", k[2] / cond_scale,
                  q[2] / cond_scale, t_cond)
        cmp.close("rubber_band", "lnld", k[3], q[3], t_ld)
        cmp.close("rubber_band", "lnp", k[4], q[4], t_ld)
        outs += list(k)
    args = (g, pr, sq, s.grng, c, s.ft.taus, ld, lp, cond,
            s.tree.num_pops, s.tree.num_cur_pops)
    k = update_taus_fused(*args)
    q = update_taus(*args)
    cmp.equal("rubber_band", "tau accepts", k[6], q[6])
    check(same(k[2].ctr, q[2].ctr), "tau sweep: counter")
    cmp.close("rubber_band", "tau", k[1].tau, q[1].tau, tol["tau"])
    cmp.close("rubber_band", "sweep lnld", k[3], q[3], t_ld)
    return outs


def cast_state(s, dtype):
    """A copy of s's state at `dtype`, with the conditionals, lnld and lnp
    rebuilt from scratch at that dtype."""
    import types

    from gphocs_tpu_torch.kernels.common import gen_log_prior, make_context
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld

    def cast(nt):
        return type(nt)(*(x.to(dtype) if x is not None
                          and x.is_floating_point() else x for x in nt))

    g, pr = cast(s.gen), cast(s.params)
    sq = cast(s.seq)
    c = make_context(s.tree, dtype, g.age.device)
    cond, ld = full_rebuild_and_lnld(g, sq)
    return types.SimpleNamespace(
        gen=g, params=pr, seq=sq, ctx=c, ft=cast(s.ft), lrng=s.lrng,
        grng=s.grng, tree=s.tree, cond=cond, lnld=ld,
        lnp=gen_log_prior(g, pr, c))


def f32_checks(s):
    """Phase 3b: one f32 pass per kernel on the same state, cast."""
    import torch
    from gphocs_tpu_torch.kernels.common import gen_log_prior
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld

    t = cast_state(s, torch.float32)
    g, pr, sq, c = t.gen, t.params, t.seq, t.ctx

    def rel_ok(name, got, want):
        check(bool(torch.isfinite(got).all()), f"f32 {name}: not finite")
        rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        log(f"  f32 {name:12s} finite; max rel err vs plain rebuild "
            f"{rel:.2e}")
        check(rel <= 1e-3, f"f32 {name}: {rel:.2e} > 1e-3")

    k = sweeps.node_age_sweep(g, pr, sq, t.lrng, c, t.ft.coal_time, t.lnld,
                              t.lnp, t.cond)
    rel_ok("node_age", k[2], full_rebuild_and_lnld(k[0], sq)[1])
    rel_ok("node_age lnp", k[3], gen_log_prior(k[0], pr, c))
    k = sweeps.mig_age_sweep(g, pr, t.lrng, c, t.ft.mig_time, t.lnp)
    rel_ok("mig_age lnp", k[2], gen_log_prior(k[0], pr, c))
    k = sweeps.spr_sweep(g, pr, sq, t.lrng, c, t.lnld, t.cond)
    rel_ok("spr", k[2], full_rebuild_and_lnld(k[0], sq)[1])
    pop = s.tree.num_pops - 1
    b = tau_bounds(t, pop)
    k = sweeps.rubber_band_eval(g, pr, sq, c, pop, False, *b, t.cond)
    gp = g._replace(age=k[0], mig_age=k[1])
    rel_ok("rubber_band", k[3], full_rebuild_and_lnld(gp, sq)[1])


def time_cuda(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ops(fn, reps=5):
    """Device operations (kernels, copies, fills) of one call of fn,
    counted by torch.profiler over `reps` calls (rounded up: the profiler
    now and then drops an event).  None where the profiler cannot trace
    the card (no access to CUPTI): the count is a report, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    except RuntimeError as e:
        log(f"  torch.profiler failed: {e}")
        n = 0
    if n == 0:
        log("  torch.profiler saw no device operation: count not taken")
        return None
    return math.ceil(n / reps)


def equal_outputs(what, a, b):
    """Two launch shapes of the kernels gave the same bits."""
    import torch

    check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{what}: outputs differ")
    log(f"  {what}: {len(a)} output tensors bitwise equal")


def sample_age_checks(s, cmp, tol, want_conflict=False, want_clean=False,
                      cond_scale=1.0):
    """The rubber band's sample-age mode against its plain version on the
    state `s` of a configuration with an estimated sample age, for the
    proposals of SAMPLE_AGE_STEPS.  want_conflict / want_clean: some
    proposal must (must not) run into a conflict, so that both outcomes
    of the conflict scan are compared.  Returns the kernel's outputs."""
    from gphocs_tpu_torch.kernels.tau import rubber_band_eval_plain
    from gphocs_tpu_torch.ops import sweeps

    g, pr, sq, c, cond = s.gen, s.params, s.seq, s.ctx, s.cond
    pop = SAMPLE_AGE_POP
    check(bool(s.tree.update_sample_age[pop]), "no estimated sample age")
    name = "rubber_band_sample_age"
    log(f"  {name} (pop {pop})")
    from gphocs_tpu_torch.kernels.common import rows

    S = g.num_samples
    leaves = g.node_pop[:, :S] == pop
    seen = set()
    outs = []
    for step in SAMPLE_AGE_STEPS:
        b = sample_age_bounds(s, pop, step)
        k = sweeps.rubber_band_eval(g, pr, sq, c, pop, True, *b, cond)
        q = rubber_band_eval_plain(g, pr, sq, c, pop, True, *b, cond)
        check(same(k[5], q[5]) and same(k[6], q[6]),
              f"{name}: Jacobian counts, step {step}")
        check(same(k[7], q[7]), f"{name}: conflict, step {step}")
        new_age = rows(b[3], g.num_loci, 0)[:, None].expand(g.num_loci, S)
        check(bool((k[0][:, :S][leaves] == new_age[leaves]).all()),
              f"{name}: the pop's leaves are not at the new age")
        seen.update(k[7].reshape(-1).tolist())
        log(f"    step {step:+.2f}: ntj0 {k[5].tolist()} ntj1 "
            f"{k[6].tolist()} conflict {k[7].tolist()}")
        cmp.close(name, "age", k[0], q[0], tol["age"])
        cmp.close(name, "mig_age", k[1], q[1], tol["age"])
        cmp.close(name, "cond", k[2] / cond_scale, q[2] / cond_scale,
                  tol["cond"])
        cmp.close(name, "lnld", k[3], q[3], tol["lnld"])
        cmp.close(name, "lnp", k[4], q[4], tol["lnld"])
        outs += list(k)
    check(True in seen or not want_conflict, f"{name}: no conflict covered")
    check(False in seen or not want_clean,
          f"{name}: no conflict-free proposal covered")
    return outs


def f32_sample_age_check(s):
    """Phase 3b for the sample-age mode: one f32 pass on the state, cast."""
    import torch
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld

    t = cast_state(s, torch.float32)
    b = sample_age_bounds(t, SAMPLE_AGE_POP, 0.3)
    k = sweeps.rubber_band_eval(t.gen, t.params, t.seq, t.ctx,
                                SAMPLE_AGE_POP, True, *b, t.cond)
    gp = t.gen._replace(age=k[0], mig_age=k[1])
    want = full_rebuild_and_lnld(gp, t.seq)[1]
    check(bool(torch.isfinite(k[3]).all() and torch.isfinite(k[4]).all()),
          "f32 rubber_band_sample_age: not finite")
    rel = float(((k[3] - want).abs() / want.abs().clamp(min=1.0)).max())
    log(f"  f32 rubber_band_sample_age finite; max rel err vs plain "
        f"rebuild {rel:.2e}")
    check(rel <= 1e-3, f"f32 rubber_band_sample_age: {rel:.2e} > 1e-3")


def op_models(s, spr_draws, proposal=None):
    """Bytes and floating-point operations of one call of each sweep on
    the state `s` (add, multiply, compare, divide, exp, log: one each).

    Per locus, with N nodes (S leaves), M migration slots of which m are
    active, PP populations, B bands, P patterns:
      node   one node's conditional: 38 P + 16 (two edge probabilities,
             the 4-state combine of every pattern)
      lnld   root log-likelihood: 9 P
      node_age   per internal node: 60 (draws, bounds, reflect)
                 + 6 (N + m) (prior delta over the segments)
                 + depth * node (root-path refresh) + lnld
      mig_age    50 per slot; per active event 2 M + 6 B
                 + 6 (N + m) per population whose lineage set changes
      rubber band  6 (N + M) (remap) + 2 m M (conflict scan)
                 + (N - S) node + lnld
                 + 4 PP (N + m) + 5 sum_r n_r^2 (pairwise prior, n_r
                 segments present in population r) + 6 B (N + m)
      spr        per non-root node: K log2 K (grid sort, K = N + M + PP
                 + 2 B + 1) + 2 depth * node + lnld + 20; per walk trip:
                 K (10 + 2 N) (hazards) + K log2 K (prefix) + 2 N + 40;
                 trips per locus = (draws - N) / 2, `spr_draws` being the
                 sweep's counter advance (that of the locus with the most
                 trips, so an upper estimate for the others).
    The rubber band's n_r are counted on `proposal` = (ages, migration
    ages) where given, else on the state.  Returns {kernel: (bytes,
    operations)} with the rubber band's two modes under one entry."""
    import torch
    from gphocs_tpu_torch.ops.coalstats import segments

    g, c, cond = s.gen, s.ctx, s.cond
    L, N, P, _ = cond.shape
    S, M, PP, B = g.num_samples, g.max_migs, c.num_pops, c.num_bands
    K = N + M + PP + 2 * B + 1

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    topo = (g.lson, g.rson, g.father, g.node_pop, g.root)
    migs = (g.mig_branch, g.mig_band, g.mig_age)
    seqs = (s.seq.group_id, s.seq.group_count, s.seq.group_nphases,
            s.seq.pattern_valid)
    per_locus = (g.mut_rate, g.valid)
    real_l = s.lnld  # one real per locus
    int_l = nbytes(real_l) // real_l.element_size() * 4  # one int32 each

    node = 38.0 * P + 16.0
    lnld = 9.0 * P
    m = (g.mig_branch >= 0).sum(dim=1).double()          # [L]
    # internal nodes on the path from each internal node to the root
    depth = torch.zeros((L, N), dtype=torch.float64, device=cond.device)
    cur = torch.arange(N, device=cond.device).expand(L, N)
    for _ in range(N):
        on = cur >= 0
        depth += (on & (cur >= S)).double()
        cur = torch.where(on, torch.gather(g.father, 1, cur.clamp(min=0)),
                          cur)
    depth_int = depth[:, S:]

    out = {}
    ops = (depth_int * node + (60.0 + lnld) + 6.0 * (N + m[:, None])).sum()
    out["node_age"] = (
        nbytes(g.age, *topo, *migs, *per_locus, *seqs, s.lrng.key, real_l,
               real_l, cond)                       # in
        + nbytes(cond, g.age, real_l, real_l) + 2 * int_l,  # out (int64)
        float(ops))

    if B > 0:
        anc = c.is_ancestral.bool()                      # [PP, PP]
        src, tgt = c.band_source, c.band_target
        changed = (anc[:, src] != anc[:, tgt]).sum(dim=0).double()  # [B]
        act = g.mig_branch >= 0
        per_event = (2.0 * M + 6.0 * B
                     + 6.0 * (N + m[:, None])
                     * changed[torch.where(act, g.mig_band, 0)])
        ops = 50.0 * M * L + torch.where(act, per_event, 0.0).sum()
        out["mig_age"] = (
            nbytes(g.age, g.father, g.node_pop, *migs, g.valid, s.lrng.key,
                   real_l) + nbytes(g.mig_age, real_l) + 2 * int_l,
            float(ops))

    gp = g if proposal is None else g._replace(age=proposal[0],
                                               mig_age=proposal[1])
    sg = segments(gp, c.band_source)
    tau = s.params.tau
    pend = torch.where(c.father_pop < 0, torch.full_like(tau, c.oldage),
                       tau[c.father_pop.clamp(min=0)])
    lo = torch.maximum(sg.start[:, None, :], tau[None, :, None])
    hi = torch.minimum(sg.end[:, None, :], pend[None, :, None])
    present = (sg.valid[:, None, :] & (hi > lo)
               & c.is_ancestral.bool()[:, sg.base_pop].permute(1, 0, 2))
    n_r = present.sum(dim=2).double()                    # [L, PP]
    ops = (L * (6.0 * (N + M) + (N - S) * node + lnld)
           + (2.0 * m * M + (4.0 * PP + 6.0 * B) * (N + m)).sum()
           + 5.0 * (n_r ** 2).sum())
    out["rubber_band"] = (
        nbytes(g.age, *topo, *migs, *per_locus, *seqs, cond)
        + nbytes(g.age, g.mig_age, cond, real_l, real_l) + 3 * int_l,
        float(ops))

    trips = max(spr_draws - N, 0) / 2.0
    lgk = math.log2(K)
    not_root = torch.arange(N, device=cond.device)[None, :] != g.root[:, None]
    # the refreshed paths start at the father and the grandfather
    fdepth = torch.gather(depth, 1, g.father.clamp(min=0))
    ops = (torch.where(not_root, K * lgk + 2.0 * fdepth * node + lnld + 20.0,
                       0.0).sum()
           + L * trips * (K * (10.0 + 2.0 * N) + K * lgk + 2.0 * N + 40.0))
    out["spr"] = (
        nbytes(g.age, *topo, *migs, *per_locus, *seqs, s.lrng.key, real_l,
               cond)
        + nbytes(cond, g.age, *topo, *migs, real_l) + 2 * int_l,
        float(ops))
    return out


def bound(bytes_, ops):
    """(bound_ms, bound_by) from a byte and an operation count."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed_chunk(s):
    """it/s of one step_chunk(TIMED) of the sampler s, and its totals."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = s.step_chunk(TIMED, do_migrate=True)
    torch.cuda.synchronize()
    return TIMED / (time.perf_counter() - t0), st


def check_schedule(iters, buckets, sample_age):
    """The launch counts since the last reset, which must equal the
    schedule of `iters` iterations: each sweep once per bucket and
    iteration, the tau rubber band TAU_PROPOSALS times, the sample-age mode
    once where a sample age is estimated.  Returns the counts."""
    from gphocs_tpu_torch.ops import sweeps

    launches = dict(sweeps.LAUNCHES)
    n = iters * buckets
    want = {"node_age": n, "mig_age": n, "spr": n,
            "rubber_band": TAU_PROPOSALS * n,
            "rubber_band_sample_age": n if sample_age else 0}
    log(f"launches {launches} (expected {want})")
    check(launches == want, "launch counts do not match the schedule")
    return launches


def check_carried_lnld(s):
    """The carried lnld of every bucket of the sampler s equals a rebuild."""
    import torch
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld

    K = s.buckets
    for k in range(K):
        _, ld = full_rebuild_and_lnld(s.gens[k], s.seqs[k])
        rel = float(((ld - s.lnlds[k]).abs() / ld.abs()).max())
        log(f"carried lnld vs rebuild{f' (bucket {k})' if K > 1 else ''}: "
            f"max rel err {rel:.2e}; lnld sum {float(s.lnlds[k].sum()):.3f}")
        check(bool(torch.isfinite(s.lnlds[k]).all()) and rel <= 1e-3,
              "carried lnld disagrees with a rebuild")


def drive_path(label, ctl, data, tmp, card, sample_age, buckets=1):
    """Drive one path through the Sampler's entry points at f32:
    initialize and run() with a trace for RUN_ITERS iterations, WARMUP
    iterations, then a timed step_chunk(TIMED).  The launch counts are set
    to 0 just before and read just after, and must equal the schedule (each
    sweep once per bucket and iteration); the carried lnld of every bucket
    must equal a rebuild.  Returns (sampler, it/s, launches, the timed
    chunk's totals)."""
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    t0 = time.perf_counter()
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = 111
    cfg.mcmc.start_mig = 0
    cfg.mcmc.burn_in = 0
    cfg.mcmc.mcmc_iterations = RUN_ITERS
    cfg.mcmc.iterations_per_log = 25
    s = Sampler(cfg, seq_path=data, dtype=torch.float32, device="cuda",
                buckets=buckets)
    K = s.buckets
    log(f"sampler set-up {time.perf_counter() - t0:.1f} s "
        f"(L={s.num_loci}, {K} bucket(s) of {s.bucket_sizes} loci, pattern "
        f"capacity {[sq.group_id.shape[1] for sq in s.seqs]})")

    sweeps.reset_launch_counts()
    t0 = time.perf_counter()
    cols, rows = s.run(trace_path=os.path.join(tmp, f"trace_{label}.log"),
                       progress=True)
    torch.cuda.synchronize()
    log(f"run(): {RUN_ITERS} iterations in {time.perf_counter() - t0:.2f} s")
    check(rows.shape == (RUN_ITERS, len(cols)), f"trace shape {rows.shape}")
    check(bool(math.isfinite(float(abs(rows).sum()))), "trace not finite")
    s.step_chunk(WARMUP, do_migrate=True)
    its, st = timed_chunk(s)
    launches = check_schedule(RUN_ITERS + WARMUP + TIMED, K, sample_age)
    log(f"{label} path: {its:.3f} it/s at f32 ({TIMED} iterations) on {card}")
    log(f"  accepts in the timed chunk: coal {int(st.acc_coal_time)} "
        f"mig {int(st.acc_mig_time)} spr {int(st.acc_spr)} "
        f"taus {st.acc_taus.tolist()} mixing {int(st.acc_mixing)} "
        f"locus rates {int(st.acc_locus_rate)}")
    check_carried_lnld(s)
    if sample_age:
        pop = SAMPLE_AGE_POP
        ages = rows[:, cols.index("tau_D")]
        log(f"  sample age of D: {len(set(ages.tolist()))} distinct values "
            f"in the trace, now {float(s.params.sample_age[pop]):.4e}; "
            f"accepted {int(st.acc_taus[pop])} of {TIMED} in the timed chunk")
        check(len(set(ages.tolist())) > 1, "the sample age never moved")
        S = s.gen.num_samples
        leaves = s.gen.age[:, :S][s.gen.node_pop[:, :S] == pop]
        check(leaves.numel() == 2 * s.num_loci
              and bool((leaves == s.params.sample_age[pop]).all()),
              "D's leaves are not at the sample age")
    return s, its, launches, st



def ragged_phase(tmp, card, cmp):
    """Phase 6: the ragged workload, bucketed and dense, at f32.  Returns
    the it/s readings and pattern cells of each, and each one's launch
    counts."""
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.io.simulate import simulate_ragged_file
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    data = os.path.join(tmp, "ragged.txt")
    t0 = time.perf_counter()
    simulate_ragged_file(data)
    log(f"data simulated in {time.perf_counter() - t0:.1f} s")
    s, its_b1, launches, _ = drive_path(
        "ragged_buckets", SAMPLE_CTL, data, tmp, card, sample_age=False,
        buckets=RAGGED_BUCKETS)
    cells = sum(n * sq.group_id.shape[1]
                for n, sq in zip(s.bucket_sizes, s.seqs))
    log(" -- the same file dense (one bucket)")
    cfg = parse_control_text(SAMPLE_CTL)
    cfg.mcmc.random_seed = 111
    dense = Sampler(cfg, seq_path=data, dtype=torch.float32, device="cuda")
    dense.initialize()
    dense._sample_mig_rates_device()
    dense_cells = dense.num_loci * dense.seqs[0].group_id.shape[1]
    log(f"  pattern cells: {cells} in buckets of capacity "
        f"{[sq.group_id.shape[1] for sq in s.seqs]} against {dense_cells} "
        f"dense (ratio {cells / dense_cells:.3f})")
    # in turns: bucketed (drive_path's reading), dense, dense, bucketed;
    # the dense path's launches are counted from its warm-up to its second
    # reading
    sweeps.reset_launch_counts()
    dense.step_chunk(WARMUP, do_migrate=True)
    its_d1, _ = timed_chunk(dense)
    its_d2, _ = timed_chunk(dense)
    torch.cuda.synchronize()
    dense_launches = check_schedule(WARMUP + 2 * TIMED, 1, False)
    its_b2, _ = timed_chunk(s)
    log(f"  it/s at f32, in turns: buckets {its_b1:.3f}, dense "
        f"{its_d1:.3f}, dense {its_d2:.3f}, buckets {its_b2:.3f} on {card}")
    check_carried_lnld(dense)
    # the plain versions add their sums in index order, as the kernels do
    # (utils.ordered_sum): every node-age decision agrees at f32 too
    log(" -- the dense path's kernels vs their plain versions (f32, then "
        "an f64 copy)")
    kernel_checks(bucket_view(dense, 0), cmp, F32_TOL, need_moves=False)
    kernel_checks(cast_state(bucket_view(dense, 0), torch.float64), cmp,
                  F64_TOL, need_moves=False)
    del dense
    log(" -- every bucket's kernels vs their plain versions (f32)")
    for k in range(s.buckets):
        log(f"  bucket {k}: {s.bucket_sizes[k]} loci, P = "
            f"{s.seqs[k].group_id.shape[1]}")
        kernel_checks(bucket_view(s, k), cmp, F32_TOL, need_moves=False)
    log(" -- with a hot band, f32 then an f64 copy")
    heat(s)
    for k in range(s.buckets):
        log(f"  bucket {k}")
        kernel_checks(bucket_view(s, k), cmp, F32_TOL, need_moves=False)
        kernel_checks(cast_state(bucket_view(s, k), torch.float64), cmp,
                      F64_TOL, need_moves=False)
    torch.cuda.synchronize()
    return ({"ragged_buckets": (its_b1, its_b2, cells),
             "ragged_dense": (its_d1, its_d2, dense_cells)},
            {"ragged_buckets": launches, "ragged_dense": dense_launches})


def cli_phase(tmp):
    """Phase 6b: `python -m gphocs_tpu_torch` on the phase-6 file, resumed
    from the checkpoint of iteration CLI_CHECKPOINT: the trace rows after
    it and the final checkpoint equal those of the uninterrupted run."""
    import numpy as np
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL, with_settings

    def ctl(name, iterations):
        path = os.path.join(tmp, f"{name}.ctl")
        with open(path, "w") as f:
            f.write(with_settings(
                SAMPLE_CTL, seq_file=os.path.join(tmp, "ragged.txt"),
                trace_file=os.path.join(tmp, f"{name}.log"),
                coal_stats_file=os.path.join(tmp, f"{name}_coal.txt"),
                mcmc_iterations=iterations,
                iterations_per_log=CLI_CHECKPOINT, random_seed=5, burn_in=0,
                start_mig=0))
        return path

    def start(name, iterations, *flags):
        out = open(os.path.join(tmp, f"{name}.out"), "w")
        return subprocess.Popen(
            [sys.executable, "-m", "gphocs_tpu_torch", ctl(name, iterations),
             "--buckets", str(RAGGED_BUCKETS), "--checkpoint",
             os.path.join(tmp, f"{name}.npz"), "--checkpoint-every",
             str(CLI_CHECKPOINT), *flags],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT), out

    def finish(name, proc_out):
        proc, out = proc_out
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
            out.close()
        text = open(out.name).read()
        log(f"  {name}: exit {rc}; " + " | ".join(text.splitlines()[:4]))
        check(rc == 0, f"{name} failed:\n{text[-3000:]}")

    # the uninterrupted run and the first leg run side by side
    whole = start("whole", CLI_ITERS, "--debug-check")
    first = start("first", CLI_CHECKPOINT)
    finish("whole", whole)
    finish("first", first)
    shutil.copy(os.path.join(tmp, "first.npz"),
                os.path.join(tmp, "resumed.npz"))
    finish("resumed", start("resumed", CLI_ITERS, "--debug-check",
                            "--resume"))

    def lines(name):
        return open(os.path.join(tmp, f"{name}.log")).read().splitlines()

    a, b = lines("whole"), lines("resumed")
    check(len(a) == CLI_ITERS + 1 and len(b) == CLI_ITERS - CLI_CHECKPOINT
          + 1, f"trace lengths {len(a)} {len(b)}")
    check(a[CLI_CHECKPOINT + 1:] == b[1:],
          "the resumed run's trace rows differ from the uninterrupted run")
    za = np.load(os.path.join(tmp, "whole.npz"))
    zb = np.load(os.path.join(tmp, "resumed.npz"))
    check(sorted(za.files) == sorted(zb.files), "checkpoint keys differ")
    for k in za.files:
        check(np.array_equal(za[k], zb[k]), f"checkpoint array {k} differs")
    log(f"  trace rows {CLI_CHECKPOINT + 1}-{CLI_ITERS} and the "
        f"{len(za.files)} arrays of the final checkpoint bitwise equal")
    rows = open(os.path.join(tmp, "whole_coal.txt")).read().splitlines()
    vals = np.array([r.split("\t") for r in rows[1:]], float)
    check(vals.shape[0] == CLI_ITERS and bool(np.isfinite(vals).all()),
          f"coal-stats rows: {vals.shape}")
    log(f"  coal-stats file: {vals.shape[0]} finite rows of "
        f"{vals.shape[1]} columns")


def s32_phase(tmp, cmp):
    """Phase 6c: the kernels at S = 32 (N = 63) in buckets, at f64."""
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import S32_CTL
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.model import build_poptree
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    path = os.path.join(tmp, "s32.txt")
    # S32_CTL with D's sample age estimated, for the sample-age mode
    d_pop = "samples  d1 d d2 d d3 d d4 d\n"
    ctl = S32_CTL.format(seq=path, trace=os.path.join(tmp, "s32.log"))
    ctl = ctl.replace(d_pop, d_pop + "        age  0.00002 e\n")
    check("age  0.00002 e" in ctl, "S32 sample-age line not placed")
    cfg = parse_control_text(ctl)
    t0 = time.perf_counter()
    simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=S32_LOCI,
                      seq_len=S32_BP, seed=S32_SEED)
    cfg = parse_control_text(ctl)
    cfg.mcmc.random_seed = 17
    cfg.mcmc.start_mig = 0
    log(f"  simulated in {time.perf_counter() - t0:.1f} s")
    s = Sampler(cfg, seq_path=path, dtype=torch.float64, device="cuda",
                buckets=S32_BUCKETS)
    s.initialize()
    log(f"  read and initialized at {time.perf_counter() - t0:.1f} s")
    s._sample_mig_rates_device()
    heat(s)
    N, M = s.gens[0].num_nodes, s.gens[0].max_migs
    check(N == 63, f"N = {N}")
    log(f"  set up and heated in {time.perf_counter() - t0:.1f} s: N = {N}, "
        f"{s.buckets} buckets of {s.bucket_sizes} loci")
    in_device = 0
    for k in range(s.buckets):
        P = s.seqs[k].group_id.shape[1]
        plans = {kn: sweeps.smem_plan(kn, N, M, s.ctx.num_pops,
                                      s.ctx.num_bands, P, 8, sweeps.BLOCK)
                 for kn in ("node_age", "mig_age", "rubber_band", "spr")}
        in_device += sum(not p.cond_smem for kn, p in plans.items()
                         if kn != "mig_age")
        log(f"  bucket {k}: {s.bucket_sizes[k]} loci, P = {P}; smem_plan "
            + "; ".join(f"{kn} {p.loci_per_block} loci/block, "
                        f"{'shared' if p.cond_smem else 'device'}, "
                        f"{p.smem_bytes} B" for kn, p in plans.items()))
        view = bucket_view(s, k)
        kernel_checks(view, cmp, F64_TOL, need_moves=False,
                      cond_scale=float(view.cond.abs().max()))
        sample_age_checks(view, cmp, F64_TOL,
                          cond_scale=float(view.cond.abs().max()))
    check(in_device > 0, "no bucket keeps its conditionals in device memory")
    torch.cuda.synchronize()


def chains_phase(tmp, data, card, cmp):
    """Phase 7: CHAINS chains side by side on the standard workload.
    Returns (launches of its main path, its readings, the kernels' wrapper
    ms on the chains' state)."""
    import numpy as np
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_AGE_CTL, SAMPLE_CTL
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    dev = torch.device("cuda")

    def sampler(seed, chains, dtype=torch.float32, iters=CHAIN_ITERS,
                loci=-1):
        cfg = parse_control_text(SAMPLE_CTL)
        cfg.mcmc.random_seed = seed
        cfg.mcmc.start_mig = 0
        cfg.mcmc.burn_in = 0
        cfg.mcmc.mcmc_iterations = iters
        cfg.mcmc.iterations_per_log = 5
        cfg.mcmc.num_loci = loci
        return Sampler(cfg, seq_path=data, dtype=dtype, device="cuda",
                       chains=chains)

    t0 = time.perf_counter()
    log(f" -- the main path with {CHAINS} chains: run() with a trace, "
        f"{CHAIN_ITERS} iterations, then {WARMUP} more")
    s4 = sampler(111, CHAINS)
    sweeps.reset_launch_counts()
    cols, rows = s4.run(trace_path=os.path.join(tmp, "trace_chains.log"),
                        debug_check=True)
    s4.step_chunk(WARMUP, do_migrate=True)
    torch.cuda.synchronize()
    launches = check_schedule(CHAIN_ITERS + WARMUP, 1, False)
    check(len(s4.chain_rows) == CHAINS
          and all(r.shape == (CHAIN_ITERS, len(cols))
                  for r in s4.chain_rows)
          and np.array_equal(rows, s4.chain_rows[0]),
          "chain rows: the trace is not chain 0's")
    check(all(np.isfinite(r).all() for r in s4.chain_rows),
          "chain rows not finite")
    check(not np.array_equal(s4.chain_rows[0][:, 1:], s4.chain_rows[1][:, 1:]),
          "chains 0 and 1 wrote the same rows")
    check_carried_lnld(s4)
    log(f"  run() with --debug-check at every log point, {CHAINS} chains' "
        f"rows, set-up and run {time.perf_counter() - t0:.1f} s")

    log(" -- device operations per iteration, one chain against "
        f"{CHAINS} (torch.profiler, 3 iterations)")
    s1 = sampler(111, 1)
    s1.initialize()
    s1._sample_mig_rates_device()
    s1.step_chunk(WARMUP, do_migrate=True)
    ops = {}
    for c, smp in ((1, s1), (CHAINS, s4)):
        n = device_ops(lambda: smp.step_chunk(1, do_migrate=True), reps=3)
        ops[c] = n
    ratio = (ops[CHAINS] / ops[1]) if ops[1] and ops[CHAINS] else None
    log(f"  device operations per iteration: C = 1 {ops[1]}, C = {CHAINS} "
        f"{ops[CHAINS]}, ratio {ratio}")

    log(f" -- it/s in turns: C = 1, {CHAINS}, {CHAINS}, 1 ({TIMED} "
        "iterations each, f32)")
    i1a, _ = timed_chunk(s1)
    i4a, _ = timed_chunk(s4)
    i4b, _ = timed_chunk(s4)
    i1b, _ = timed_chunk(s1)
    log(f"  it/s C = 1: {i1a:.3f}, {i1b:.3f}; C = {CHAINS}: {i4a:.3f}, "
        f"{i4b:.3f} (chain-it/s {CHAINS * i4a:.3f}, {CHAINS * i4b:.3f}) on "
        f"{card}")
    del s1

    log(f" -- the kernels on the {CHAINS} chains' state, hot band: f32, "
        "then an f64 copy")
    heat(s4)
    spread_rates(s4)
    kernel_checks(s4, cmp, F32_TOL)
    kernel_checks(cast_state(s4, torch.float64), cmp, F64_TOL)
    b = tau_bounds(s4, s4.tree.num_pops - 1)
    pop = s4.tree.num_pops - 1
    g, pr, sq, c = s4.gen, s4.params, s4.seq, s4.ctx
    ms = {
        "node_age": time_cuda(lambda: sweeps.node_age_sweep(
            g, pr, sq, s4.lrng, c, s4.ft.coal_time, s4.lnld, s4.lnp,
            s4.cond), 10),
        "mig_age": time_cuda(lambda: sweeps.mig_age_sweep(
            g, pr, s4.lrng, c, s4.ft.mig_time, s4.lnp), 10),
        "rubber_band": time_cuda(lambda: sweeps.rubber_band_eval(
            g, pr, sq, c, pop, False, *b, s4.cond), 10),
        "spr": time_cuda(lambda: sweeps.spr_sweep(
            g, pr, sq, s4.lrng, c, s4.lnld, s4.cond), 10)}
    del s4, g, pr, sq, c
    log(f"  {CHAINS} chains x 64 loci of SAMPLE_AGE_CTL: every kernel and "
        "the sample-age mode, f32 then an f64 copy")
    sa = warm_state(dev, torch.float32, os.path.join(tmp, "chains_age.txt"),
                    ctl=SAMPLE_AGE_CTL, chains=CHAINS)
    spread_rates(sa)
    kernel_checks(sa, cmp, F32_TOL, need_moves=False)
    sample_age_checks(sa, cmp, F32_TOL)
    sa64 = cast_state(sa, torch.float64)
    kernel_checks(sa64, cmp, F64_TOL, need_moves=False)
    sample_age_checks(sa64, cmp, F64_TOL)
    sb = sample_age_bounds(sa, SAMPLE_AGE_POP, 0.01)
    ms["rubber_band_sample_age"] = time_cuda(
        lambda: sweeps.rubber_band_eval(sa.gen, sa.params, sa.seq, sa.ctx,
                                        SAMPLE_AGE_POP, True, *sb, sa.cond),
        10)
    del sa, sa64
    log("  wrapper ms on the chains' state (CUDA events, 10 calls; the "
        f"sample-age mode on {CHAINS} x 64 loci): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

    log(f" -- chain c of {CHAINS} (f64, {CHAIN_CHECK} iterations) against "
        "the one-chain run with seed base + 7919 c")
    base = 313
    sc = sampler(base, CHAINS, torch.float64)
    sc.initialize()
    sc._sample_mig_rates_device()
    stc, _ = sc.step_chunk(CHAIN_CHECK, do_migrate=True)
    L = sc.num_loci
    worst = 0.0
    for ci in range(CHAINS):
        s1 = sampler(base + 7919 * ci, 1, torch.float64)
        s1.initialize()
        s1._sample_mig_rates_device()
        st1, _ = s1.step_chunk(CHAIN_CHECK, do_migrate=True)
        gc, pc = sc.chain_state(ci)
        cut = slice(ci * L, (ci + 1) * L)
        for f in ("father", "lson", "rson", "node_pop", "root", "mig_branch",
                  "mig_band", "valid"):
            check(same(getattr(gc, f), getattr(s1.gen, f)),
                  f"chain {ci}: {f} differs from its one-chain run")
        check(same(sc.lrng.ctr[ci], s1.lrng.ctr)
              and same(sc.grng.ctr[ci], s1.grng.ctr),
              f"chain {ci}: counters differ")
        for f in st1._fields:
            mine = getattr(stc, f)[ci]
            if f in ("rate_var_delta", "lnld_sum", "lnp_sum"):
                continue
            check(same(mine, getattr(st1, f)), f"chain {ci}: {f} differs")
        for name, a, b, tol in (
                ("age", gc.age, s1.gen.age, F64_TOL["age"]),
                ("mig_age", gc.mig_age, s1.gen.mig_age, F64_TOL["age"]),
                ("theta", pc.theta, s1.params.theta, F64_TOL["age"]),
                ("tau", pc.tau, s1.params.tau, F64_TOL["age"]),
                ("mig_rate", pc.mig_rate, s1.params.mig_rate,
                 F64_TOL["age"] * float(s1.params.mig_rate.abs().max())),
                ("lnld", sc.lnld[cut], s1.lnld, F64_TOL["lnld"]),
                ("lnp", sc.lnp[cut], s1.lnp, F64_TOL["lnld"]),
                ("cond", sc.cond[cut], s1.cond, F64_TOL["cond"])):
            d = maxdiff(a, b)
            worst = max(worst, d / tol)
            check(d <= tol, f"chain {ci}: {name} differs by {d:.3e}")
        log(f"  chain {ci}: integers, counters and accepts equal; accepts "
            f"coal {int(st1.acc_coal_time)} spr {int(st1.acc_spr)} mixing "
            f"{int(st1.acc_mixing)}")
    log(f"  reals within F64_TOL (largest share of a tolerance {worst:.2e})")
    del sc, s1

    log(f" -- checkpoint at {CHAIN_CKPT} resumed to {2 * CHAIN_CKPT} ("
        f"{CHAINS} chains x {CHAIN_CKPT_LOCI} loci, f32)")
    runs = {}
    for name, iters, resume in (("whole", 2 * CHAIN_CKPT, False),
                                ("first", CHAIN_CKPT, False),
                                ("resumed", 2 * CHAIN_CKPT, True)):
        ck = os.path.join(tmp, f"chains_{name}.npz")
        if resume:
            shutil.copy(os.path.join(tmp, "chains_first.npz"), ck)
        smp = sampler(5, CHAINS, iters=iters, loci=CHAIN_CKPT_LOCI)
        smp.run(trace_path=os.path.join(tmp, f"chains_{name}.log"),
                checkpoint_path=ck, checkpoint_every=CHAIN_CKPT,
                resume=resume)
        runs[name] = smp.chain_rows
    for ci in range(CHAINS):
        check(np.array_equal(runs["whole"][ci][CHAIN_CKPT:],
                             runs["resumed"][ci]),
              f"chain {ci}: the resumed rows differ")
    za = np.load(os.path.join(tmp, "chains_whole.npz"))
    zb = np.load(os.path.join(tmp, "chains_resumed.npz"))
    check(sorted(za.files) == sorted(zb.files)
          and all(np.array_equal(za[k], zb[k]) for k in za.files),
          "the resumed run's final checkpoint differs")
    log(f"  every chain's rows {CHAIN_CKPT + 1}-{2 * CHAIN_CKPT} and the "
        f"{len(za.files)} arrays of the final checkpoint bitwise equal "
        f"(gen_age {za['gen_age'].shape})")
    torch.cuda.synchronize()
    readings = {"c1": [i1a, i1b], f"c{CHAINS}": [i4a, i4b],
                "ops_per_iteration": {"1": ops[1], str(CHAINS): ops[CHAINS]},
                "ops_ratio": ratio}
    return launches, readings, ms


def main():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, ROOT)
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import (SAMPLE_AGE_CTL,
                                                 SAMPLE_AGE_VAR_CTL,
                                                 SAMPLE_CTL, WIDE_CTL)
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.kernels.mig_age import update_mig_ages
    from gphocs_tpu_torch.kernels.node_age import update_internal_node_ages
    from gphocs_tpu_torch.kernels.spr import update_spr
    from gphocs_tpu_torch.kernels.tau import rubber_band_eval_plain
    from gphocs_tpu_torch.model import build_poptree
    from gphocs_tpu_torch.ops import cuda_lib, sweeps

    dev = torch.device("cuda")
    t_script = time.perf_counter()
    card = card_line()
    log("== phase 1: versions")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    log("nvcc: " + nvcc.strip().splitlines()[-1])
    log(f"card: {card}")

    log("== phase 2: kernel build")
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.library()
    log(f"built {lib.name} and loaded it in {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.resource_report():
        log("  " + line)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    log("== phase 3: kernels vs plain versions (f64, 64 loci x 300 bp)")
    cmp = Compare()
    s64 = warm_state(dev, torch.float64, os.path.join(tmp, "small.txt"))
    s64a = warm_state(dev, torch.float64, os.path.join(tmp, "small_age.txt"),
                      ctl=SAMPLE_AGE_CTL)
    # the kernels run a warp per locus and must not depend on the loci per
    # block: 3 leaves the last block partial
    main_block = sweeps.BLOCK
    outs = {}
    for block in (main_block, 3):
        sweeps.BLOCK = block
        log(f" -- {block} loci per block")
        outs[block] = kernel_checks(s64, cmp, F64_TOL) + sample_age_checks(
            s64a, cmp, F64_TOL, want_conflict=True, want_clean=True)
    sweeps.BLOCK = main_block
    equal_outputs(f"{main_block} and 3 loci per block", outs[main_block],
                  outs[3])
    log(" -- the conditionals in device memory (forced)")
    sweeps.FORCE_COND_IN_DEVICE_MEMORY = True
    in_device = kernel_checks(s64, cmp, F64_TOL) + sample_age_checks(
        s64a, cmp, F64_TOL)
    sweeps.FORCE_COND_IN_DEVICE_MEMORY = False
    equal_outputs("conditionals in device and in shared memory", in_device,
                  outs[main_block])
    del outs, in_device
    torch.cuda.synchronize()
    log("== phase 3b: f32 pass")
    f32_checks(s64)
    f32_sample_age_check(s64a)
    torch.cuda.synchronize()
    del s64, s64a

    log("== phase 3c: kernels vs plain versions wider than a warp "
        "(f64, 64 loci x 16000 bp of WIDE_CTL)")
    sw = warm_state(dev, torch.float64, os.path.join(tmp, "wide.txt"),
                    ctl=WIDE_CTL, seq_len=16000)
    _, wN, wP, _ = sw.cond.shape
    wK = wN + sw.gen.max_migs + sw.ctx.num_pops + 2 * sw.ctx.num_bands + 1
    log(f"  N={wN} K={wK} P={wP}")
    check(wK > 32 and 4 * wP > 32, "the wide fixture is not wider than a warp")
    # 15 levels of the x4 rescale: compare the conditionals relative to
    # the largest
    kernel_checks(sw, cmp, F64_TOL, cond_scale=float(sw.cond.abs().max()))
    torch.cuda.synchronize()
    del sw

    log(f"== phase 4: main path, standard workload ({WORKLOAD_LOCI} loci x "
        f"{WORKLOAD_BP} bp, f32)")
    data = os.path.join(tmp, "workload.txt")
    t0 = time.perf_counter()
    cfg = parse_control_text(SAMPLE_CTL)
    simulate_seq_file(cfg, build_poptree(cfg), data,
                      num_loci=WORKLOAD_LOCI, seq_len=WORKLOAD_BP,
                      seed=WORKLOAD_SEED)
    log(f"data simulated in {time.perf_counter() - t0:.1f} s")
    paths = {}
    s, paths["standard"], launches, _ = drive_path(
        "standard", SAMPLE_CTL, data, tmp, card, sample_age=False)
    all_launches = [launches]

    log("== phase 4b: kernels vs plain versions on the main path's state "
        f"({WORKLOAD_LOCI} loci, f32)")
    kernel_checks(s, cmp, F32_TOL, need_moves=False)
    torch.cuda.synchronize()

    log("== kernel times at the main path's shapes (f32, CUDA events)")
    g, pr, sq, c = s.gen, s.params, s.seq, s.ctx
    b = tau_bounds(s, s.tree.num_pops - 1)
    pop = s.tree.num_pops - 1
    pairs = {
        "node_age": (
            lambda: sweeps.node_age_sweep(g, pr, sq, s.lrng, c,
                                          s.ft.coal_time, s.lnld, s.lnp,
                                          s.cond),
            lambda: update_internal_node_ages(g, pr, sq, s.lrng, c,
                                              s.ft.coal_time, s.lnld, s.lnp,
                                              s.cond),
            lambda: sweeps.prepare_node_age(g, pr, sq, s.lrng, c,
                                            s.ft.coal_time, s.lnld, s.lnp,
                                            s.cond)),
        "mig_age": (
            lambda: sweeps.mig_age_sweep(g, pr, s.lrng, c, s.ft.mig_time,
                                         s.lnp),
            lambda: update_mig_ages(g, pr, s.lrng, c, s.ft.mig_time, s.lnp),
            lambda: sweeps.prepare_mig_age(g, pr, s.lrng, c, s.ft.mig_time,
                                           s.lnp)),
        "rubber_band": (
            lambda: sweeps.rubber_band_eval(g, pr, sq, c, pop, False, *b,
                                            s.cond),
            lambda: rubber_band_eval_plain(g, pr, sq, c, pop, False, *b,
                                           s.cond),
            lambda: sweeps.prepare_rubber_band(g, pr, sq, c, pop, False, *b,
                                               s.cond)),
        "spr": (
            lambda: sweeps.spr_sweep(g, pr, sq, s.lrng, c, s.lnld, s.cond),
            lambda: update_spr(g, pr, sq, s.lrng, c, s.lnld, s.cond,
                               sync_group=1),
            lambda: sweeps.prepare_spr(g, pr, sq, s.lrng, c, s.lnld,
                                       s.cond)),
    }
    times = {}

    def time_pair(name, kern, plain, prepare):
        """ms: events around the wrapper call; device_ms: events around
        the launch alone, arguments prebuilt; ops: device operations of
        one wrapper call besides the kernel."""
        k1 = time_cuda(kern, 10)
        p1 = time_cuda(plain, 2)
        k2 = time_cuda(kern, 10)
        prep = prepare()
        d1 = time_cuda(lambda: prep.launch(dev), 20)
        ops = device_ops(kern)
        ops = None if ops is None else ops - 1
        plan = prep.plan
        times[name] = {
            "ms": min(k1, k2), "plain_ms": p1, "device_ms": d1,
            "wrapper_device_ops": ops,
            "loci_per_block": plan.loci_per_block,
            "smem_bytes_per_block": plan.smem_bytes}
        log(f"  {name:24s} wrapper call {k1:.3f} / {k2:.3f} ms   launch "
            f"alone {d1:.4f} ms   plain {p1:.3f} ms   {ops} device "
            f"operations besides the kernel   "
            f"{times[name]['loci_per_block']} loci per block, "
            f"{times[name]['smem_bytes_per_block']} B of dynamic shared "
            "memory")

    for name, fns in pairs.items():
        time_pair(name, *fns)
    spr_draws = int(pairs["spr"][0]()[1].ctr) - int(s.lrng.ctr)
    prop = pairs["rubber_band"][0]()
    bounds = {k: bound(*v) + v
              for k, v in op_models(s, spr_draws, prop[:2]).items()}

    log("== phase 4c: the main path's sampler with a hot band "
        f"({WORKLOAD_LOCI} loci, f32, then cast to f64)")
    heat(s)
    log(f"  {int((s.gen.mig_branch >= 0).sum())} migrations present")
    kernel_checks(s, cmp, F32_TOL)
    log(" -- the same state cast to f64")
    kernel_checks(cast_state(s, torch.float64), cmp, F64_TOL)
    torch.cuda.synchronize()
    del s, g, pr, sq, c, pairs, prop

    log(f"== phase 5: ancient-sample path ({WORKLOAD_LOCI} loci x "
        f"{WORKLOAD_BP} bp, f32, estimated sample age on D)")
    s, paths["sample_age"], launches, _ = drive_path(
        "sample_age", SAMPLE_AGE_CTL, data, tmp, card, sample_age=True)
    all_launches.append(launches)
    log(" -- the sample-age kernel vs its plain version on this state (f32)")
    sample_age_checks(s, cmp, F32_TOL)
    torch.cuda.synchronize()
    sb = sample_age_bounds(s, SAMPLE_AGE_POP, 0.01)

    def sa_kernel():
        return sweeps.rubber_band_eval(s.gen, s.params, s.seq, s.ctx,
                                       SAMPLE_AGE_POP, True, *sb, s.cond)

    time_pair("rubber_band_sample_age", sa_kernel,
              lambda: rubber_band_eval_plain(s.gen, s.params, s.seq, s.ctx,
                                             SAMPLE_AGE_POP, True, *sb,
                                             s.cond),
              lambda: sweeps.prepare_rubber_band(s.gen, s.params, s.seq,
                                                 s.ctx, SAMPLE_AGE_POP, True,
                                                 *sb, s.cond))
    v = op_models(s, 0, sa_kernel()[:2])["rubber_band"]
    bounds["rubber_band_sample_age"] = bound(*v) + v
    log(" -- the same sampler with a hot band: every kernel, f32 then f64")
    heat(s)
    log(f"  {int((s.gen.mig_branch >= 0).sum())} migrations present")
    kernel_checks(s, cmp, F32_TOL)
    sample_age_checks(s, cmp, F32_TOL, want_conflict=True)
    log(" -- the same state cast to f64")
    s_f64 = cast_state(s, torch.float64)
    kernel_checks(s_f64, cmp, F64_TOL)
    sample_age_checks(s_f64, cmp, F64_TOL, want_conflict=True)
    torch.cuda.synchronize()
    del s, s_f64

    log("== phase 5b: the same path with VAR locus rates")
    s, paths["sample_age_var"], launches, st = drive_path(
        "sample_age_var", SAMPLE_AGE_VAR_CTL, data, tmp, card,
        sample_age=True)
    all_launches.append(launches)
    mean_rate = float(s.gen.mut_rate.double().mean())
    log(f"  locus rates: {int(st.acc_locus_rate)} accepted in the timed "
        f"chunk, mean rate {mean_rate:.8f}, variance {s.rate_var:.5f}")
    check(int(st.acc_locus_rate) > 0, "no locus-rate move accepted")
    # every pair keeps its sum up to f32 rounding, ~6e-8 a move
    check(abs(mean_rate - 1.0) <= 1e-4, f"mean rate {mean_rate}")

    log(f"== phase 6: ragged path ({RAGGED_BUCKETS} pattern buckets, f32)")
    t_phase = time.perf_counter()
    ragged, ragged_launches = ragged_phase(tmp, card, cmp)
    for label in ("ragged_buckets", "ragged_dense"):
        paths[label] = sum(ragged[label][:2]) / 2
        all_launches.append(ragged_launches[label])
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s")
    log("== phase 6b: python -m gphocs_tpu_torch, checkpoint and resume")
    t_phase = time.perf_counter()
    cli_phase(tmp)
    log(f"phase 6b: {time.perf_counter() - t_phase:.1f} s")
    log(f"== phase 6c: kernels vs plain versions at S = 32 ({S32_LOCI} loci "
        f"x {S32_BP} bp in {S32_BUCKETS} buckets, f64)")
    t_phase = time.perf_counter()
    s32_phase(tmp, cmp)
    log(f"phase 6c: {time.perf_counter() - t_phase:.1f} s")
    log(f"== phase 7: {CHAINS} chains side by side ({WORKLOAD_LOCI} loci x "
        f"{WORKLOAD_BP} bp each)")
    t_phase = time.perf_counter()
    launches, chain_read, chain_ms = chains_phase(tmp, data, card, cmp)
    paths[f"chains{CHAINS}"] = chain_read[f"c{CHAINS}"][0]
    all_launches.append(launches)
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")

    src = {"node_age": ("node_age.cu", "gphocs_tpu/ops/sweeps_pallas.py:215"),
           "mig_age": ("mig_age.cu", "gphocs_tpu/ops/sweeps_pallas.py:588"),
           "rubber_band": ("rubber_band.cu",
                           "gphocs_tpu/ops/sweeps_pallas.py:891"),
           "rubber_band_sample_age": (
               "rubber_band.cu", "gphocs_tpu/ops/sweeps_pallas.py:891"),
           "spr": ("spr.cu", "gphocs_tpu/ops/sweeps_pallas.py:1413")}
    kernels = []
    for n in src:
        by_path = dict(zip(paths, (la[n] for la in all_launches)))
        check(sum(by_path.values()) > 0, f"{n}: never launched on a path")
        b_ms, b_by, nbytes, nops = bounds[n]
        kernels.append({
            "name": n, "route": "cuda",
            "source": f"gphocs_tpu_torch/csrc/{src[n][0]}",
            "replaces": src[n][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": cmp.err[n],
            **times[n], f"ms_chains{CHAINS}": chain_ms[n], "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": nbytes, "bound_operations": nops,
            "library_ms": None})
        log(f"  {n:24s} {times[n]['ms']:.3f} ms; bound {b_ms * 1e3:.2f} us by "
            f"{b_by} ({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} Mop)")
    shutil.rmtree(tmp, ignore_errors=True)
    for label, its in paths.items():
        if label in ragged or label == f"chains{CHAINS}":
            continue
        log(json.dumps({"path": label, "it_per_s": its, "card": card}))
    c4 = chain_read[f"c{CHAINS}"]
    log(json.dumps({"path": f"chains{CHAINS}", "it_per_s": sum(c4) / 2,
                    "chain_it_per_s": CHAINS * sum(c4) / 2,
                    "readings": c4, "one_chain_readings": chain_read["c1"],
                    "ops_per_iteration": chain_read["ops_per_iteration"],
                    "card": card}))
    for label, (a, b, cells) in ragged.items():
        log(json.dumps({"path": label, "it_per_s": (a + b) / 2,
                        "readings": [a, b], "pattern_cells": cells,
                        "card": card}))
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
