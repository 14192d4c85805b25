"""Smoke run of gphocs_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

(DIR: a checkout of another commit, such as the parent, whose phase-14b
chunk must give the same trace rows.)

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
     turn; then (3d) each kernel's static shared memory as the runtime
     reports it, and every kernel at f32 and f64 at each pattern count P
     whose planned dynamic shared memory lies within the static reserve
     below 48 KiB (the plan entries in csrc/ say which), at S = 8 and at
     S = 32 (N = 63): a warmed 64-locus x 300 bp state with its patterns
     padded to P, each kernel once as planned and once with its
     conditionals in device memory (forced), the two bitwise equal at f64;
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
  8. the admixed path (ADMIX_CTL: sample `one` named in B as well, so
     its two haploid leaves are admixed) on the standard workload's data
     at f32, driven as in phase 4 (the launch schedule of the standard
     path), the coefficients moved, the carried lnld and lnp against a
     rebuild and gen_log_prior (admixture terms included),
     admixture-trace.out with 1 + A L shares in [0, 1] and the A...
     trace columns inside (0, 1); every kernel against its plain version
     on that state at F32_TOL and on an f64 copy at F64_TOL, SPR's
     admixed mode with at least one admixed leaf moved to its other
     population and one kept, and its time beside the plain version's;
     both rubber-band modes under admixture on 64 loci of ADMIX_AGE_CTL
     (D's sample age estimated) at f64 and f32; chain c of 2 admixed f64
     chains (64 loci) against its one-chain run; and `python -m
     gphocs_tpu_torch` on the card with an admixed control file: a
     checkpoint at 10 resumed to 20 (rows and checkpoint bitwise equal to
     the uninterrupted run's), and --chains 2;
  9. the loci mesh (parallel/mesh.py) on the standard workload: (9a) a
     world of one over NCCL in this process, MESH_F32_ITERS iterations at
     f32 bitwise equal to the same chunk without a mesh from the same
     state (stats, trace, gathered state, counters) with the same launch
     counts; (9b) two ranks sharing the card over gloo, started as
     `chip_smoke.py --mesh-rank`: at f64 MESH_F64_ITERS iterations of 1000
     loci (500 per rank) and of MESH_PAD_LOCI loci (one padding locus, kept
     inert) against the one-process run (padded alike) with equal accept
     counts, counters and integer arrays and reals within 1e-9 relative,
     each rank launching the schedule's kernels; at f32 MESH_F32_ITERS
     timed iterations with finite rows and the carried lnld within
     F32_TOL of a rebuild; (9c) `python -m gphocs_tpu_torch --distributed
     127.0.0.1:PORT:2:r --x64`, two processes sharing the card, whose
     rank 0 trace must equal the one-process command's within 1e-9
     relative per column while rank 1 writes no file.  It prints the it/s
     of the one-process and the 2-rank run at f32, and the all-reduces
     per iteration with the host's time in them (none of them a claim:
     gloo waits for the device at every collective);
 10. the conformance mode (`rng_mode="legacy"`: the Wichmann-Hill
     streams; the node-age, migration-age and SPR sweeps as tensor code,
     the rubber band's kernel): (10a) the streams on the card, rndu bitwise
     equal to the reference C implementation's values, the normals within
     5e-15, masked lanes unmoved, 4,096 lanes (one wrapping) bitwise equal
     to the CPU's; (10b) LEGACY_LOCI loci of the standard workload's file
     at f64, plain, with D's sample age, with that and VAR rates, and
     admixed: LEGACY_ITERS iterations on the card, each held against one
     iteration of the CPU's sampler from the same state (equal accept
     counts, streams and integer arrays, reals within 1e-9 relative; a
     free-running pair drifts apart, since an ulp of the card's log or exp
     grows through the SPR walks), with the launch schedule (no node-age,
     migration-age or SPR kernel, the rubber band 3 times an iteration
     and once more for the sample age); (10c) a checkpoint at iteration
     LEGACY_CKPT resumed on the card, rows and final checkpoint bitwise
     equal to the uninterrupted run's; (10d) `python -m gphocs_tpu_torch
     --legacy-rng` on the card, in a process that runs beside 10a-10c;
     (10e) the standard workload at f32 and
     f64: it/s (median of 3 chunks), and per iteration the device
     operations, the device's busy time and idle share (torch.profiler),
     the rubber band's launches and the other kernels' (0);
 11. the legacy RNG with chains: (11a) LEGACY_CHAINS chains of
     LEGACY_LOCI loci at f64, plain, with D's sample age and VAR rates,
     and admixed: chain c at iteration 0 equal to the one-chain legacy
     initialization with seed 111 + 7919 c (genealogies, parameters,
     streams bitwise; lnld and lnp within 1e-12 relative), then
     LEGACY_CHAIN_ITERS iterations on the card, each held against one
     CPU iteration from the same state as in 10b (per-chain accepts,
     streams and integers equal, reals within 1e-12 relative), with the
     launch schedule of one chain; (11b) a 2-chain checkpoint at
     iteration LEGACY_CKPT resumed on the card, every chain's rows and
     the final checkpoint (grng_* [C, 1], lrng_* [C, L]) bitwise equal to
     the uninterrupted run's; (11c) `python -m gphocs_tpu_torch
     --legacy-rng --chains 2 -v` beside 11a-11b: exit 0, the start line
     naming mode and chains, the trace rows, a method time for every
     family and none unavailable; the native sequence reader built, and
     the set-up of the standard and the ragged file with and without it;
     (11d) the standard workload at f32 as LEGACY_BIG_CHAINS legacy
     chains: it/s and chain-it/s (median of 3 chunks), device operations,
     busy ms and idle share per iteration, the rubber band 3 launches an
     iteration and the other kernels none.  Phase 4 also reads the
     migration-age kernel three ways (`device_ms`, tools/kernel_times.py
     and the profiling family) on three states, with their live
     migration events;
 12. chains on the loci mesh: (12a) MESH_CHAINS chains of the standard
     workload at f32 in a world of one over NCCL, MESH_CHAINS_PAIRS
     pairs of chunks in turns with the same chains without a mesh, each
     pair from one state (bitwise equal stats, trace, gathered state,
     counters, launches: each kernel once per sweep for all chains),
     with the all-reduces and the host's ms in them per iteration, the
     chain-it/s of both, and torch.profiler's wall, busy and host ms per
     iteration of each (the host operations that take more time meshed);
     (12b) two ranks sharing the card over gloo, each holding
     its block of every chain, MESH_CHAINS_F64 chains at f64 on 1000 and
     MESH_PAD_LOCI loci (one padding locus per chain, kept inert) against
     one process running the same chains with loci_multiple=2, as in 9b;
     (12c) `python -m gphocs_tpu_torch --distributed ... --chains
     MESH_CHAINS_F64 --x64`, two processes, MESH_CLI_ITERS iterations
     against the one-process command (1e-9 relative per column), and a
     run resumed from the checkpoint of iteration MESH_CHAINS_CKPT whose
     rows and final checkpoint ([C, L, ...]) must equal the uninterrupted
     meshed run's bitwise, rank 1 writing no file;
 13. the legacy RNG on the loci mesh: (13a) the standard workload with
     `locus-mut-rate VAR 1.0` (legacy_var_ctl: the serial rate update
     crosses the ranks) at f32 in a world of one over NCCL, one chain and
     2, LEGACY_MESH_ITERS chunks of one iteration each way in turns with
     the same sampler without a mesh from one state, each meshed chunk
     bitwise equal (stats, trace, gathered state, Wichmann-Hill streams)
     with the same launches (the rubber band 3 an iteration, no other
     kernel), with the all-reduces, broadcasts and gathers per iteration
     and the host's ms in them, it/s each way, and one profiled meshed
     iteration (device operations, busy ms, idle share); (13b) two ranks
     sharing the card over gloo at f64, `chip_smoke.py --mesh-rank` with
     rng_mode "legacy" in its spec: LEGACY_MESH_WORKLOADS (VAR rates
     with D's sample age and admixed, LEGACY_LOCI loci and one fewer,
     one chain and 2), each card iteration held against one iteration of
     a one-process CPU sampler with loci_multiple=2 from the same
     gathered state, as in 10b (accepts per chain, streams and integer
     arrays equal, reals within 1e-9 relative), each rank launching the
     legacy schedule, and the rubber band (both modes where D's sample
     age is estimated) against its plain version on each rank's block;
     (13c) `python -m gphocs_tpu_torch --legacy-rng --distributed ...
     --chains 2 --x64`, two processes, LEGACY_MESH_CLI_ITERS iterations
     of LEGACY_LOCI loci against the one-process command (1e-9 relative
     per column), and a run resumed from the checkpoint of iteration
     LEGACY_MESH_CKPT whose rows and final checkpoint ([C, Lp, ...],
     lrng_* [C, Lp], grng_* [C, 1]) must equal the uninterrupted meshed
     run's bitwise, rank 1 writing no file;
 14. the counter streams' draw kernel (csrc/counter_draw.cu,
     counter_draw_phase): (14a) its uniforms bitwise equal to the CPU's
     ATen chain (rng_fast.raw_bits) for one lane, 37 lanes and 3 chains
     (per-lane and general streams, int and per-lane offsets, n and 3n
     consecutive draws), counters low and wrapping past 2^32, f32 and f64, and every output (normals too)
     bitwise equal to the ATen chain run on the card; the draw kernel's
     device us, bound and host us beside the ATen chain's at two shapes
     (draw_times); (14b) sample_1k's data and set-up (benchmark/, seed
     DRAW_SEED) at f64: one chunk of DRAW_ITERS iterations run by this
     checkout and by DIR (`--parent`) in processes of their own
     (`chip_smoke.py --chunk-rows ROOT DATA SEED OUT`), trace rows and
     counters bitwise equal; then DRAW_ITERS card iterations, each held
     against one CPU iteration from the same state (SPR walking locus by
     locus on both: accepts, counters and integers equal, reals within
     2e-5 of each field's largest), 12 draw launches an iteration on the
     card and none on the CPU, their rows bitwise equal to the chunk's;
     with DIR, the same with the card's draws on the ATen chain, whose
     rows and largest difference from the CPU must be the same;
 15. one JSON line per path with its it/s (the ragged ones with both
     readings and their pattern cells, the chains with their chain-it/s
     and device operations per iteration, the mesh with phase 9's
     readings, the legacy paths with phases 10e's and 11d's, the meshed
     chains with phase 12's, the legacy mesh with phase 13's), the card's
     line, one JSON line
     with the kernels (launches on the paths, error against the plain
     version, time, the time on the 4 chains' state, the plain version's
     time, and the least time the card could take: `bound_ms`), then the
     result line.

The launch counts are set to 0 just before each path is driven and read
just after; a kernel's `launches` is the sum over the paths.  The entry
`spr_admix` is SPR's admixed mode: its launches are the admixed path's
SPR launches (counted under `spr` as well), its times and bound those
on the admixed path's state.

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
setting), phase 6c runs S32_CTL with D's sample age estimated, so that
one state serves both rubber-band modes, and phases 10 and 11 hold the
card against the CPU at 64 loci (11: 2 chains, 3 iterations per
workload): the serial rate update takes a host synchronization per
locus.  Phase 13 holds the card against the CPU at 64 and 63 loci on
four workloads of two iterations each (not the cross product of control
file, chain count and padding), and 13a, whose rate update walks 1000
loci with ~760 device operations each (8-17 s an iteration on the card),
runs LEGACY_MESH_ITERS iteration each way per chain count and profiles
the meshed sampler only.

It needs one CUDA card; without one it exits with status 1 and prints no
result.  `chip_smoke.py --mesh-rank SPEC RANK` is a rank of phase 9b,
12b or 13b, started by the phase itself.
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
    from gphocs_tpu_torch.kernels.tau import update_taus, update_taus_fused
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

    outs += rubber_band_checks(s, cmp, tol, cond_scale)
    args = (g, pr, sq, s.grng, c, s.ft.taus, ld, lp, cond,
            s.tree.num_pops, s.tree.num_cur_pops)
    k = update_taus_fused(*args)
    q = update_taus(*args)
    cmp.equal("rubber_band", "tau accepts", k[6], q[6])
    check(same(k[2].ctr, q[2].ctr), "tau sweep: counter")
    cmp.close("rubber_band", "tau", k[1].tau, q[1].tau, tol["tau"])
    cmp.close("rubber_band", "sweep lnld", k[3], q[3], t_ld)
    return outs


def rubber_band_checks(s, cmp, tol, cond_scale=1.0):
    """The rubber band's τ mode against its plain version on the state
    `s`, one proposal per ancestral population (tau_bounds): equal
    Jacobian counts and conflict flags, reals within `tol`.  Returns the
    kernel's outputs."""
    from gphocs_tpu_torch.kernels.tau import rubber_band_eval_plain
    from gphocs_tpu_torch.ops import sweeps

    g, pr, sq, c, cond = s.gen, s.params, s.seq, s.ctx, s.cond
    log("  rubber_band")
    outs = []
    for pop in range(s.tree.num_cur_pops, s.tree.num_pops):
        b = tau_bounds(s, pop)
        k = sweeps.rubber_band_eval(g, pr, sq, c, pop, False, *b, cond)
        q = rubber_band_eval_plain(g, pr, sq, c, pop, False, *b, cond)
        check(same(k[5], q[5]) and same(k[6], q[6]),
              f"rubber_band: Jacobian counts, pop {pop}")
        check(same(k[7], q[7]), f"rubber_band: conflict, pop {pop}")
        log(f"    pop {pop}: ntj0 {k[5].tolist()} ntj1 {k[6].tolist()} "
            f"conflict {k[7].tolist()}")
        cmp.close("rubber_band", "age", k[0], q[0], tol["age"])
        cmp.close("rubber_band", "mig_age", k[1], q[1], tol["age"])
        cmp.close("rubber_band", "cond", k[2] / cond_scale,
                  q[2] / cond_scale, tol["cond"])
        cmp.close("rubber_band", "lnld", k[3], q[3], tol["lnld"])
        cmp.close("rubber_band", "lnp", k[4], q[4], tol["lnld"])
        outs += list(k)
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


def padded_state(s, P, dtype):
    """cast_state of s with its patterns padded to P as io/sequences pads
    them (missing bases; each padding pattern a group of its own with no
    sites), so that a kernel runs at P patterns on real trees."""
    import types

    import torch

    sq = s.seq
    L, n = sq.group_id.shape[0], P - sq.group_id.shape[1]

    def pad(x, v):
        return torch.cat([x, torch.full(x.shape[:-1] + (n,), v,
                                        dtype=x.dtype, device=x.device)], -1)

    ids = torch.arange(P - n, P, device=sq.group_id.device).expand(L, n)
    seq = sq._replace(
        leaf_base=pad(sq.leaf_base, 4),
        group_id=torch.cat([sq.group_id, ids], -1),
        group_count=pad(sq.group_count, 0), group_nphases=pad(
            sq.group_nphases, 1), pattern_valid=pad(sq.pattern_valid, False),
        group_members=None)
    return cast_state(types.SimpleNamespace(
        gen=s.gen, params=s.params, seq=seq, ft=s.ft, lrng=s.lrng,
        grng=s.grng, tree=s.tree), dtype)


def one_kernel(kernel, t):
    """The outputs of one sweep kernel's wrapper on the state t (the
    rubber band: its tau mode for the root population)."""
    from gphocs_tpu_torch.ops import sweeps

    g, pr, sq, c = t.gen, t.params, t.seq, t.ctx
    if kernel == "node_age":
        k = sweeps.node_age_sweep(g, pr, sq, t.lrng, c, t.ft.coal_time,
                                  t.lnld, t.lnp, t.cond)
        return [k[0].age, k[1].ctr, *k[2:]]
    if kernel == "mig_age":
        k = sweeps.mig_age_sweep(g, pr, t.lrng, c, t.ft.mig_time, t.lnp)
        return [k[0].mig_age, k[1].ctr, *k[2:]]
    if kernel == "spr":
        k = sweeps.spr_sweep(g, pr, sq, t.lrng, c, t.lnld, t.cond)
        return [*k[0], k[1].ctr, *k[2:]]
    pop = t.tree.num_pops - 1
    return list(sweeps.rubber_band_eval(g, pr, sq, c, pop, False,
                                        *tau_bounds(t, pop), t.cond))


def smem_window_phase(tmp, dev):
    """Phase 3d: every kernel at each P whose planned dynamic shared
    memory lies within the static reserve below 48 KiB, where a launch
    needs the opt-in only once its static tables are counted."""
    import torch
    from gphocs_tpu_torch.config.samples import S32_CTL, SAMPLE_CTL
    from gphocs_tpu_torch.ops import cuda_lib, sweeps

    s32 = os.path.join(tmp, "window32.txt")
    s32_ctl = S32_CTL.format(seq=s32, trace=os.path.join(tmp, "w32.log"))
    for dt in (torch.float32, torch.float64):
        log("  static shared memory, " + str(dt) + ": " + ", ".join(
            f"{k} {sweeps.plan_for(k, dt, 15, 10, 7, 1, 6).static_bytes} B"
            for k in cuda_lib.KERNELS))
    launches = 0
    for label, path, ctl in (("S = 8", os.path.join(tmp, "window8.txt"),
                              SAMPLE_CTL), ("S = 32", s32, s32_ctl)):
        s = warm_state(dev, torch.float64, path, ctl=ctl)
        N, M = s.gen.num_nodes, s.gen.max_migs
        PP, B, P0 = s.ctx.num_pops, s.ctx.num_bands, s.seq.group_id.shape[1]
        log(f" -- {label}: N = {N}, M = {M}, P = {P0} before padding")
        for kernel in cuda_lib.KERNELS:
            for dt in (torch.float32, torch.float64):
                P = P0
                while True:
                    try:
                        plan = sweeps.plan_for(kernel, dt, N, M, PP, B, P)
                    except ValueError:
                        break
                    if 47 * 1024 < plan.smem_bytes <= 48 * 1024:
                        t = padded_state(s, P, dt)
                        a = one_kernel(kernel, t)
                        sweeps.FORCE_COND_IN_DEVICE_MEMORY = True
                        try:
                            b = one_kernel(kernel, t)
                        finally:
                            sweeps.FORCE_COND_IN_DEVICE_MEMORY = False
                        torch.cuda.synchronize()
                        bitwise = all(torch.equal(x, y)
                                      for x, y in zip(a, b))
                        log(f"  {kernel} {dt} P = {P}: "
                            f"{plan.loci_per_block} loci/block, "
                            f"{plan.smem_bytes} + {plan.static_bytes} B, "
                            f"{'shared' if plan.cond_smem else 'device'}; "
                            f"ran; equal to the device-memory variant: "
                            f"{bitwise}")
                        check(bitwise or dt == torch.float32,
                              f"{kernel} P = {P}: the variants differ")
                        launches += 1
                    if kernel == "mig_age":
                        break  # its layout holds no patterns
                    P += 1
        del s
    check(launches > 0, "no plan in the window")
    log(f"  {launches} planned launches in the window ran")


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


def admix_checks(s, cmp, tol, need_moves=True):
    """Every kernel against its plain version on an admixed state (SPR's
    admixed mode, and the rubber band's prior with the admixture terms in
    both modes where the tree estimates a sample age), with the criteria
    of kernel_checks, integer arrays (node_pop included) equal.  The SPR
    comparison must not be vacuous: on some valid locus an admixed leaf
    must move to its other population, and on some it must stay.  Returns
    the kernels' outputs."""
    from gphocs_tpu_torch.ops import sweeps

    check(s.ctx.num_admixed > 0, "the state has no admixed leaves")
    outs = kernel_checks(s, cmp, tol, need_moves)
    if bool(s.tree.update_sample_age[SAMPLE_AGE_POP]):
        outs += sample_age_checks(s, cmp, tol)
    k = sweeps.spr_sweep(s.gen, s.params, s.seq, s.lrng, s.ctx, s.lnld,
                         s.cond)
    slots, valid = s.ctx.admix_slot, s.gen.valid[:, None]
    moved = (k[0].node_pop[:, slots] != s.gen.node_pop[:, slots]) & valid
    flipped = int(moved.sum())
    stayed = int((~moved & valid).sum())
    log(f"  spr admixed mode: {flipped} admixed leaves moved to their other "
        f"population, {stayed} stayed")
    check(flipped > 0 and stayed > 0,
          "spr admixed mode: no leaf moved, or every leaf moved")
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
    once where a sample age is estimated, and the counter streams' draws
    through their kernel (check_draws).  Returns the counts."""
    from gphocs_tpu_torch.ops import sweeps

    launches = dict(sweeps.LAUNCHES)
    n = iters * buckets
    want = {"node_age": n, "mig_age": n, "spr": n,
            "rubber_band": TAU_PROPOSALS * n,
            "rubber_band_sample_age": n if sample_age else 0,
            **dict.fromkeys(PLAIN_SWEEPS, 0)}
    log(f"launches {launches} (expected {want})")
    check(sweep_launches(launches) == want,
          "launch counts do not match the schedule")
    check_draws(launches, iters, "the schedule")
    return launches


def sweep_launches(launches):
    """The sweeps' entries of a LAUNCHES dict (without rng_draw)."""
    return {k: v for k, v in launches.items() if k != "rng_draw"}


def check_draws(launches, iters, what):
    """The fast path on the card draws through csrc/counter_draw.cu (the
    exact count per iteration is phase 14's)."""
    d = launches["rng_draw"]
    log(f"  {what}: {d} counter draw launches in {iters} iterations "
        f"({d / iters:.2f} an iteration)")
    check(d > 0, f"{what}: the counter streams never drew on the card")


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
    from gphocs_tpu_torch.ops import cuda_lib, sweeps
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
        plans = {kn: sweeps.plan_for(kn, torch.float64, N, M,
                                     s.ctx.num_pops, s.ctx.num_bands, P)
                 for kn in cuda_lib.KERNELS}
        in_device += sum(not p.cond_smem for kn, p in plans.items()
                         if kn != "mig_age")
        log(f"  bucket {k}: {s.bucket_sizes[k]} loci, P = {P}; plan "
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


def admix_phase(tmp, data, card, cmp, times, bounds):
    """Phase 8: the admixed path (ADMIX_CTL: sample `one` also in B, two
    admixed leaves) on the standard workload's data at f32.  Adds SPR's
    admixed mode to `times` and `bounds` (entry "spr_admix") and the
    rubber band's readings on the admixed state to its entry.  Returns
    (it/s, launches of the path, device operations per iteration)."""
    import numpy as np
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import (ADMIX_AGE_CTL, ADMIX_CTL,
                                                 with_settings)
    from gphocs_tpu_torch.kernels.common import gen_log_prior
    from gphocs_tpu_torch.kernels.spr import update_spr
    from gphocs_tpu_torch.kernels.tau import rubber_band_eval_plain
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    dev = torch.device("cuda")
    acmp = Compare()  # SPR's errors here are its admixed mode's
    s, its, launches, st = drive_path("admixture", ADMIX_CTL, data, tmp,
                                      card, sample_age=False)
    A = s.ctx.num_admixed
    check(A == 2, f"{A} admixed leaves")
    log(f"  admixture: {int(st.acc_admix)} of {A * TIMED} coefficient moves "
        f"accepted in the timed chunk, coefficients "
        f"{s.params.admix_coeff.tolist()}")
    check(not s.check_state(), "the admixed state fails its check")
    lnp = gen_log_prior(s.gen, s.params, s.ctx)
    rel = float(((lnp - s.lnp).abs() / lnp.abs().clamp(min=1.0)).max())
    log(f"  carried lnp vs gen_log_prior (admixture terms included): max "
        f"rel err {rel:.2e}")
    check(rel <= 1e-3, "carried lnp disagrees with gen_log_prior")
    vals = open(os.path.join(tmp, "admixture-trace.out")).read().split()
    shares = np.array(vals[1:], float)
    check(int(vals[0]) == RUN_ITERS - 1 and shares.size == A * s.num_loci
          and bool(((shares >= 0) & (shares <= 1)).all()),
          f"admixture-trace.out: {len(vals)} values")
    rows = np.loadtxt(os.path.join(tmp, "trace_admixture.log"), skiprows=1)
    head = open(os.path.join(tmp, "trace_admixture.log")).readline().split()
    acols = [i for i, c in enumerate(head) if c.startswith("A")]
    check(len(acols) == A and bool(((rows[:, acols] > 0)
                                    & (rows[:, acols] < 1)).all()),
          "the A... columns leave (0, 1)")
    log(f"  admixture-trace.out: iteration {vals[0]}, {shares.size} shares "
        f"in [0, 1] (mean {shares.mean():.3f}); trace columns "
        f"{[head[i] for i in acols]} inside (0, 1)")
    ops = device_ops(lambda: s.step_chunk(1, do_migrate=True), reps=3)
    log(f"  device operations per iteration: {ops}")

    log(" -- the kernels on the admixed path's state: f32, then an f64 copy")
    admix_checks(s, acmp, F32_TOL, need_moves=False)
    admix_checks(cast_state(s, torch.float64), acmp, F64_TOL,
                 need_moves=False)
    g, pr, sq, c = s.gen, s.params, s.seq, s.ctx
    spr_args = (g, pr, sq, s.lrng, c, s.lnld, s.cond)
    plain = update_spr(*spr_args, sync_group=1)
    k1 = time_cuda(lambda: sweeps.spr_sweep(*spr_args), 10)
    p1 = time_cuda(lambda: update_spr(*spr_args, sync_group=1), 2)
    prep = sweeps.prepare_spr(*spr_args)
    d1 = time_cuda(lambda: prep.launch(dev), 20)
    times["spr_admix"] = {"ms": k1, "plain_ms": p1, "device_ms": d1,
                          "loci_per_block": prep.plan.loci_per_block,
                          "smem_bytes_per_block": prep.plan.smem_bytes,
                          "static_smem_bytes": prep.plan.static_bytes}
    spr_draws = int(plain[1].ctr) - int(s.lrng.ctr)
    v = op_models(s, spr_draws)["spr"]
    bounds["spr_admix"] = bound(*v) + v
    pop = s.tree.num_pops - 1
    b = tau_bounds(s, pop)
    rb = (g, pr, sq, c, pop, False, *b, s.cond)
    prep = sweeps.prepare_rubber_band(*rb)
    times["rubber_band"].update(
        admix_ms=time_cuda(lambda: sweeps.rubber_band_eval(*rb), 10),
        admix_device_ms=time_cuda(lambda: prep.launch(dev), 20),
        admix_plain_ms=time_cuda(lambda: rubber_band_eval_plain(*rb), 2))
    log(f"  spr admixed mode: wrapper call {k1:.3f} ms, launch alone "
        f"{d1:.4f} ms, plain {p1:.3f} ms; rubber band on this state: "
        f"{times['rubber_band']['admix_ms']:.3f} ms, launch alone "
        f"{times['rubber_band']['admix_device_ms']:.4f} ms")
    del s, g, pr, sq, c, spr_args, plain, prep, rb

    log(" -- both rubber-band modes under admixture (64 loci of "
        "ADMIX_AGE_CTL: f64, then f32)")
    sa = warm_state(dev, torch.float64, os.path.join(tmp, "admix_age.txt"),
                    ctl=ADMIX_AGE_CTL)
    admix_checks(sa, acmp, F64_TOL)
    admix_checks(cast_state(sa, torch.float32), acmp, F32_TOL,
                 need_moves=False)
    del sa
    for k, v in acmp.err.items():
        name = "spr_admix" if k == "spr" else k
        cmp.err[name] = max(cmp.err.get(name, 0.0), v)

    def sampler(seed, chains, dtype, iters=CHAIN_CHECK, loci=64):
        cfg = parse_control_text(ADMIX_CTL)
        cfg.mcmc.random_seed = seed
        cfg.mcmc.start_mig = 0
        cfg.mcmc.burn_in = 0
        cfg.mcmc.mcmc_iterations = iters
        cfg.mcmc.num_loci = loci
        return Sampler(cfg, seq_path=data, dtype=dtype, device="cuda",
                       chains=chains)

    log(f" -- chain c of 2 admixed chains (f64, 64 loci, {CHAIN_CHECK} "
        "iterations) against the one-chain run with seed base + 7919 c")
    base = 29
    sc = sampler(base, 2, torch.float64)
    sc.initialize()
    stc, trc = sc.step_chunk(CHAIN_CHECK, do_migrate=True)
    L = sc.num_loci
    for ci in range(2):
        s1 = sampler(base + 7919 * ci, 1, torch.float64)
        s1.initialize()
        st1, tr1 = s1.step_chunk(CHAIN_CHECK, do_migrate=True)
        gc, pc = sc.chain_state(ci)
        cut = slice(ci * L, (ci + 1) * L)
        for f in gc._fields:
            check(same(getattr(gc, f), getattr(s1.gen, f)),
                  f"admixed chain {ci}: {f} differs from its one-chain run")
        for f in ("theta", "tau", "mig_rate", "admix_coeff"):
            check(same(getattr(pc, f), getattr(s1.params, f)),
                  f"admixed chain {ci}: {f} differs")
        check(same(sc.lnld[cut], s1.lnld) and same(sc.lnp[cut], s1.lnp)
              and same(sc.lrng.ctr[ci], s1.lrng.ctr)
              and same(sc.grng.ctr[ci], s1.grng.ctr),
              f"admixed chain {ci}: lnld, lnp or counters differ")
        for f in st1._fields:
            check(same(getattr(stc, f)[ci], getattr(st1, f)),
                  f"admixed chain {ci}: {f} differs")
        log(f"  chain {ci}: bitwise equal to its one-chain run; coefficient "
            f"moves accepted {int(st1.acc_admix)}, SPR {int(st1.acc_spr)}")
    del sc, s1

    log(f" -- python -m gphocs_tpu_torch on the card: a checkpoint at "
        f"{CHAIN_CKPT} resumed to {2 * CHAIN_CKPT}, and --chains 2 "
        f"({CHAIN_CKPT_LOCI} loci, f32)")

    def ctl(name, iterations):
        path = os.path.join(tmp, f"admix_{name}.ctl")
        with open(path, "w") as f:
            f.write(with_settings(
                ADMIX_CTL, seq_file=data, num_loci=CHAIN_CKPT_LOCI,
                trace_file=os.path.join(tmp, f"admix_{name}", "trace.log"),
                mcmc_iterations=iterations, iterations_per_log=CHAIN_CKPT,
                random_seed=5, burn_in=0, start_mig=0))
        os.makedirs(os.path.join(tmp, f"admix_{name}"), exist_ok=True)
        return path

    def start(name, iterations, *flags):
        out = open(os.path.join(tmp, f"admix_{name}.out"), "w")
        return subprocess.Popen(
            [sys.executable, "-m", "gphocs_tpu_torch", ctl(name, iterations),
             "--checkpoint", os.path.join(tmp, f"admix_{name}.npz"),
             "--checkpoint-every", str(CHAIN_CKPT), *flags],
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
        log(f"  {name}: exit {rc}; " + " | ".join(text.splitlines()[:3]))
        check(rc == 0, f"admixed CLI run {name} failed:\n{text[-3000:]}")
        return text

    runs = {"whole": start("whole", 2 * CHAIN_CKPT, "--debug-check"),
            "first": start("first", CHAIN_CKPT),
            "chains": start("chains", CHAIN_CKPT, "--chains", "2",
                            "--debug-check")}
    texts = {name: finish(name, pr) for name, pr in runs.items()}
    check("AdmxCoefs" in texts["whole"], "no AdmxCoefs column in the log")
    shutil.copy(os.path.join(tmp, "admix_first.npz"),
                os.path.join(tmp, "admix_resumed.npz"))
    finish("resumed", start("resumed", 2 * CHAIN_CKPT, "--resume"))

    def lines(name):
        return open(os.path.join(tmp, f"admix_{name}", "trace.log")
                    ).read().splitlines()

    a, b = lines("whole"), lines("resumed")
    check(a[CHAIN_CKPT + 1:] == b[1:] and len(b) == CHAIN_CKPT + 1,
          "the resumed admixed run's trace rows differ")
    za = np.load(os.path.join(tmp, "admix_whole.npz"))
    zb = np.load(os.path.join(tmp, "admix_resumed.npz"))
    check(sorted(za.files) == sorted(zb.files)
          and all(np.array_equal(za[k], zb[k]) for k in za.files),
          "the resumed admixed run's final checkpoint differs")
    check(za["params_admix_coeff"].shape == (A,), "no coefficients saved")
    adm = open(os.path.join(tmp, "admix_whole", "admixture-trace.out")
               ).read().split()
    check(len(adm) == 1 + A * CHAIN_CKPT_LOCI, "admixture-trace.out size")
    check(len(lines("chains")) == CHAIN_CKPT + 1
          and "A0[B]" in lines("chains")[0], "the 2-chain trace")
    log(f"  rows {CHAIN_CKPT + 1}-{2 * CHAIN_CKPT} and the {len(za.files)} "
        "checkpoint arrays of the resumed run bitwise equal; "
        f"admixture-trace.out {len(adm)} values; --chains 2 ran")
    torch.cuda.synchronize()
    return its, launches, ops


# -- phase 9: the loci mesh ------------------------------------------------

MESH_F64_ITERS = 5
MESH_F32_ITERS = 20
MESH_PAD_LOCI = 999     # 9b: odd, so that 2 ranks pad one locus
MESH_CLI_ITERS = 10
MESH_TIMEOUT_S = 120    # of every process group and rank process


def mesh_sampler(data, dtype, mesh=None, num_loci=-1, loci_multiple=1,
                 chains=1):
    """The standard workload's sampler (seed 111; chain c of C: 111 +
    7919 c) on the card, initialized with the band hot (2e5) so that
    migrations appear within a chunk."""
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.kernels.common import gen_log_prior
    from gphocs_tpu_torch.sampler.driver import Sampler

    cfg = parse_control_text(SAMPLE_CTL)
    cfg.mcmc.random_seed = 111
    cfg.mcmc.start_mig = 0
    cfg.mcmc.num_loci = num_loci
    s = Sampler(cfg, seq_path=data, dtype=dtype, device="cuda", mesh=mesh,
                loci_multiple=loci_multiple, chains=chains)
    s.initialize()
    s._sample_mig_rates_device()
    s.params = s.params._replace(
        mig_rate=torch.full_like(s.params.mig_rate, 2e5))
    s.lnps = tuple(gen_log_prior(g, s.params, s.ctx) for g in s.gens)
    return s


def mesh_state(s):
    """The sampler's per-locus state, every rank's loci in the global
    chain-major order (gathered on a mesh), its counters, parameters and
    general streams, on the CPU."""
    from gphocs_tpu_torch.parallel.mesh import gather_rows

    from gphocs_tpu_torch.rng import WhRngState

    def rows(t):
        return (t if s.mesh is None
                else gather_rows(s.mesh, t, s.chains)).cpu()

    g = s.gen
    out = {"gen": {f: rows(getattr(g, f)) for f in g._fields},
           "lnld": rows(s.lnld), "lnp": rows(s.lnp), "cond": rows(s.cond),
           "params": {f: getattr(s.params, f).cpu()
                      for f in s.params._fields}}
    if isinstance(s.lrng, WhRngState):  # the legacy RNG's streams
        out.update({f"lrng_{f}": rows(getattr(s.lrng, f)) for f in "xyz"})
        out.update({f"grng_{f}": getattr(s.grng, f).cpu() for f in "xyz"})
    else:
        out.update(key=rows(s.lrng.key), ctr=s.lrng.ctr.cpu(),
                   grng_ctr=s.grng.ctr.cpu())
    return out


def mesh_chunk(s, iters):
    """One step_chunk(iters) with the launch and all-reduce counts set to
    0 just before and read just after: (stats, trace, state, launches,
    all-reduces, seconds)."""
    import torch
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.parallel import mesh as M

    torch.cuda.synchronize()
    if s.mesh is not None:
        s.mesh.barrier()
    sweeps.reset_launch_counts()
    M.reset_collective_counts()
    t0 = time.perf_counter()
    st, tr = s.step_chunk(iters, do_migrate=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, coll = dict(sweeps.LAUNCHES), dict(M.COLLECTIVES)
    return {"stats": {f: getattr(st, f).cpu() for f in st._fields},
            "trace": {f: getattr(tr, f).cpu() for f in tr._fields},
            "state": mesh_state(s), "launches": launches,
            "collectives": coll, "seconds": seconds, "iters": iters}


def compare_runs(what, ref, got, exact):
    """Equal accept counts, counters and integer arrays; reals (trace
    rows, state) equal bitwise where `exact`, else within 1e-9 relative.
    Returns the largest relative difference of the reals (and logs the
    field that has it)."""
    import torch

    worst, worst_at = 0.0, None

    def one(name, a, b):
        nonlocal worst, worst_at
        check(a.shape == b.shape, f"{what}: {name} shape {tuple(a.shape)} "
              f"against {tuple(b.shape)}")
        if exact or not a.is_floating_point():
            check(bool(torch.equal(a, b)), f"{what}: {name} differs")
            return
        d = (a.double() - b.double()).abs()
        bad = d > 1e-9 * a.double().abs()
        if a.numel():
            rel = float((d / a.double().abs().clamp(min=1e-300)).max())
            if rel > worst:
                worst, worst_at = rel, name
        check(not bool(bad.any()), f"{what}: {name} beyond 1e-9 relative")

    for part in ("stats", "trace"):
        for f in ref[part]:
            one(f"{part}.{f}", ref[part][f], got[part][f])
    rs, gs = ref["state"], got["state"]
    check(sorted(rs) == sorted(gs), f"{what}: state keys {sorted(gs)}")
    for f in rs["gen"]:
        one(f"gen.{f}", rs["gen"][f], gs["gen"][f])
    for f in rs:  # lnld, lnp, cond and the streams
        if f not in ("gen", "params"):
            one(f, rs[f], gs[f])
    for f in rs["params"]:
        one(f"params.{f}", rs["params"][f], gs["params"][f])
    if worst_at:
        log(f"    {what}: largest relative difference {worst:.2e}, in "
            f"{worst_at}")
    return worst


def mesh_rank(spec_path, rank):
    """One of the two ranks of phase 9b or 12b (SPEC["chains"]: 1 or
    MESH_CHAINS_F64), sharing the card over gloo: the f64 chunk of the
    standard workload, the same at MESH_PAD_LOCI loci, and (9b) the timed
    f32 chunk; rank 0 writes what they gathered.  A SPEC with rng_mode
    "legacy" is one of phase 13b's ranks (legacy_mesh_rank)."""
    import torch
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld
    from gphocs_tpu_torch.parallel import mesh as M

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("rng_mode") == "legacy":  # a rank of phase 13b
        return legacy_mesh_rank(spec, rank)
    chains = spec.get("chains", 1)
    M.init_distributed(f"127.0.0.1:{spec['port']}", 2, rank, device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = M.make_mesh()
        check(mesh.backend == "gloo", f"backend {mesh.backend}")
        out = {}
        runs = [("f64", torch.float64, -1, MESH_F64_ITERS),
                ("f64_pad", torch.float64, MESH_PAD_LOCI, MESH_F64_ITERS)]
        if chains == 1:
            runs.append(("f32", torch.float32, -1, MESH_F32_ITERS))
        for label, dtype, loci, iters in runs:
            s = mesh_sampler(spec["data"], dtype, mesh, loci, chains=chains)
            if label == "f32":
                s.step_chunk(WARMUP, do_migrate=True)
            res = mesh_chunk(s, iters)
            res["loci"] = [s.gen.num_loci, s.num_loci, s.pad_loci]
            res["launches_by_rank"] = [
                dict(zip(res["launches"], v.long().tolist()))
                for v in M.gather_rows(mesh, torch.tensor(
                    [list(res["launches"].values())], dtype=torch.float64),
                    1)]
            if label == "f32":
                _, ld = full_rebuild_and_lnld(s.gen, s.seq)
                err = M.all_reduce(mesh, [(ld - s.lnld).abs().max()],
                                   "max")[0]
                res["lnld_rebuild_err"] = float(err)
            out[label] = res
        if rank == 0:
            torch.save(out, spec["out"])
    finally:
        M.shutdown()
    return 0


def two_ranks(tmp, data, chains):
    """Phase 9b's or 12b's two ranks (`chip_smoke.py --mesh-rank`),
    sharing the card over gloo, against one process padded alike at f64
    (MESH_F64_ITERS iterations, 1000 and MESH_PAD_LOCI loci): equal
    accept counts, counters and integer arrays, reals within 1e-9
    relative, each rank launching the schedule's kernels, each chain's
    padding locus inert.  Returns rank 0's results and the largest
    relative differences of the reals."""
    import torch
    from gphocs_tpu_torch.parallel import mesh as M

    what = "9b" if chains == 1 else "12b"
    spec = {"port": M.free_port(), "data": data, "chains": chains,
            "out": os.path.join(tmp, f"ranks_{what}.pt")}
    spec_path = os.path.join(tmp, f"spec_{what}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    # the one-process references (the padded one as 2 ranks pad)
    refs = {label: mesh_chunk(mesh_sampler(
        data, torch.float64, num_loci=loci, loci_multiple=2, chains=chains),
        MESH_F64_ITERS) for label, loci in (("f64", -1),
                                            ("f64_pad", MESH_PAD_LOCI))}
    outs = [open(os.path.join(tmp, f"rank_{what}_{r}.out"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank",
         spec_path, str(r)], cwd=ROOT, stdout=outs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        rcs = [p.wait(timeout=MESH_TIMEOUT_S + 180) for p in procs]
    finally:
        for p, o in zip(procs, outs):
            if p.poll() is None:
                p.kill()
                p.wait()
            o.close()
    for r, rc in enumerate(rcs):
        text = open(os.path.join(tmp, f"rank_{what}_{r}.out")).read()
        check(rc == 0, f"{what} rank {r} failed:\n{text[-3000:]}")
    got = torch.load(spec["out"], weights_only=False)
    worst = {}
    for label in ("f64", "f64_pad"):
        worst[label] = compare_runs(f"{what} {label}", refs[label],
                                    got[label], exact=False)
        loci, padded, pad = got[label]["loci"]
        log(f"  {label}: each rank {loci} rows ({chains} chain(s)) of "
            f"{chains} x {padded} loci ({pad} padding per chain), launches "
            f"per rank {got[label]['launches_by_rank']}; counts, counters "
            f"and integers equal, reals within {worst[label]:.2e} relative")
        for by_rank in got[label]["launches_by_rank"]:
            want = {"node_age": MESH_F64_ITERS, "mig_age": MESH_F64_ITERS,
                    "spr": MESH_F64_ITERS,
                    "rubber_band": TAU_PROPOSALS * MESH_F64_ITERS,
                    "rubber_band_sample_age": 0,
                    **dict.fromkeys(PLAIN_SWEEPS, 0)}
            check(sweep_launches(by_rank) == want,
                  f"{what} {label}: launches {by_rank}")
            check_draws(by_rank, MESH_F64_ITERS, f"{what} {label}")
    Lp = MESH_PAD_LOCI + 1
    check(got["f64_pad"]["loci"] == [chains * Lp // 2, Lp, 1],
          f"{what}: rows {got['f64_pad']['loci']}")
    st = got["f64_pad"]["state"]
    last = [c * Lp + Lp - 1 for c in range(chains)]
    check(not bool(st["gen"]["valid"][last].any())
          and bool((st["lnld"][last] == 0).all())
          and int(st["gen"]["valid"].sum()) == chains * MESH_PAD_LOCI,
          f"{what}: a chain's padding locus is not inert")
    log("  each chain's padding locus inert (valid False, lnld 0)")
    return got, worst


def cli_start(tmp, name, ctl, *flags):
    """`python -m gphocs_tpu_torch CTL --x64 FLAGS` on the card, in a
    directory of its own (tmp/cli_NAME, its output in tmp/cli_NAME.out):
    (name, process, output file)."""
    where = os.path.join(tmp, f"cli_{name}")
    os.makedirs(where)
    out = open(where + ".out", "w")
    return name, subprocess.Popen(
        [sys.executable, "-m", "gphocs_tpu_torch", ctl, "--x64",
         "--mesh-timeout", str(MESH_TIMEOUT_S), *flags], cwd=where,
        stdout=out, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=ROOT)), out


def cli_ranks(tmp, name, ctl, *flags):
    """cli_start's two `--distributed` ranks, NAME0 and NAME1."""
    from gphocs_tpu_torch.parallel import mesh as M

    coord = f"127.0.0.1:{M.free_port()}"
    return [cli_start(tmp, f"{name}{r}", ctl, "--distributed",
                      f"{coord}:2:{r}", *flags) for r in range(2)]


def cli_finish(tmp, procs, what):
    """Wait for cli_start's processes; each must exit 0."""
    try:
        rcs = {n: p.wait(timeout=MESH_TIMEOUT_S + 180) for n, p, _ in procs}
    finally:
        for _, p, o in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            o.close()
    for name, rc in rcs.items():
        text = open(os.path.join(tmp, f"cli_{name}.out")).read()
        log(f"  {name}: exit {rc}; " + " | ".join(text.splitlines()[:3]))
        check(rc == 0, f"{what} {name} failed:\n{text[-3000:]}")


def cli_trace_rel(tmp, what, one, rank0, iters=MESH_CLI_ITERS):
    """The largest relative difference, per value, between two commands'
    traces of `iters` rows, which must be within 1e-9."""
    import numpy as np

    a, b = (np.loadtxt(os.path.join(tmp, f"cli_{n}", "trace.log"),
                       skiprows=1) for n in (one, rank0))
    check(a.shape == b.shape == (iters, a.shape[1]),
          f"{what} trace shapes {a.shape} {b.shape}")
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-300)
    check(bool((rel <= 1e-9).all()), f"{what}: rank 0's trace differs by "
          f"{rel.max():.3e} relative")
    return float(rel.max())


def cli_ctl(tmp, name, data, iterations):
    """The standard workload's control file for phases 9c and 12c."""
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL, with_settings

    path = os.path.join(tmp, f"{name}.ctl")
    with open(path, "w") as f:
        f.write(with_settings(
            SAMPLE_CTL, seq_file=data, trace_file="trace.log",
            mcmc_iterations=iterations, iterations_per_log=5, random_seed=5,
            burn_in=0, start_mig=0))
    return path


def mesh_phase(tmp, data, card):
    """Phase 9: the loci mesh.  Returns (launches of 9a's mesh chunk, a
    record of the phase's readings)."""
    import torch
    from gphocs_tpu_torch.parallel import mesh as M

    rec = {}
    log(f" -- 9a: NCCL, a world of one, {WORKLOAD_LOCI} loci at f32: "
        f"{MESH_F32_ITERS} iterations against the run without a mesh")
    M.init_distributed(f"127.0.0.1:{M.free_port()}", 1, 0, device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = M.make_mesh()
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        plain = mesh_sampler(data, torch.float32)
        meshed = mesh_sampler(data, torch.float32, mesh)
        for f in ("gens", "lrngs", "lnlds", "lnps", "conds", "params",
                  "grng"):
            setattr(meshed, f, getattr(plain, f))
        a = mesh_chunk(plain, MESH_F32_ITERS)
        b = mesh_chunk(meshed, MESH_F32_ITERS)
    finally:
        M.shutdown()
    compare_runs("9a", a, b, exact=True)
    check(a["launches"] == b["launches"], f"9a launches {a['launches']} "
          f"against {b['launches']}")
    launches = check_schedule(MESH_F32_ITERS, 1, False)
    nccl = b["collectives"]
    rec["nccl1"] = {
        "it_per_s": MESH_F32_ITERS / b["seconds"],
        "plain_it_per_s": MESH_F32_ITERS / a["seconds"],
        "all_reduces_per_iteration": nccl["all_reduce"] / MESH_F32_ITERS,
        "all_reduce_host_ms_per_iteration":
            1e3 * nccl["seconds"] / MESH_F32_ITERS}
    log(f"  bitwise equal to the run without a mesh (stats, trace, state, "
        f"counters); launches {b['launches']}; {rec['nccl1']}")
    del plain, meshed, a, b

    log(f" -- 9b: two ranks share the card over gloo: f64 "
        f"({WORKLOAD_LOCI} and {MESH_PAD_LOCI} loci, {MESH_F64_ITERS} "
        f"iterations), f32 ({MESH_F32_ITERS} iterations, timed)")
    # the one-process f32 it/s before and after the ranks' run
    one = mesh_sampler(data, torch.float32)
    one.step_chunk(WARMUP, do_migrate=True)
    t1 = mesh_chunk(one, MESH_F32_ITERS)["seconds"]
    got, _ = two_ranks(tmp, data, 1)
    t2 = mesh_chunk(one, MESH_F32_ITERS)["seconds"]
    f32 = got["f32"]
    rows_ok = all(bool(torch.isfinite(v).all()) for v in f32["trace"].values())
    check(rows_ok, "9b f32: trace rows not finite")
    check(f32["lnld_rebuild_err"] <= F32_TOL["lnld"],
          f"9b f32: carried lnld {f32['lnld_rebuild_err']} from a rebuild")
    gl = f32["collectives"]
    rec["gloo2"] = {
        "it_per_s": MESH_F32_ITERS / f32["seconds"],
        "one_process_it_per_s": [MESH_F32_ITERS / t1, MESH_F32_ITERS / t2],
        "all_reduces_per_iteration": gl["all_reduce"] / MESH_F32_ITERS,
        "all_reduce_host_ms_per_iteration":
            1e3 * gl["seconds"] / MESH_F32_ITERS,
        "lnld_rebuild_err": f32["lnld_rebuild_err"],
        "launches_by_rank": f32["launches_by_rank"]}
    log(f"  f32: rows finite, carried lnld within "
        f"{f32['lnld_rebuild_err']:.2e} of a rebuild; {rec['gloo2']}")
    del one, got

    log(f" -- 9c: python -m gphocs_tpu_torch --distributed, 2 processes "
        f"sharing the card, --x64, {MESH_CLI_ITERS} iterations, against the "
        "one-process command")
    ctl = cli_ctl(tmp, "mesh_cli", data, MESH_CLI_ITERS)
    cli_finish(tmp, [cli_start(tmp, "one", ctl),
                     *cli_ranks(tmp, "rank", ctl)], "9c")
    check(os.listdir(os.path.join(tmp, "cli_rank1")) == [],
          "9c: rank 1 wrote a file")
    rec["cli_max_rel"] = cli_trace_rel(tmp, "9c", "one", "rank0")
    log(f"  rank 0's trace within {rec['cli_max_rel']:.2e} relative of the "
        "one-process trace, per column; rank 1 wrote no file")
    torch.cuda.synchronize()
    return launches, rec


LEGACY_LOCI = 64     # (b)-(d) of phase 10
LEGACY_ITERS = 5     # (b): iterations held against the CPU, per workload
LEGACY_CKPT = 2      # (c): checkpoint at 2, resumed to 4
LEGACY_CHUNK = 2     # (e): iterations per timed chunk, 3 chunks per dtype
# the reference C implementation's Wichmann-Hill values (src/utils.c, gcc
# -O2, seed 12345, 3 loci + 1 general slot), as tests/test_rng.py has them
GOLD_RNDU_SLOT0 = [
    0.0042688455914678958, 0.62853436425211839, 0.95951417036121711,
    0.066568566791829653, 0.33884242226486094, 0.25929171797179151,
    0.30696066853124648, 0.27638592311996035, 0.27231839174055494,
    0.92301977935130708]
GOLD_RND2NORMAL8_SLOT1 = [
    0.66878961090114375, -0.62978615503667335, -0.98304464283311499,
    -0.96972107693339271, 0.557807077441971, -1.0561921282874003,
    -0.95513209233305907, 0.50244312769355037]
GOLD_RNDNORMAL_SLOT2 = [
    -0.82205829204275882, -0.94807421769542499, -0.18954793512492538,
    0.12070680375315508, 1.8794910910790084]
# the conformance mode's sweeps: tensor code, no kernel
PLAIN_SWEEPS = ("node_age_plain", "mig_age_plain", "spr_plain")


def legacy_schedule(iters, sample_age):
    """The launches of `iters` legacy iterations: the sweeps as tensor
    code, the rubber band 3 times an iteration (+1 with a sample age)."""
    from gphocs_tpu_torch.ops import sweeps

    want = dict.fromkeys(sweeps.LAUNCHES, 0)
    want.update(dict.fromkeys(PLAIN_SWEEPS, iters),
                rubber_band=TAU_PROPOSALS * iters,
                rubber_band_sample_age=int(sample_age) * iters)
    return want


def legacy_streams():
    """Phase 10a: the Wichmann-Hill streams on the card: rndu bitwise equal
    to C's values, the normals within 5e-15, masked lanes unmoved, and
    4,096 lanes (one seeded at x = 177, which wraps) bitwise equal to the
    CPU's stream for 20 draws."""
    import torch
    from gphocs_tpu_torch import rng as R

    dev = torch.device("cuda")

    def lane(i):
        m = torch.zeros(4, dtype=torch.bool, device=dev)
        m[i] = True
        return m

    st = R.init_legacy(4, 12345, dev)
    got = []
    for _ in GOLD_RNDU_SLOT0:
        u, st = R.rndu(st, lane(0))
        got.append(float(u[0]))
    check(got == GOLD_RNDU_SLOT0, f"rndu on the card differs from C: {got}")
    worst = 0.0
    for draw, i, gold in (("rnd2normal8", 1, GOLD_RND2NORMAL8_SLOT1),
                          ("rndnormal", 2, GOLD_RNDNORMAL_SLOT2)):
        st = R.init_legacy(4, 12345, dev)
        got = []
        for _ in gold:
            z, st = getattr(R, draw)(st, lane(i))
            got.append(float(z[i]))
        d = max(abs(a - b) for a, b in zip(got, gold))
        worst = max(worst, d)
        check(d <= 5e-15, f"{draw} on the card: {d:.2e} from C's values")
    st = R.init_legacy(4, 12345, dev)
    for _ in range(3):
        _, st = R.rndu(st, lane(1))
        _, st = R.rnd2normal8(st, lane(2))
    u, st = R.rndu(st, lane(0))
    check(float(u[0]) == GOLD_RNDU_SLOT0[0]
          and (int(st.x[3]), int(st.y[3])) == (11, 23),
          "a lane outside the mask advanced")
    gen = torch.Generator().manual_seed(5)
    xyz = torch.randint(1, 30000, (3, 4096), generator=gen)
    xyz[0, 0] = 177
    cpu, card = R.from_arrays(*xyz), R.from_arrays(*xyz, device=dev)
    mask = torch.rand(4096, generator=gen) < 0.8
    for _ in range(20):
        uc, cpu = R.rndu(cpu, mask)
        ug, card = R.rndu(card, mask.to(dev))
        check(torch.equal(uc, ug.cpu()), "the card's uniforms differ from "
              "the CPU's")
    check(all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)),
          "the card's stream states differ from the CPU's")
    log(f"  rndu bitwise equal to C's values; normals within {worst:.1e}; "
        "masked lanes unmoved; 4,096 lanes x 20 draws equal to the CPU's "
        "bitwise (lane 0 wrapped)")


def legacy_sampler(ctl, data, device, dtype, loci=LEGACY_LOCI, chains=1,
                   seed=111, mesh=None, loci_multiple=1, **settings):
    """The conformance mode's sampler of a workload (start-mig 0; `chains`
    chains from seed `seed` + 7919 c; on `mesh`, this rank's block),
    initialized and with its migration rates drawn."""
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import with_settings
    from gphocs_tpu_torch.sampler.driver import Sampler

    cfg = parse_control_text(with_settings(
        ctl, random_seed=seed, start_mig=0, num_loci=loci, **settings))
    s = Sampler(cfg, seq_path=data, dtype=dtype, device=device,
                rng_mode="legacy", chains=chains, mesh=mesh,
                loci_multiple=loci_multiple)
    s.initialize()
    s._sample_mig_rates_device()
    return s


LEGACY_STATE = ("gens", "params", "lrngs", "grng", "lnlds", "lnps", "conds")


def legacy_copy(src, dst):
    """dst takes src's state, on dst's device."""
    import torch

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(dst.device)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to(v) for v in x))
        if isinstance(x, tuple):
            return tuple(to(v) for v in x)
        return x

    for k in LEGACY_STATE:
        setattr(dst, k, to(getattr(src, k)))
    dst.rate_var = src.rate_var


def legacy_vs_cpu(label, ctl, data, sample_age, chains=1,
                  iters=LEGACY_ITERS, tol=1e-9, phase="10b"):
    """Phase 10b (11a with chains), one workload: `iters` iterations of the
    card's sampler at f64, each held against one iteration of the CPU's
    sampler from the same state: equal accept counts (per chain) and
    streams, equal integer arrays of the genealogies, reals within `tol`
    relative, and the schedule of launches (the sweeps as tensor code, the
    rubber band's kernel, once for all chains).  Returns the largest
    relative difference."""
    import torch
    from gphocs_tpu_torch.ops import sweeps

    f64 = torch.float64
    card = legacy_sampler(ctl, data, "cuda", f64, chains=chains)
    cpu = legacy_sampler(ctl, data, "cpu", f64, chains=chains)
    worst = 0.0
    if chains > 1:
        legacy_chain_starts(label, ctl, data, card)

    def rel(name, a, b):
        nonlocal worst
        a, b = a.double().cpu(), b.double().cpu()
        d = (a - b).abs()
        if a.numel():
            worst = max(worst, float((d / a.abs().clamp(min=1e-300)).max()))
        check(not bool((d > tol * a.abs()).any()),
              f"{phase} {label}: {name} beyond {tol:g} relative")

    for it in range(iters):
        legacy_copy(card, cpu)
        sweeps.reset_launch_counts()
        st_g, tr_g = card.step_chunk(1, do_migrate=True)
        torch.cuda.synchronize()
        launches = dict(sweeps.LAUNCHES)
        check(launches == legacy_schedule(1, sample_age),
              f"{phase} {label}: launches {launches}")
        st_c, tr_c = cpu.step_chunk(1, do_migrate=True)
        for f in st_g._fields:
            a, b = getattr(st_c, f), getattr(st_g, f)
            if a.is_floating_point():
                rel(f, a, b)
            else:
                check(torch.equal(a, b.cpu()), f"{phase} {label}: {f} "
                      f"{a.tolist()} on the CPU, {b.tolist()} on the card")
        for f in tr_g._fields:
            rel(f"trace {f}", getattr(tr_c, f), getattr(tr_g, f))
        for f in card.gen._fields:
            a, b = getattr(cpu.gen, f), getattr(card.gen, f)
            if a.is_floating_point():
                rel(f, a, b)
            else:
                check(torch.equal(a, b.cpu()), f"{phase} {label}: {f} differs")
        for name, a, b in (("lnld", cpu.lnld, card.lnld),
                           ("lnp", cpu.lnp, card.lnp)):
            rel(name, a, b)
        for r_c, r_g in ((cpu.lrng, card.lrng), (cpu.grng, card.grng)):
            check(all(torch.equal(a, b.cpu()) for a, b in zip(r_c, r_g)),
                  f"{phase} {label}: the streams differ")
    log(f"  {label}: {iters} iterations, each equal to the CPU's "
        f"(accepts, streams, integers), reals within {worst:.2e} relative; "
        f"accepts of the last: coal {st_g.acc_coal_time.tolist()} spr "
        f"{st_g.acc_spr.tolist()} taus {st_g.acc_taus.tolist()} rates "
        f"{st_g.acc_locus_rate.tolist()} admix {st_g.acc_admix.tolist()}")
    return worst


def device_spans(prof):
    """[(start, end)] in µs of every device operation that torch.profiler
    traced, read from its raw (kineto) events: its Python event list
    took ~2 minutes to build for the ~760,000 device operations of one
    VAR legacy iteration on the card's host (phase 13a)."""
    from torch.autograd import DeviceType

    return [(e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def legacy_profile(s, iters):
    """Device operations, device busy ms (the union of their time
    ranges) and wall ms per iteration of sampler s, and the idle share,
    from torch.profiler over `iters` iterations (None where the profiler
    sees no device operation).  It traces the device's activity alone:
    the host's ~40,000 operations an iteration would cost seconds of the
    profiler's own processing; where that gives no device event, it
    traces both."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gphocs_tpu_torch.tools.profile_main import _union_ms

    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        try:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                s.step_chunk(iters, do_migrate=True)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        except (AssertionError, RuntimeError) as e:
            log(f"  torch.profiler with {[a.name for a in acts]}: {e}")
            continue
        spans = device_spans(prof)
        if spans:
            break
    else:
        log("  torch.profiler saw no device operation: not measured")
        return None
    log(f"  profiled with {[a.name for a in acts]}")
    busy = _union_ms(spans)
    return {"ops_per_iteration": len(spans) / iters,
            "device_ms_per_iteration": busy / iters,
            "wall_ms_per_iteration": wall / iters,
            "idle_share": 1.0 - busy / wall}


def legacy_phase(tmp, data, card):
    """Phase 10: the conformance mode (the legacy RNG) on the card.
    Returns (its launches on the standard workload, its record)."""
    import numpy as np
    import torch
    from gphocs_tpu_torch.config.samples import (ADMIX_CTL, SAMPLE_AGE_CTL,
                                                 SAMPLE_AGE_VAR_CTL,
                                                 SAMPLE_CTL, with_settings)
    from gphocs_tpu_torch.ops import sweeps

    # 10d's command runs beside 10a-10c: the path is host-bound and
    # leaves the card mostly idle
    ctl_path = os.path.join(tmp, "legacy.ctl")
    trace = os.path.join(tmp, "legacy_cli.log")
    with open(ctl_path, "w") as f:
        f.write(with_settings(SAMPLE_CTL, seq_file=data, trace_file=trace,
                              num_loci=LEGACY_LOCI, mcmc_iterations=4,
                              iterations_per_log=2, burn_in=0, start_mig=0,
                              random_seed=5))
    cli_out = open(os.path.join(tmp, "legacy_cli.out"), "w")
    cli = subprocess.Popen([sys.executable, "-m", "gphocs_tpu_torch",
                            ctl_path, "--legacy-rng", "-v"], cwd=ROOT,
                           stdout=cli_out, stderr=subprocess.STDOUT,
                           text=True)
    try:
        t0 = time.perf_counter()
        log(" -- 10a: the Wichmann-Hill streams on the card")
        legacy_streams()

        log(f" -- 10b: {LEGACY_LOCI} loci at f64 on the card against the "
            f"CPU, {LEGACY_ITERS} iterations each "
            f"({time.perf_counter() - t0:.1f} s)")
        worst = max(legacy_vs_cpu(label, ctl, data, sa)
                    for label, ctl, sa in (
                        ("plain", SAMPLE_CTL, False),
                        ("sample_age", SAMPLE_AGE_CTL, True),
                        ("sample_age_var", SAMPLE_AGE_VAR_CTL, True),
                        ("admixed", ADMIX_CTL, False)))

        log(f" -- 10c: a checkpoint at iteration {LEGACY_CKPT} resumed on "
            f"the card (SAMPLE_AGE_VAR_CTL, {LEGACY_LOCI} loci, f64; "
            f"{time.perf_counter() - t0:.1f} s)")
        f64 = torch.float64

        def leg(name, iters, resume=False, ck=None):
            s = legacy_sampler(SAMPLE_AGE_VAR_CTL, data, "cuda", f64,
                               mcmc_iterations=iters, burn_in=0,
                               iterations_per_log=LEGACY_CKPT)
            _, rows = s.run(
                trace_path=os.path.join(tmp, f"leg_{name}.log"),
                checkpoint_path=os.path.join(tmp, f"leg_{ck or name}.npz"),
                checkpoint_every=LEGACY_CKPT, resume=resume)
            return rows

        whole = leg("whole", 2 * LEGACY_CKPT)
        leg("first", LEGACY_CKPT)
        resumed = leg("resumed", 2 * LEGACY_CKPT, resume=True, ck="first")
        check(np.array_equal(whole[LEGACY_CKPT:], resumed),
              "10c: the resumed rows differ from the uninterrupted run's")
        za = np.load(os.path.join(tmp, "leg_whole.npz"))
        zb = np.load(os.path.join(tmp, "leg_first.npz"))
        check(sorted(za.files) == sorted(zb.files) and "lrng_x" in za.files,
              "10c: checkpoint keys")
        for k in za.files:
            check(np.array_equal(za[k], zb[k]), f"10c: checkpoint array {k}")
        log(f"  rows {LEGACY_CKPT + 1}-{2 * LEGACY_CKPT} and the "
            f"{len(za.files)} arrays of the final checkpoint bitwise equal")

        log(" -- 10d: python -m gphocs_tpu_torch --legacy-rng on the card "
            f"(started with 10a; {time.perf_counter() - t0:.1f} s)")
        rc = cli.wait(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
        cli_out.close()
    text = open(cli_out.name).read()
    check(rc == 0, f"10d failed:\n{text[-3000:]}")
    head = text.splitlines()[0]
    check("legacy RNG: node-age/migration-age/SPR sweeps as tensor code"
          in head, f"10d: start line {head!r}")
    rows = open(trace).read().splitlines()
    check(len(rows) == 5, f"10d: {len(rows)} trace lines")
    log(f"  exit 0; {head}; {len(rows) - 1} trace rows")

    log(f" -- 10e: the standard workload ({WORKLOAD_LOCI} loci) at f32 and "
        f"f64, {LEGACY_CHUNK} iterations per chunk "
        f"({time.perf_counter() - t0:.1f} s)")
    rec = {}
    total = dict.fromkeys(sweeps.LAUNCHES, 0)
    for dt, name in ((torch.float32, "f32"), (f64, "f64")):
        s = legacy_sampler(SAMPLE_CTL, data, "cuda", dt, loci=-1)
        s.step_chunk(1, do_migrate=True)
        sweeps.reset_launch_counts()
        its = []
        for _ in range(3):
            torch.cuda.synchronize()
            t_chunk = time.perf_counter()
            s.step_chunk(LEGACY_CHUNK, do_migrate=True)
            torch.cuda.synchronize()
            its.append(LEGACY_CHUNK / (time.perf_counter() - t_chunk))
        n = 3 * LEGACY_CHUNK
        launches = dict(sweeps.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        check(launches == legacy_schedule(n, False),
              f"10e {name}: launches {launches}")
        prof = legacy_profile(s, 1)
        check(bool(torch.isfinite(s.lnld).all()), f"10e {name}: lnld")
        check_carried_lnld(s)
        rec[name] = {"it_per_s": sorted(its)[1], "readings": its,
                     "rubber_band_per_iteration":
                         launches["rubber_band"] / n,
                     "kernel_launches_node_age_mig_age_spr":
                         launches["node_age"] + launches["mig_age"]
                         + launches["spr"], **(prof or {})}
        log(f"  {name}: {sorted(its)[1]:.3f} it/s (median of "
            f"{[round(x, 3) for x in its]}); device operations per "
            f"iteration {prof and prof['ops_per_iteration']}; device busy "
            f"{prof and prof['device_ms_per_iteration']} ms of "
            f"{prof and prof['wall_ms_per_iteration']} ms per iteration "
            f"(idle share {prof and prof['idle_share']}); rubber-band "
            f"launches per iteration {launches['rubber_band'] / n:g}; "
            f"node-age, migration-age and SPR kernel launches "
            f"{launches['node_age']}, {launches['mig_age']}, "
            f"{launches['spr']}; on {card}")
        del s
    rec["worst_rel_vs_cpu"] = worst
    log(f"  10e done at {time.perf_counter() - t0:.1f} s")
    return total, rec


LEGACY_CHAINS = 2        # (a)-(c) of phase 11
LEGACY_CHAIN_ITERS = 3   # (a): iterations held against the CPU, per workload
LEGACY_BIG_CHAINS = 4    # (d): the standard workload's chains


def legacy_chain_starts(label, ctl, data, card):
    """Phase 11a: chain c of the card's legacy chains at iteration 0 is the
    one-chain legacy initialization with seed 111 + 7919 c: genealogies,
    parameters and streams bitwise, the carried lnld and lnp within 1e-12
    relative (sums over the loci of one chain or of all)."""
    import torch

    L = card.num_loci
    for c in range(card.chains):
        one = legacy_sampler(ctl, data, "cuda", torch.float64,
                             seed=111 + 7919 * c)
        gen, params = card.chain_state(c)
        cut = slice(c * L, (c + 1) * L)
        for f in gen._fields:
            check(torch.equal(getattr(gen, f), getattr(one.gen, f)),
                  f"11a {label}: chain {c}'s initial {f}")
        for f in params._fields:
            a, b = getattr(params, f), getattr(one.params, f)
            check(torch.equal(a, b), f"11a {label}: chain {c}'s {f}")
        for f in "xyz":
            check(torch.equal(getattr(card.lrng, f)[cut],
                              getattr(one.lrng, f))
                  and torch.equal(getattr(card.grng, f)[c],
                                  getattr(one.grng, f)),
                  f"11a {label}: chain {c}'s streams")
        for name in ("lnld", "lnp"):
            a, b = getattr(card, name)[cut], getattr(one, name)
            check(bool(((a - b).abs() <= 1e-12 * b.abs()).all()),
                  f"11a {label}: chain {c}'s {name}")
    log(f"  {label}: chain c at iteration 0 equals the one-chain legacy "
        f"initialization with seed 111 + 7919 c (c < {card.chains})")


def mig_age_readings(s, label):
    """The migration-age kernel read three ways on sampler s's state, with
    its live migration events: `device_ms`, chip_smoke's reading (CUDA
    events around 20 launches of a prebuilt argument block);
    tools/kernel_times.py's `ms` (events around wrapper calls) and
    `kernel_ms` (the kernel's own duration, torch.profiler); and the
    profiling family `mig_age` (events around wrapper calls after a warm
    one, as `-v` prints it)."""
    import torch
    from gphocs_tpu_torch import profiling
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.tools import kernel_times as KT

    dev = torch.device("cuda")

    def call():
        return sweeps.mig_age_sweep(s.gen, s.params, s.lrng, s.ctx,
                                    s.ft.mig_time, s.lnp)

    prep = sweeps.prepare_mig_age(s.gen, s.params, s.lrng, s.ctx,
                                  s.ft.mig_time, s.lnp)
    saved = dict(sweeps.LAUNCHES)
    rec = {"live_migrations": int((s.gen.mig_branch >= 0).sum()),
           "device_ms": time_cuda(lambda: prep.launch(dev), 20),
           "kernel_times_ms": KT._events_ms(call, 20),
           "kernel_times_kernel_ms": KT._profiled(call, KT.KERNELS["mig_age"],
                                                  20)[0],
           "profiling_ms": profiling.kernel_times(s, 20)["mig_age"] * 1e3}
    sweeps.LAUNCHES.update(saved)
    log(f"  mig_age on the {label} state ({rec['live_migrations']} live "
        f"migration events): device_ms {rec['device_ms']:.4f}, "
        f"kernel_times ms {rec['kernel_times_ms']:.4f} and kernel_ms "
        f"{rec['kernel_times_kernel_ms']:.4f}, profiling "
        f"{rec['profiling_ms']:.4f}")
    return rec


def ingest_times(paths):
    """Host set-up of a sequence file, read and built into SeqData, with
    and without the native reader (in turns: native, Python, Python,
    native); ms per file."""
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.io.sequences import build_seq_data, read_seq_file

    cfg = parse_control_text(SAMPLE_CTL)
    out = {}
    for label, path in paths.items():
        reads = {True: [], False: []}
        for native in (True, False, False, True):
            t0 = time.perf_counter()
            raw = read_seq_file(path, cfg.sample_names, use_native=native)
            build_seq_data(raw, cfg.is_diploid())
            reads[native].append((time.perf_counter() - t0) * 1e3)
        out[label] = {"native_ms": reads[True], "python_ms": reads[False],
                      "loci": raw.num_loci}
        log(f"  set-up of {label} ({raw.num_loci} loci): native reader "
            f"{[round(x, 1) for x in reads[True]]} ms, Python reader "
            f"{[round(x, 1) for x in reads[False]]} ms")
    return out


def legacy_chains_phase(tmp, data, card):
    """Phase 11: the legacy RNG with chains on the card.  Returns (the
    launches of 11d's run on the standard workload, its record)."""
    import numpy as np
    import torch
    from gphocs_tpu_torch.config.samples import (ADMIX_CTL,
                                                 SAMPLE_AGE_VAR_CTL,
                                                 SAMPLE_CTL, with_settings)
    from gphocs_tpu_torch.io.native import native_available
    from gphocs_tpu_torch.ops import sweeps

    # 11c's command runs beside 11a-11b
    ctl_path = os.path.join(tmp, "legacy_chains.ctl")
    trace = os.path.join(tmp, "legacy_chains_cli.log")
    with open(ctl_path, "w") as f:
        f.write(with_settings(SAMPLE_AGE_VAR_CTL, seq_file=data,
                              trace_file=trace, num_loci=LEGACY_LOCI,
                              mcmc_iterations=4, iterations_per_log=2,
                              burn_in=0, start_mig=0, random_seed=5))
    cli_out = open(os.path.join(tmp, "legacy_chains_cli.out"), "w")
    cli = subprocess.Popen([sys.executable, "-m", "gphocs_tpu_torch",
                            ctl_path, "--legacy-rng", "--chains",
                            str(LEGACY_CHAINS), "-v"], cwd=ROOT,
                           stdout=cli_out, stderr=subprocess.STDOUT,
                           text=True)
    f64 = torch.float64
    try:
        t0 = time.perf_counter()
        log(f" -- 11a: {LEGACY_CHAINS} chains x {LEGACY_LOCI} loci at f64 on "
            f"the card against the CPU, {LEGACY_CHAIN_ITERS} iterations each")
        worst = max(legacy_vs_cpu(label, ctl, data, sa,
                                  chains=LEGACY_CHAINS,
                                  iters=LEGACY_CHAIN_ITERS, tol=1e-12,
                                  phase="11a")
                    for label, ctl, sa in (
                        ("plain", SAMPLE_CTL, False),
                        ("sample_age_var", SAMPLE_AGE_VAR_CTL, True),
                        ("admixed", ADMIX_CTL, False)))

        log(f" -- 11b: a {LEGACY_CHAINS}-chain checkpoint at iteration "
            f"{LEGACY_CKPT} resumed on the card (SAMPLE_AGE_VAR_CTL, f64; "
            f"{time.perf_counter() - t0:.1f} s)")

        def leg(name, iters, resume=False, ck=None):
            s = legacy_sampler(SAMPLE_AGE_VAR_CTL, data, "cuda", f64,
                               chains=LEGACY_CHAINS, mcmc_iterations=iters,
                               burn_in=0, iterations_per_log=LEGACY_CKPT)
            s.run(trace_path=os.path.join(tmp, f"legc_{name}.log"),
                  checkpoint_path=os.path.join(tmp, f"legc_{ck or name}.npz"),
                  checkpoint_every=LEGACY_CKPT, resume=resume)
            return s.chain_rows

        whole = leg("whole", 2 * LEGACY_CKPT)
        leg("first", LEGACY_CKPT)
        resumed = leg("resumed", 2 * LEGACY_CKPT, resume=True, ck="first")
        for c in range(LEGACY_CHAINS):
            check(np.array_equal(whole[c][LEGACY_CKPT:], resumed[c]),
                  f"11b: chain {c}'s resumed rows differ")
        za = np.load(os.path.join(tmp, "legc_whole.npz"))
        zb = np.load(os.path.join(tmp, "legc_first.npz"))
        check(sorted(za.files) == sorted(zb.files)
              and za["grng_x"].shape == (LEGACY_CHAINS, 1)
              and za["lrng_x"].shape == za["lnld"].shape
              and za["lnld"].shape[0] == LEGACY_CHAINS,
              "11b: checkpoint keys or the stacked legacy layout")
        for k in za.files:
            check(np.array_equal(za[k], zb[k]), f"11b: checkpoint array {k}")
        log(f"  every chain's rows {LEGACY_CKPT + 1}-{2 * LEGACY_CKPT} and "
            f"the {len(za.files)} arrays of the final checkpoint bitwise "
            "equal; grng_* [C, 1], lrng_* [C, L]")

        log(" -- 11c: python -m gphocs_tpu_torch --legacy-rng --chains "
            f"{LEGACY_CHAINS} -v on the card (started with 11a; "
            f"{time.perf_counter() - t0:.1f} s)")
        rc = cli.wait(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
        cli_out.close()
    text = open(cli_out.name).read()
    check(rc == 0, f"11c failed:\n{text[-3000:]}")
    head = text.splitlines()[0]
    check(f"legacy RNG: node-age/migration-age/SPR sweeps as tensor code, "
          f"{LEGACY_CHAINS} chains" in head, f"11c: start line {head!r}")
    rows = open(trace).read().splitlines()
    check(len(rows) == 5, f"11c: {len(rows)} trace lines")
    check("unavailable" not in text, "11c: a method time was unavailable")
    families = {"pruning", "full_stats", "node_age", "spr", "theta", "tau",
                "mixing", "mig_age"}
    timed = {ln.split()[0] for ln in text.splitlines()
             if ln.endswith("%") and " ms " in ln}
    check(timed == families, f"11c: method times for {sorted(timed)}")
    check(native_available(), "11c: the native sequence reader did not "
          "build on the card host")
    log(f"  exit 0; {head}; {len(rows) - 1} trace rows; method times for "
        f"all {len(families)} families; the native reader available")
    setup = ingest_times({"standard": data,
                          "ragged": os.path.join(tmp, "ragged.txt")})

    log(f" -- 11d: the standard workload ({WORKLOAD_LOCI} loci) at f32 as "
        f"{LEGACY_BIG_CHAINS} legacy chains, {LEGACY_CHUNK} iterations per "
        f"chunk ({time.perf_counter() - t0:.1f} s)")
    s = legacy_sampler(SAMPLE_CTL, data, "cuda", torch.float32, loci=-1,
                       chains=LEGACY_BIG_CHAINS)
    s.step_chunk(1, do_migrate=True)
    sweeps.reset_launch_counts()
    its = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_chunk = time.perf_counter()
        s.step_chunk(LEGACY_CHUNK, do_migrate=True)
        torch.cuda.synchronize()
        its.append(LEGACY_CHUNK / (time.perf_counter() - t_chunk))
    n = 3 * LEGACY_CHUNK
    launches = dict(sweeps.LAUNCHES)
    check(launches == legacy_schedule(n, False), f"11d: launches {launches}")
    prof = legacy_profile(s, 1)
    check(bool(torch.isfinite(s.lnld).all()), "11d: lnld")
    check_carried_lnld(s)
    it_s = sorted(its)[1]
    rec = {"chains": LEGACY_BIG_CHAINS, "it_per_s": it_s,
           "chain_it_per_s": LEGACY_BIG_CHAINS * it_s, "readings": its,
           "rubber_band_per_iteration": launches["rubber_band"] / n,
           "kernel_launches_node_age_mig_age_spr":
               launches["node_age"] + launches["mig_age"] + launches["spr"],
           **(prof or {}), "worst_rel_vs_cpu": worst, "setup": setup}
    log(f"  {LEGACY_BIG_CHAINS} chains: {it_s:.3f} it/s, "
        f"{LEGACY_BIG_CHAINS * it_s:.3f} chain-it/s (median of "
        f"{[round(x, 3) for x in its]}); device operations per iteration "
        f"{prof and prof['ops_per_iteration']}; device busy "
        f"{prof and prof['device_ms_per_iteration']} ms of "
        f"{prof and prof['wall_ms_per_iteration']} ms per iteration (idle "
        f"share {prof and prof['idle_share']}); rubber-band launches per "
        f"iteration {launches['rubber_band'] / n:g}; node-age, "
        f"migration-age and SPR kernel launches {launches['node_age']}, "
        f"{launches['mig_age']}, {launches['spr']}; on {card}")
    log(f"  11d done at {time.perf_counter() - t0:.1f} s")
    return launches, rec


# -- phase 12: chains on the loci mesh --------------------------------------

MESH_CHAINS = 4          # 12a: chains in the NCCL world of one
MESH_CHAINS_ITERS = 40   # 12a: iterations of each timed chunk
MESH_CHAINS_PAIRS = 4    # 12a: pairs of chunks, meshed and not, in turns
MESH_CHAINS_PROFILED = 3  # 12a: iterations under torch.profiler, each way
MESH_CHAINS_F64 = 2      # 12b and 12c: chains on two gloo ranks
MESH_CHAINS_CKPT = 5     # 12c: the checkpoint, resumed to MESH_CLI_ITERS


def host_profile(s, iters):
    """torch.profiler over `iters` iterations of sampler s, the host and
    the card traced: per iteration the wall ms, the device busy ms, the
    idle share, the device operations, the cudaLaunchKernel calls and
    each host operation's self ms (by name).  None where the profiler
    sees no device operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gphocs_tpu_torch.tools.profile_main import _busy_ms

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.step_chunk(iters, do_migrate=True)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"  torch.profiler failed: {e}")
        return None
    events = prof.events()
    ops = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    if not ops:
        log("  torch.profiler saw no device operation: not measured")
        return None
    busy = _busy_ms(events)
    host = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total:
            host[e.key] = host.get(e.key, 0.0) \
                + e.self_cpu_time_total / 1e3 / iters
    return {"wall_ms_per_iteration": wall / iters,
            "device_ms_per_iteration": busy / iters,
            "idle_share": 1.0 - busy / wall,
            "ops_per_iteration": ops / iters,
            "launch_calls_per_iteration": sum(
                1 for e in events if e.name == "cudaLaunchKernel") / iters,
            "host_self_ms": host}


def mesh_chains_turns(data, chains):
    """Phase 12a: a world of one over NCCL in this process, the standard
    workload as `chains` chains at f32 with and without the mesh from one
    state: WARMUP iterations each, then MESH_CHAINS_PAIRS pairs of chunks
    of MESH_CHAINS_ITERS in turns (plain, meshed, meshed, plain, ...),
    each meshed chunk bitwise equal to the plain one from the same state
    (stats, trace, gathered state, counters) with the same launches; then
    host_profile over MESH_CHAINS_PROFILED iterations, twice each in
    turns, the host's self ms compared by operation.  Returns (launches of the first
    meshed chunk, the readings)."""
    import torch
    from gphocs_tpu_torch.parallel import mesh as M

    M.init_distributed(f"127.0.0.1:{M.free_port()}", 1, 0, device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = M.make_mesh()
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        plain = mesh_sampler(data, torch.float32, chains=chains)
        meshed = mesh_sampler(data, torch.float32, mesh, chains=chains)
        for f in ("gens", "lrngs", "lnlds", "lnps", "conds", "params",
                  "grng"):
            setattr(meshed, f, getattr(plain, f))
        for smp in (plain, meshed):
            smp.step_chunk(WARMUP, do_migrate=True)
        pairs, launches = [], None
        for k in range(MESH_CHAINS_PAIRS):
            order = (plain, meshed) if k % 2 == 0 else (meshed, plain)
            got = {id(smp): mesh_chunk(smp, MESH_CHAINS_ITERS)
                   for smp in order}
            if launches is None:
                launches = check_schedule(MESH_CHAINS_ITERS, 1, False)
            pairs.append((got[id(plain)], got[id(meshed)]))
        prof = {"plain": [], "meshed": []}
        for smp in (plain, meshed, meshed, plain):
            prof["plain" if smp is plain else "meshed"].append(
                host_profile(smp, MESH_CHAINS_PROFILED))
    finally:
        M.shutdown()
    for a, b in pairs:
        compare_runs("12a", a, b, exact=True)
        check(a["launches"] == b["launches"], f"12a launches "
              f"{a['launches']} against {b['launches']}")
    its = [MESH_CHAINS_ITERS / b["seconds"] for _, b in pairs]
    plain_its = [MESH_CHAINS_ITERS / a["seconds"] for a, _ in pairs]
    nccl = [b["collectives"] for _, b in pairs]
    n = len(pairs) * MESH_CHAINS_ITERS
    rec = {"chains": chains,
           "it_per_s": sum(its) / len(its),
           "chain_it_per_s": chains * sum(its) / len(its),
           "readings": its, "plain_readings": plain_its,
           "ratio_in_turns": sum(its) / sum(plain_its),
           "all_reduces_per_iteration":
               sum(c["all_reduce"] for c in nccl) / n,
           "all_reduce_host_ms_per_iteration":
               [1e3 * c["seconds"] / MESH_CHAINS_ITERS for c in nccl]}
    if all(all(p) for p in prof.values()):
        # each host operation's self ms per iteration, meshed and not,
        # the mean of the two profiles of each: the 8 that grew most
        host = {k: {} for k in prof}
        for k, ps in prof.items():
            for p in ps:
                for op, ms in p.pop("host_self_ms").items():
                    host[k][op] = host[k].get(op, 0.0) + ms / len(ps)
        hm, hp = host["meshed"], host["plain"]
        more = sorted(((hm.get(k, 0.0) - hp.get(k, 0.0), k)
                       for k in set(hm) | set(hp)), reverse=True)
        rec["profiled"] = prof
        rec["host_self_ms_more_meshed"] = {
            k: [hm.get(k, 0.0), hp.get(k, 0.0)] for _, k in more[:8]}
        rec["host_self_ms_total"] = [sum(hm.values()), sum(hp.values())]
    log(f"  bitwise equal to the chains without a mesh in all "
        f"{len(pairs)} pairs (stats, trace, state, counters); launches "
        f"{pairs[0][1]['launches']}; {rec}")
    return launches, rec


def mesh_chains_phase(tmp, data, card):
    """Phase 12: chains on the loci mesh.  Returns (launches of 12a's
    meshed chunk, a record of the phase's readings)."""
    import numpy as np
    import torch

    rec = {}
    log(f" -- 12a: NCCL, a world of one, {MESH_CHAINS} chains of "
        f"{WORKLOAD_LOCI} loci at f32: {MESH_CHAINS_PAIRS} pairs of "
        f"{MESH_CHAINS_ITERS} iterations in turns with the same chains "
        f"without a mesh, then each profiled, on {card}")
    launches, rec["nccl1"] = mesh_chains_turns(data, MESH_CHAINS)

    C = MESH_CHAINS_F64
    log(f" -- 12b: two ranks share the card over gloo, {C} chains at f64 "
        f"({WORKLOAD_LOCI} and {MESH_PAD_LOCI} loci, {MESH_F64_ITERS} "
        "iterations), against one process with loci_multiple=2")
    _, worst = two_ranks(tmp, data, C)
    rec.update({f"gloo2_{k}_max_rel": v for k, v in worst.items()})

    log(f" -- 12c: python -m gphocs_tpu_torch --distributed --chains {C} "
        f"--x64, 2 processes sharing the card, {MESH_CLI_ITERS} iterations "
        f"with a checkpoint at {MESH_CHAINS_CKPT} and --resume, against the "
        "one-process command")
    whole = cli_ctl(tmp, "chains_whole", data, MESH_CLI_ITERS)
    first = cli_ctl(tmp, "chains_first", data, MESH_CHAINS_CKPT)
    ck = {n: os.path.join(tmp, f"chains_{n}.npz")
          for n in ("whole", "first", "second")}
    chains = ["--chains", str(C), "--checkpoint-every", str(MESH_CHAINS_CKPT)]
    cli_finish(tmp, [
        cli_start(tmp, "chains_one", whole, *chains),
        *cli_ranks(tmp, "chains_whole", whole, *chains,
                   "--checkpoint", ck["whole"]),
        *cli_ranks(tmp, "chains_first", first, *chains,
                   "--checkpoint", ck["first"])], "12c")
    shutil.copy(ck["first"], ck["second"])
    cli_finish(tmp, cli_ranks(tmp, "chains_second", whole, *chains,
                              "--checkpoint", ck["second"], "--resume"),
               "12c")
    for name in ("whole", "first", "second"):
        check(os.listdir(os.path.join(tmp, f"cli_chains_{name}1")) == [],
              f"12c: rank 1 of {name} wrote a file")
    rec["cli_max_rel"] = cli_trace_rel(tmp, "12c", "chains_one",
                                       "chains_whole0")

    def trace(name):
        with open(os.path.join(tmp, f"cli_{name}", "trace.log")) as f:
            return f.read().splitlines()

    rows = trace("chains_whole0")
    check(trace("chains_second0") == [rows[0]] + rows[1 + MESH_CHAINS_CKPT:],
          "12c: the resumed trace differs from the uninterrupted one")
    za, zb = np.load(ck["whole"]), np.load(ck["second"])
    check(sorted(za.files) == sorted(zb.files)
          and all(np.array_equal(za[k], zb[k]) for k in za.files),
          "12c: the resumed run's checkpoint differs")
    check(za["gen_age"].shape[:2] == (C, WORKLOAD_LOCI)
          and za["params_theta"].shape[0] == C,
          f"12c: checkpoint layout {za['gen_age'].shape}")
    log(f"  rank 0's trace within {rec['cli_max_rel']:.2e} relative of the "
        "one-process trace; the resumed trace and checkpoint bitwise equal "
        f"to the uninterrupted run's ([{C}, {WORKLOAD_LOCI}, ...]); rank 1 "
        "wrote no file")
    torch.cuda.synchronize()
    return launches, rec


# -- phase 13: the legacy RNG on the loci mesh ------------------------------

LEGACY_MESH_CHAINS = (1, 2)  # 13a: the chain counts, in turns each
LEGACY_MESH_ITERS = 1        # 13a: iterations each way, one per chunk
LEGACY_MESH_CPU_ITERS = 2    # 13b: card iterations held against the CPU
# 13b: (label, control file of config/samples.py, loci, chains)
LEGACY_MESH_WORKLOADS = (
    ("var", "SAMPLE_AGE_VAR_CTL", LEGACY_LOCI, 1),
    ("var_pad_chains2", "SAMPLE_AGE_VAR_CTL", LEGACY_LOCI - 1, 2),
    ("admix_pad", "ADMIX_CTL", LEGACY_LOCI - 1, 1),
    ("admix_chains2", "ADMIX_CTL", LEGACY_LOCI, 2))
LEGACY_MESH_CLI_ITERS = 4    # 13c
LEGACY_MESH_CKPT = 2         # 13c: the checkpoint, resumed to 4


def legacy_var_ctl():
    """SAMPLE_CTL with `locus-mut-rate VAR 1.0` and SAMPLE_AGE_VAR_CTL's
    rate finetune (0.3): 13a's workload, whose rate update crosses the
    ranks."""
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL, with_settings

    return with_settings(SAMPLE_CTL, locus_mut_rate="VAR 1.0",
                         finetune_locus_rate=0.3)


def legacy_mesh_turns(data, card):
    """Phase 13a: a world of one over NCCL in this process, 13a's
    workload at f32 under the legacy RNG with and without the mesh from
    one state, for each chain count of LEGACY_MESH_CHAINS:
    LEGACY_MESH_ITERS chunks of one iteration each way in turns (plain,
    meshed, meshed, plain), each meshed chunk bitwise equal to the plain
    one (stats, trace, gathered state, streams) with the same launches;
    then legacy_profile over one iteration of the meshed sampler.
    Returns (the meshed chunks' launches, the readings per chain
    count)."""
    import torch
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.parallel import mesh as M

    ctl = legacy_var_ctl()
    total = dict.fromkeys(sweeps.LAUNCHES, 0)
    rec = {}
    M.init_distributed(f"127.0.0.1:{M.free_port()}", 1, 0, device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = M.make_mesh()
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        for C in LEGACY_MESH_CHAINS:
            t0 = time.perf_counter()
            plain = legacy_sampler(ctl, data, "cuda", torch.float32,
                                   loci=-1, chains=C)
            meshed = legacy_sampler(ctl, data, "cuda", torch.float32,
                                    loci=-1, chains=C, mesh=mesh)
            legacy_copy(plain, meshed)
            setup = time.perf_counter() - t0
            pairs = []
            for k in range(LEGACY_MESH_ITERS):
                order = (plain, meshed) if k % 2 == 0 else (meshed, plain)
                got = {id(x): mesh_chunk(x, 1) for x in order}
                pairs.append((got[id(plain)], got[id(meshed)]))
            # one profiled iteration of the meshed sampler (~15-17 s on
            # the card, and its ~760,000 device events to read)
            prof = legacy_profile(meshed, 1)
            for a, b in pairs:
                compare_runs(f"13a C={C}", a, b, exact=True)
                check(a["launches"] == b["launches"] == legacy_schedule(
                    1, False), f"13a C={C}: launches {b['launches']}")
                for key, v in b["launches"].items():
                    total[key] += v
            coll = [b["collectives"] for _, b in pairs]
            n = len(pairs)
            acc = [int(b["stats"]["acc_locus_rate"].sum()) for _, b in pairs]
            check(min(acc) > 0, f"13a C={C}: no rate move accepted")
            rec[f"c{C}"] = {
                "it_per_s": [1.0 / b["seconds"] for _, b in pairs],
                "plain_it_per_s": [1.0 / a["seconds"] for a, _ in pairs],
                "ratio_in_turns": sum(a["seconds"] for a, _ in pairs)
                / sum(b["seconds"] for _, b in pairs),
                **{f"{k}_per_iteration": sum(c[k] for c in coll) / n
                   for k in ("all_reduce", "broadcast", "all_gather")},
                "host_ms_per_iteration": {
                    k: 1e3 * sum(c[key] for c in coll) / n
                    for k, key in (("all_reduce", "seconds"),
                                   ("broadcast", "broadcast_seconds"),
                                   ("all_gather", "all_gather_seconds"))},
                "rate_accepts": acc,
                "rubber_band_per_iteration":
                    pairs[0][1]["launches"]["rubber_band"],
                "setup_s": setup, "profiled": prof}
            log(f"  C={C}: {n} pairs bitwise equal (stats, trace, state, "
                f"streams); {rec[f'c{C}']}; on {card}")
            del plain, meshed, pairs
    finally:
        M.shutdown()
    return total, rec


def legacy_gathered(s):
    """The legacy sampler's state with every rank's loci gathered, on the
    CPU, as legacy_copy reads it (gens, params, lrngs, grng, lnlds,
    lnps, conds, rate_var)."""
    from gphocs_tpu_torch.parallel.mesh import gather_rows
    from gphocs_tpu_torch.rng import WhRngState
    from gphocs_tpu_torch.state import GenState

    def rows(t):
        return gather_rows(s.mesh, t, s.chains).cpu()

    return {"gens": (GenState(*(rows(x) for x in s.gen)),),
            "lrngs": (WhRngState(*(rows(x) for x in s.lrng)),),
            "lnlds": (rows(s.lnld),), "lnps": (rows(s.lnp),),
            "conds": (rows(s.cond),),
            "params": type(s.params)(*(None if x is None else x.cpu()
                                       for x in s.params)),
            "grng": WhRngState(*(x.cpu() for x in s.grng)),
            "rate_var": s.rate_var}


def legacy_mesh_rank(spec, rank):
    """One of the two ranks of phase 13b, sharing the card over gloo:
    for each workload of SPEC, its legacy sampler at f64 on this rank's
    block, then SPEC["iters"] chunks of one iteration, each with the
    gathered state before it, and after the last the rubber band (both
    modes where the workload estimates a sample age) against its plain
    version on the rank's block; rank 0 writes what they gathered."""
    import torch
    from gphocs_tpu_torch.config import samples
    from gphocs_tpu_torch.parallel import mesh as M

    M.init_distributed(f"127.0.0.1:{spec['port']}", 2, rank, device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = M.make_mesh()
        check(mesh.backend == "gloo", f"backend {mesh.backend}")
        out = {}
        for label, ctl, loci, chains in spec["workloads"]:
            s = legacy_sampler(getattr(samples, ctl), spec["data"], "cuda",
                               torch.float64, loci=loci, chains=chains,
                               mesh=mesh)
            steps = []
            for _ in range(spec["iters"]):
                before = legacy_gathered(s)
                res = mesh_chunk(s, 1)
                res["before"] = before
                res["launches_by_rank"] = [
                    dict(zip(res["launches"], v.long().tolist()))
                    for v in M.gather_rows(mesh, torch.tensor(
                        [list(res["launches"].values())],
                        dtype=torch.float64), 1)]
                steps.append(res)
            cmp = Compare()
            rubber_band_checks(s, cmp, F64_TOL)
            if bool(s.tree.update_sample_age[SAMPLE_AGE_POP]):
                sample_age_checks(s, cmp, F64_TOL)
            errs = M.all_reduce(mesh, [torch.tensor(
                [cmp.err.get(k, 0.0) for k in ("rubber_band",
                                               "rubber_band_sample_age")])],
                "max")[0]
            out[label] = {"steps": steps, "rubber_band_err": errs.tolist(),
                          "loci": [s.gen.num_loci, s.num_loci, s.pad_loci]}
        if rank == 0:
            torch.save(out, spec["out"])
    finally:
        M.shutdown()
    return 0


def legacy_two_ranks(tmp, data):
    """Phase 13b: two ranks sharing the card over gloo
    (`chip_smoke.py --mesh-rank`, legacy_mesh_rank) on the workloads of
    LEGACY_MESH_WORKLOADS at f64; each of their card iterations held
    against one iteration of a one-process CPU sampler with
    loci_multiple=2 from the same gathered state: equal accept counts
    (per chain), streams and integer arrays, reals within 1e-9 relative,
    each rank launching the legacy schedule, each chain's padding locus
    inert, the rubber band equal to its plain version on each rank's
    block.  Returns the largest relative difference per workload."""
    import types

    import torch
    from gphocs_tpu_torch.config import samples
    from gphocs_tpu_torch.parallel import mesh as M

    spec = {"port": M.free_port(), "data": data, "rng_mode": "legacy",
            "workloads": LEGACY_MESH_WORKLOADS,
            "iters": LEGACY_MESH_CPU_ITERS,
            "out": os.path.join(tmp, "ranks_13b.pt")}
    spec_path = os.path.join(tmp, "spec_13b.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    outs = [open(os.path.join(tmp, f"rank_13b_{r}.out"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank",
         spec_path, str(r)], cwd=ROOT, stdout=outs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        rcs = [p.wait(timeout=MESH_TIMEOUT_S + 300) for p in procs]
    finally:
        for p, o in zip(procs, outs):
            if p.poll() is None:
                p.kill()
                p.wait()
            o.close()
    for r, rc in enumerate(rcs):
        text = open(os.path.join(tmp, f"rank_13b_{r}.out")).read()
        check(rc == 0, f"13b rank {r} failed:\n{text[-3000:]}")
    got = torch.load(spec["out"], weights_only=False)
    worst = {}
    for label, ctl, loci, chains in LEGACY_MESH_WORKLOADS:
        res = got[label]
        sample_age = ctl == "SAMPLE_AGE_VAR_CTL"
        cpu = legacy_sampler(getattr(samples, ctl), data, "cpu",
                             torch.float64, loci=loci, chains=chains,
                             loci_multiple=2)
        worst[label] = 0.0
        for i, step in enumerate(res["steps"]):
            legacy_copy(types.SimpleNamespace(**step["before"]), cpu)
            ref = mesh_chunk(cpu, 1)
            worst[label] = max(worst[label], compare_runs(
                f"13b {label} iteration {i}", ref, step, exact=False))
            for by_rank in step["launches_by_rank"]:
                check(by_rank == legacy_schedule(1, sample_age),
                      f"13b {label}: launches {by_rank}")
        Lp = LEGACY_LOCI
        check(res["loci"] == [chains * Lp // 2, Lp, Lp - loci],
              f"13b {label}: rows {res['loci']}")
        st = res["steps"][-1]["state"]
        if loci < Lp:
            last = [c * Lp + Lp - 1 for c in range(chains)]
            check(not bool(st["gen"]["valid"][last].any())
                  and bool((st["lnld"][last] == 0).all()),
                  f"13b {label}: a padding locus is not inert")
        acc = res["steps"][-1]["stats"]
        log(f"  {label}: {chains} chain(s) of {loci} loci ({Lp - loci} "
            f"padding each), each rank {res['loci'][0]} rows; "
            f"{len(res['steps'])} card iterations, each equal to one CPU "
            f"iteration (accepts, streams, integers), reals within "
            f"{worst[label]:.2e} relative; accepts of the last: spr "
            f"{acc['acc_spr'].tolist()} rates "
            f"{acc['acc_locus_rate'].tolist()} admix "
            f"{acc['acc_admix'].tolist()}; rubber band against its plain "
            f"version on each rank's block, max |diff| (tau, sample age) "
            f"{res['rubber_band_err']}")
    return worst


def legacy_mesh_phase(tmp, data, card):
    """Phase 13: the legacy RNG on the loci mesh.  Returns (launches of
    13a's meshed chunks, a record of the phase's readings)."""
    import numpy as np
    import torch
    from gphocs_tpu_torch.config.samples import (SAMPLE_AGE_VAR_CTL,
                                                 with_settings)

    t0 = time.perf_counter()
    log(f" -- 13a: NCCL, a world of one, {WORKLOAD_LOCI} loci with VAR "
        f"rates at f32, {LEGACY_MESH_CHAINS} chain(s): "
        f"{LEGACY_MESH_ITERS} chunk(s) of one iteration each way in turns, "
        f"on {card}")
    launches, rec = legacy_mesh_turns(data, card)
    rec = {"nccl1": rec}

    log(f" -- 13b: two ranks share the card over gloo at f64 "
        f"({LEGACY_MESH_CPU_ITERS} iterations per workload, each against "
        f"the CPU; {time.perf_counter() - t0:.1f} s)")
    rec["gloo2_max_rel"] = legacy_two_ranks(tmp, data)

    C = 2
    log(f" -- 13c: python -m gphocs_tpu_torch --legacy-rng --distributed "
        f"--chains {C} --x64, 2 processes sharing the card, "
        f"{LEGACY_MESH_CLI_ITERS} iterations of {LEGACY_LOCI} loci with a "
        f"checkpoint at {LEGACY_MESH_CKPT} and --resume, against the "
        f"one-process command ({time.perf_counter() - t0:.1f} s)")

    def ctl(name, iterations):
        path = os.path.join(tmp, f"{name}.ctl")
        with open(path, "w") as f:
            f.write(with_settings(
                SAMPLE_AGE_VAR_CTL, seq_file=data, trace_file="trace.log",
                num_loci=LEGACY_LOCI, mcmc_iterations=iterations,
                iterations_per_log=LEGACY_MESH_CKPT, random_seed=5,
                burn_in=0, start_mig=0))
        return path

    whole = ctl("lm_whole", LEGACY_MESH_CLI_ITERS)
    first = ctl("lm_first", LEGACY_MESH_CKPT)
    ck = {n: os.path.join(tmp, f"lm_{n}.npz")
          for n in ("whole", "first", "second")}
    flags = ["--legacy-rng", "--chains", str(C), "--checkpoint-every",
             str(LEGACY_MESH_CKPT)]
    cli_finish(tmp, [
        cli_start(tmp, "lm_one", whole, *flags),
        *cli_ranks(tmp, "lm_whole", whole, *flags,
                   "--checkpoint", ck["whole"]),
        *cli_ranks(tmp, "lm_first", first, *flags,
                   "--checkpoint", ck["first"])], "13c")
    shutil.copy(ck["first"], ck["second"])
    cli_finish(tmp, cli_ranks(tmp, "lm_second", whole, *flags,
                              "--checkpoint", ck["second"], "--resume"),
               "13c")
    for name in ("whole", "first", "second"):
        check(os.listdir(os.path.join(tmp, f"cli_lm_{name}1")) == [],
              f"13c: rank 1 of {name} wrote a file")
    rec["cli_max_rel"] = cli_trace_rel(tmp, "13c", "lm_one", "lm_whole0",
                                       LEGACY_MESH_CLI_ITERS)

    def trace(name):
        with open(os.path.join(tmp, f"cli_{name}", "trace.log")) as f:
            return f.read().splitlines()

    rows = trace("lm_whole0")
    check(trace("lm_second0") == [rows[0]] + rows[1 + LEGACY_MESH_CKPT:],
          "13c: the resumed trace differs from the uninterrupted one")
    za, zb = np.load(ck["whole"]), np.load(ck["second"])
    check(sorted(za.files) == sorted(zb.files)
          and all(np.array_equal(za[k], zb[k]) for k in za.files),
          "13c: the resumed run's checkpoint differs")
    check(za["gen_age"].shape[:2] == (C, LEGACY_LOCI)
          and za["lrng_x"].shape == (C, LEGACY_LOCI)
          and za["grng_x"].shape == (C, 1) and "lrng_key" not in za.files,
          f"13c: checkpoint layout {za['gen_age'].shape} "
          f"{za['lrng_x'].shape}")
    log(f"  rank 0's trace within {rec['cli_max_rel']:.2e} relative of the "
        "one-process trace; the resumed trace and checkpoint bitwise equal "
        f"to the uninterrupted run's ([{C}, {LEGACY_LOCI}, ...], lrng_* "
        f"[{C}, {LEGACY_LOCI}], grng_* [{C}, 1]); rank 1 wrote no file")
    torch.cuda.synchronize()
    return launches, rec


# phase 14: the counter streams' draw kernel (csrc/counter_draw.cu)
DRAW_LAYOUTS = ("one_lane", "lanes", "chains")
DRAW_BATCHES = 9    # draw launches of draw_outputs on the card
DRAW_SEED = 1700000017   # the benchmark seed of 14b's data and sampler
DRAW_LOCI = 1000         # sample_1k: 1,000 loci of 1,000 bp
DRAW_ITERS = 50          # 14b: one chunk of the benchmark
# draw batches an iteration of sample_1k: theta 2, m 2, tau 3 x 2, mixing 2
DRAW_PER_ITERATION = 12
SAMPLE_1K_CTL = os.path.join(ROOT, "benchmark", "configs",
                             "sample-control-file.ctl")


def draw_streams(layout, wrap, device):
    """(per-locus stream, general stream, per-lane offsets) of a layout:
    "one_lane" (one lane, a 0-d counter), "lanes" (37 lanes, a 0-d
    counter; the general stream one lane) or "chains" (3 chains of 5
    lanes, [3] counters; the general stream [3]).  With `wrap` the
    counters stand 1 to 3 below 2^32, so that the draws wrap."""
    import torch
    from gphocs_tpu_torch import rng_fast as RF

    lanes, chains = {"one_lane": (1, 0), "lanes": (37, 0),
                     "chains": (15, 3)}[layout]
    base = 2 ** 32 - 3 if wrap else 7
    ctr = torch.tensor([base + c for c in range(chains)] if chains else base,
                       dtype=torch.int64, device=device)
    per = RF.FastRngState(RF.init_fast(lanes, 4242, device).key, ctr)
    gen = RF.FastRngState(RF.init_fast(max(chains, 1), 99, device).key,
                          ctr.clone())
    offs = torch.arange(lanes, dtype=torch.int64, device=device) * 5 % 11
    return per, gen, offs


def draw_outputs(per, gen, offs, dtype):
    """Every draw function of rng_fast on the streams of draw_streams, by
    name: uniforms at an int and at per-lane offsets, normals and uniforms
    of every lane, of the general stream one by one and in batches (n and
    3n consecutive draws), and the advanced counters (`<name>.ctr`), by
    the kernel or the ATen chain as rng_fast routes them.  The normals'
    names hold "normal".  DRAW_BATCHES launches on the card."""
    from gphocs_tpu_torch import rng_fast as RF

    out = {"raw_u": RF.raw_u(per, 1, dtype),
           "raw_u_offsets": RF.raw_u(per, offs + 2, dtype)}
    for draw in (RF.rnd2normal8, RF.rndnormal, RF.rndu):
        out[draw.__name__], st = draw(per, dtype)
        out[draw.__name__ + ".ctr"] = st.ctr
    for draw in (RF.rndu, RF.rnd2normal8):
        out["general_" + draw.__name__], st = draw(gen, dtype)
        out[f"general_{draw.__name__}.ctr"] = st.ctr
    for draw, n in ((RF.batch_u, 5), (RF.batch_2normal8, 4)):
        out[draw.__name__], st = draw(gen, n, dtype)
        out[draw.__name__ + ".ctr"] = st.ctr
    return out


def aten_route(fn, *args):
    """fn(*args) with rng_fast's draws on the ATen chain on every device
    (the route of CUDA draws before counter_draw.cu); the sweep wrappers
    keep their kernels."""
    from gphocs_tpu_torch import rng_fast as RF
    from gphocs_tpu_torch.ops import cuda_lib

    uniforms = RF._uniforms

    def on_chain(*a):
        on_cuda = cuda_lib.on_cuda
        cuda_lib.on_cuda = lambda *tensors: False
        try:
            return uniforms(*a)
        finally:
            cuda_lib.on_cuda = on_cuda

    RF._uniforms = on_chain
    try:
        return fn(*args)
    finally:
        RF._uniforms = uniforms


def sample_1k_data(path, seed, num_loci=DRAW_LOCI):
    """sample_1k's sequence file for `seed` (benchmark/datagen.py)."""
    from benchmark import datagen
    from benchmark.reference import control

    with open(SAMPLE_1K_CTL) as f:
        ctl = control.parse(f.read())
    datagen.write_seq_file(path, ctl, num_loci, 1000, seed)


def sample_1k_sampler(data, device, dtype, seed):
    """The benchmark's set-up of sample_1k.c1 for `seed` (benchmark/
    harness.py): initialized, iteration 0 without migration, the migration
    rates drawn.  Uses only what every version of Sampler has."""
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.sampler.driver import Sampler

    with open(SAMPLE_1K_CTL) as f:
        cfg = parse_control_text(f.read())
    cfg.mcmc.random_seed = seed % (2 ** 31 - 1 - 7919)
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=data, dtype=dtype, device=device)
    s.initialize()
    s.step_chunk(1, do_migrate=False)
    s._sample_mig_rates_device()
    return s


def chunk_rows(root, data, seed, out):
    """`chip_smoke.py --chunk-rows ROOT DATA SEED OUT`: the trace rows and
    final counters of one f64 chunk of DRAW_ITERS iterations of sample_1k
    on the card, run by the gphocs_tpu_torch of the checkout ROOT (14b's
    parent comparison), saved to OUT."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import gphocs_tpu_torch

    here = os.path.dirname(os.path.abspath(gphocs_tpu_torch.__file__))
    check(here == os.path.join(os.path.abspath(root), "gphocs_tpu_torch"),
          f"imported {here}, not the package of {root}")
    s = sample_1k_sampler(data, "cuda", torch.float64, int(seed))
    _, tr = s.step_chunk(DRAW_ITERS, do_migrate=True)
    torch.save({"rows": {f: getattr(tr, f).cpu() for f in tr._fields},
                "lrng_ctr": s.lrng.ctr.cpu(), "grng_ctr": s.grng.ctr.cpu()},
               out)
    return 0


def _spr_one_walk(update_spr):
    """update_spr with every locus walking on its own (sync_group = 1),
    the card's schedule: the CPU's spr_sweep then draws as the kernel."""
    def one(*args, **kwargs):
        kwargs["sync_group"] = 1
        return update_spr(*args, **kwargs)
    return one


def fast_vs_cpu(card, cpu, iters, tol=2e-5, draws=DRAW_PER_ITERATION):
    """Phase 14b: `iters` iterations of the card's sampler (fast RNG), each
    held against one iteration of the CPU's from the same state, SPR
    walking locus by locus on both: equal accept counts, counters and
    integer arrays (every decision); every real within `tol` of its
    field's largest value.  The reals are not bitwise: the kernels'
    arithmetic and the card's libm differ from the plain versions' by an
    ulp, and an iteration magnifies that (SPR's coalescence times on
    segments of low hazard moved single ages by up to 5.17e-6 of the
    largest age in 50 iterations of sample_1k at DRAW_SEED, by the draw
    kernel's route and by the ATen chain's alike); a wrong draw moves a
    value by its own size and changes decisions.  Each card iteration must
    draw `draws` batches through the kernel (0 on the ATen route), the
    CPU's none.  Returns (the card's trace rows, the largest difference
    relative to its field's largest value)."""
    import torch
    from gphocs_tpu_torch.ops import sweeps

    worst, rows = 0.0, []

    def close(name, a, b):
        nonlocal worst
        a, b = a.double().cpu(), b.double().cpu()
        if not a.numel():
            return
        scale = float(a.abs().max())
        d = float((a - b).abs().max())
        worst = max(worst, d / scale if scale else d)
        check(d <= tol * scale, f"14b: {name} differs by {d:.3e}, beyond "
              f"{tol:g} of its largest value {scale:.3e}")

    def equal(name, a, b):
        check(torch.equal(a.cpu(), b.cpu()), f"14b: {name} differs")

    for it in range(iters):
        legacy_copy(card, cpu)
        sweeps.reset_launch_counts()
        st_g, tr_g = card.step_chunk(1, do_migrate=True)
        torch.cuda.synchronize()
        check(sweeps.LAUNCHES["rng_draw"] == draws,
              f"14b: {sweeps.LAUNCHES['rng_draw']} draw launches in "
              f"iteration {it}")
        plain_spr = sweeps.update_spr
        sweeps.update_spr = _spr_one_walk(plain_spr)
        try:
            st_c, tr_c = cpu.step_chunk(1, do_migrate=True)
        finally:
            sweeps.update_spr = plain_spr
        check(sweeps.LAUNCHES["rng_draw"] == draws,
              "14b: the CPU's sampler drew through the kernel")
        rows.append(tr_g)
        for f in st_g._fields:
            a, b = getattr(st_c, f), getattr(st_g, f)
            (close if a.is_floating_point() else equal)(f"{f} ({it})", a, b)
        for f in tr_g._fields:
            close(f"trace {f} ({it})", getattr(tr_c, f), getattr(tr_g, f))
        for f in card.gen._fields:
            a, b = getattr(cpu.gen, f), getattr(card.gen, f)
            if isinstance(a, torch.Tensor):
                (close if a.is_floating_point() else equal)(
                    f"{f} ({it})", a, b)
        for name, a, b in (("lnld", cpu.lnld, card.lnld),
                           ("lnp", cpu.lnp, card.lnp),
                           ("cond", cpu.cond, card.cond)):
            close(f"{name} ({it})", a, b)
        for r_c, r_g in ((cpu.lrng, card.lrng), (cpu.grng, card.grng)):
            equal(f"streams ({it})", r_c.ctr, r_g.ctr)
    rows = type(rows[0])(*(torch.cat(x) for x in zip(*rows)))
    return rows, worst


def draw_times(dev):
    """The draw kernel at f32 on two shapes: theta's batch of sample_1k
    (batch_2normal8 of 7 populations: 21 draws of the general stream) and
    one draw per lane of 1,000 lanes at 3 positions (rnd2normal8 of the
    VAR rate update).  Per shape: the kernel's device us per launch
    (torch.profiler; None where it traces no device event, as after the
    mesh phases in one process), the least time its bytes take (key, counter and
    output, each once, over 3.35 TB/s), and the host us of a call of
    rng_fast._uniforms beside the ATen chain's (raw_bits + bits_to_unit on
    the card, the parent's route)."""
    import torch
    from gphocs_tpu_torch import rng_fast as RF
    from gphocs_tpu_torch.tools import kernel_times as KT

    f32 = torch.float32
    out = {}
    for name, lanes, n in (("theta_batch", 1, 21), ("lanes_1000x3", 1000, 3)):
        st = RF.init_fast(lanes, 5, dev)
        st = st._replace(ctr=st.ctr + 12345)
        pos = torch.arange(n, dtype=torch.int64, device=dev)

        def kernel():
            return RF._uniforms(st, 1, n, f32)

        def chain():
            return RF.bits_to_unit(
                RF.raw_bits(st.key[:, None], st.ctr + 1 + pos), f32)

        try:
            us = KT._profiled(kernel, "counter_draw_kernel", 20)[0] * 1e3
        except RuntimeError as e:  # the profiler traced no device event
            log(f"  {name}: device time not measured ({e})")
            us = None
        nbytes = lanes * 8 + 8 + lanes * n * 4
        out[name] = {"device_us": us,
                     "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
                     "bytes": nbytes,
                     "host_us_kernel": KT._host_us(kernel, 200),
                     "host_us_aten_chain": KT._host_us(chain, 200)}
    return out


def counter_draw_phase(tmp, card, parent=None):
    """Phase 14: (14a) the draw kernel's outputs bitwise equal to the ATen
    chain on the card (the parent's route), and its uniforms and counters
    to the CPU's (normals within 16 ulp: the card's libm), for every
    layout of draw_streams, f32 and f64, the counters low and wrapping,
    DRAW_BATCHES launches each; (14b)
    sample_1k's data at f64 (seed DRAW_SEED, as benchmark/harness.py sets
    the cell up): one chunk of DRAW_ITERS iterations in a process of this
    checkout (`--chunk-rows`) and, with `parent` (a checkout of the parent
    commit), of the parent, rows and counters bitwise equal; then
    DRAW_ITERS card iterations each held against one CPU iteration
    (fast_vs_cpu), DRAW_PER_ITERATION draw launches an iteration, their
    rows bitwise equal to the chunk's; with `parent` the same again with
    the card's draws on the ATen chain (aten_route, the parent's route),
    whose largest difference from the CPU must equal the kernel's route's
    bit for bit: the drift is the sweeps', not the draws'.  Returns a
    record."""
    import torch

    dev = torch.device("cuda")
    from gphocs_tpu_torch.ops import sweeps

    t0 = time.perf_counter()
    log(" -- 14a: the kernel's uniforms against the ATen chain on the CPU "
        "and on the card")
    worst_normal = 0.0
    for layout in DRAW_LAYOUTS:
        for wrap in (False, True):
            for dt in (torch.float32, torch.float64):
                cpu = draw_outputs(*draw_streams(layout, wrap, "cpu"), dt)
                sweeps.reset_launch_counts()
                chain = aten_route(draw_outputs,
                                   *draw_streams(layout, wrap, dev), dt)
                check(sweeps.LAUNCHES["rng_draw"] == 0, "the ATen route "
                      "launched the draw kernel")
                got = draw_outputs(*draw_streams(layout, wrap, dev), dt)
                torch.cuda.synchronize()
                what = f"14a {layout} {'wrap' if wrap else 'low'} {dt}"
                check(sweeps.LAUNCHES["rng_draw"] == DRAW_BATCHES,
                      f"{what}: {sweeps.LAUNCHES['rng_draw']} launches")
                check(list(got) == list(cpu) == list(chain), what)
                for k, b in got.items():
                    a = cpu[k]
                    check(b.is_cuda and a.dtype == b.dtype
                          and a.shape == b.shape, f"{what}: {k}")
                    check(torch.equal(chain[k], b),
                          f"{what}: {k} differs from the card's ATen chain")
                    if "normal" not in k or ".ctr" in k:
                        check(torch.equal(a, b.cpu()),
                              f"{what}: {k} differs from the CPU's")
                    else:  # the card's log and cos against the CPU's
                        d = float(((a - b.cpu()).abs()
                                   / a.abs().clamp(min=1.0)).max())
                        worst_normal = max(worst_normal, d)
                        check(d <= 16 * torch.finfo(dt).eps,
                              f"{what}: {k} {d:.2e} from the CPU's")
    log(f"  {len(DRAW_LAYOUTS) * 4} cases, {DRAW_BATCHES} launches each: "
        "every output bitwise equal to the ATen chain on the card; "
        "uniforms and counters bitwise equal to the CPU's, normals within "
        f"{worst_normal:.2e} relative (the card's libm) "
        f"({time.perf_counter() - t0:.1f} s)")
    times = draw_times(dev)
    for k, v in times.items():
        log(f"  {k}: {v}")

    log(f" -- 14b: sample_1k at f64 (seed {DRAW_SEED}): one chunk of "
        f"{DRAW_ITERS} by this checkout and by the parent, then {DRAW_ITERS} "
        "card iterations each against one CPU iteration")
    data = os.path.join(tmp, "sample_1k.txt")
    sample_1k_data(data, DRAW_SEED)
    roots = {"change": ROOT}
    if parent:
        roots["parent"] = os.path.abspath(parent)
    got = {}
    for name, root in roots.items():
        out = os.path.join(tmp, f"rows_{name}.pt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--chunk-rows", root, data, str(DRAW_SEED), out],
            capture_output=True, text=True, timeout=900, cwd=root)
        check(proc.returncode == 0, f"14b {name}'s chunk failed:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        got[name] = torch.load(out)
        log(f"  {name}'s chunk of {DRAW_ITERS} in a process of its own "
            f"({time.perf_counter() - t0:.1f} s)")
    if parent:
        for f in got["change"]["rows"]:
            check(torch.equal(got["parent"]["rows"][f],
                              got["change"]["rows"][f]),
                  f"14b: trace {f} differs from the parent's")
        for k in ("lrng_ctr", "grng_ctr"):
            check(torch.equal(got["parent"][k], got["change"][k]),
                  f"14b: {k} differs from the parent's")
        log(f"  trace rows and counters bitwise equal to the parent's "
            f"({parent})")
    else:
        log("  no parent checkout given (--parent DIR): not compared")
    t0 = time.perf_counter()
    card_s = sample_1k_sampler(data, "cuda", torch.float64, DRAW_SEED)
    cpu_s = sample_1k_sampler(data, "cpu", torch.float64, DRAW_SEED)
    rows, worst = fast_vs_cpu(card_s, cpu_s, DRAW_ITERS)
    log(f"  each iteration equal to the CPU's (accepts, counters, integers),"
        f" reals within {worst!r} of each field's largest; "
        f"{DRAW_PER_ITERATION} draw launches an iteration "
        f"({time.perf_counter() - t0:.1f} s)")
    worst_aten = None
    if parent:
        t0 = time.perf_counter()
        card_a = sample_1k_sampler(data, "cuda", torch.float64, DRAW_SEED)
        cpu_a = sample_1k_sampler(data, "cpu", torch.float64, DRAW_SEED)
        rows_a, worst_aten = aten_route(
            lambda: fast_vs_cpu(card_a, cpu_a, DRAW_ITERS, draws=0))
        check(worst_aten == worst, f"14b: the ATen route's drift "
              f"{worst_aten!r} is not the kernel route's {worst!r}")
        for f in rows._fields:
            check(torch.equal(getattr(rows_a, f), getattr(rows, f)),
                  f"14b: trace {f} of the ATen route differs")
        log(f"  the same with the card's draws on the ATen chain: reals "
            f"within {worst_aten!r}, the same rows "
            f"({time.perf_counter() - t0:.1f} s)")
    for f in rows._fields:
        check(torch.equal(got["change"]["rows"][f], getattr(rows, f).cpu()),
              f"14b: trace {f} of one chunk differs from the iterations'")
    check(torch.equal(got["change"]["lrng_ctr"], card_s.lrng.ctr.cpu()),
          "14b: counters of one chunk differ")
    return {"layouts": len(DRAW_LAYOUTS) * 4, "f64_iterations": DRAW_ITERS,
            "times": times,
            "worst_rel_vs_cpu": worst, "worst_rel_vs_cpu_aten": worst_aten,
            "draws_per_iteration": DRAW_PER_ITERATION,
            "parent_bitwise": bool(parent), "card": card}


def main(parent=None):
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
    log("== phase 3d: the plans within the static reserve below 48 KiB")
    smem_window_phase(tmp, dev)

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
            "smem_bytes_per_block": plan.smem_bytes,
            "static_smem_bytes": plan.static_bytes}
        log(f"  {name:24s} wrapper call {k1:.3f} / {k2:.3f} ms   launch "
            f"alone {d1:.4f} ms   plain {p1:.3f} ms   {ops} device "
            f"operations besides the kernel   "
            f"{times[name]['loci_per_block']} loci per block, "
            f"{times[name]['smem_bytes_per_block']} B of dynamic shared "
            "memory")

    for name, fns in pairs.items():
        time_pair(name, *fns)
    # the migration-age kernel read three ways, on three states: that of
    # tools/kernel_times.py (5 iterations from the initialization), this
    # path's, and (phase 4c) this path's made hot
    from gphocs_tpu_torch.sampler.driver import Sampler

    cfg = parse_control_text(SAMPLE_CTL)
    cfg.mcmc.random_seed = 111
    cfg.mcmc.start_mig = 0
    kt = Sampler(cfg, seq_path=data, dtype=torch.float32, device="cuda")
    kt.initialize()
    kt.step_chunk(5, do_migrate=True)
    mig_reads = {"kernel_times": mig_age_readings(kt, "kernel_times.py")}
    del kt
    mig_reads["standard"] = mig_age_readings(s, "standard path's")
    spr_draws = int(pairs["spr"][0]()[1].ctr) - int(s.lrng.ctr)
    prop = pairs["rubber_band"][0]()
    bounds = {k: bound(*v) + v
              for k, v in op_models(s, spr_draws, prop[:2]).items()}

    log("== phase 4c: the main path's sampler with a hot band "
        f"({WORKLOAD_LOCI} loci, f32, then cast to f64)")
    heat(s)
    log(f"  {int((s.gen.mig_branch >= 0).sum())} migrations present")
    mig_reads["hot"] = mig_age_readings(s, "hot")
    times["mig_age"]["readings"] = mig_reads
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
    log(f"== phase 8: the admixed path ({WORKLOAD_LOCI} loci x "
        f"{WORKLOAD_BP} bp of the standard workload, ADMIX_CTL, f32)")
    t_phase = time.perf_counter()
    paths["admixture"], launches, admix_ops = admix_phase(
        tmp, data, card, cmp, times, bounds)
    all_launches.append(launches)
    log(f"  device operations per iteration: admixed {admix_ops}, standard "
        f"{chain_read['ops_per_iteration']['1']} (phase 7)")
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    log(f"== phase 9: the loci mesh ({WORKLOAD_LOCI} loci x {WORKLOAD_BP} bp "
        "of the standard workload)")
    t_phase = time.perf_counter()
    mesh_launches, mesh_rec = mesh_phase(tmp, data, card)
    paths["mesh"] = mesh_rec["nccl1"]["it_per_s"]
    all_launches.append(mesh_launches)
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    log("== phase 10: the conformance mode (legacy RNG) on the card")
    t_phase = time.perf_counter()
    legacy_launches, legacy_rec = legacy_phase(tmp, data, card)
    paths["legacy"] = legacy_rec["f32"]["it_per_s"]
    all_launches.append(legacy_launches)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    log("== phase 11: the legacy RNG with chains on the card")
    t_phase = time.perf_counter()
    lc_launches, lc_rec = legacy_chains_phase(tmp, data, card)
    paths[f"legacy_chains{LEGACY_BIG_CHAINS}"] = lc_rec["it_per_s"]
    all_launches.append(lc_launches)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    log("== phase 12: chains on the loci mesh")
    t_phase = time.perf_counter()
    mc_launches, mc_rec = mesh_chains_phase(tmp, data, card)
    paths["mesh_chains"] = mc_rec["nccl1"]["it_per_s"]
    all_launches.append(mc_launches)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    log("== phase 13: the legacy RNG on the loci mesh")
    t_phase = time.perf_counter()
    lm_launches, lm_rec = legacy_mesh_phase(tmp, data, card)
    its = lm_rec["nccl1"]["c1"]["it_per_s"]
    paths["legacy_mesh"] = sum(its) / len(its)
    all_launches.append(lm_launches)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

    log("== phase 14: the counter streams' draw kernel")
    t_phase = time.perf_counter()
    draw_rec = counter_draw_phase(tmp, card, parent)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")

    src = {"node_age": ("node_age.cu", "gphocs_tpu/ops/sweeps_pallas.py:215"),
           "mig_age": ("mig_age.cu", "gphocs_tpu/ops/sweeps_pallas.py:588"),
           "rubber_band": ("rubber_band.cu",
                           "gphocs_tpu/ops/sweeps_pallas.py:891"),
           "rubber_band_sample_age": (
               "rubber_band.cu", "gphocs_tpu/ops/sweeps_pallas.py:891"),
           "spr": ("spr.cu", "gphocs_tpu/ops/sweeps_pallas.py:1413"),
           # SPR's admixed mode: the Pallas SPR leaves admixture out, so
           # its semantics are those of gphocs_tpu/kernels/spr.py:504-531
           "spr_admix": ("spr.cu", "gphocs_tpu/ops/sweeps_pallas.py:1413")}
    kernels = []
    for n in src:
        if n == "spr_admix":  # the admixed path's SPR launches
            by_path = {"admixture": launches["spr"]}
        else:
            by_path = dict(zip(paths, (la[n] for la in all_launches)))
        check(sum(by_path.values()) > 0, f"{n}: never launched on a path")
        b_ms, b_by, nbytes, nops = bounds[n]
        kernels.append({
            "name": n, "route": "cuda",
            "source": f"gphocs_tpu_torch/csrc/{src[n][0]}",
            "replaces": src[n][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": cmp.err[n],
            **times[n], f"ms_chains{CHAINS}": chain_ms.get(n),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "bound_operations": nops, "library_ms": None})
        log(f"  {n:24s} {times[n]['ms']:.3f} ms; bound {b_ms * 1e3:.2f} us by "
            f"{b_by} ({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} Mop)")
    shutil.rmtree(tmp, ignore_errors=True)
    for label, its in paths.items():
        if label in ragged or label in (
                f"chains{CHAINS}", "mesh", "legacy",
                f"legacy_chains{LEGACY_BIG_CHAINS}", "mesh_chains",
                "legacy_mesh"):
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
    log(json.dumps({"path": "mesh", "it_per_s": paths["mesh"],
                    **mesh_rec, "card": card}))
    log(json.dumps({"path": "legacy", "it_per_s": paths["legacy"],
                    **legacy_rec, "card": card}))
    log(json.dumps({"path": f"legacy_chains{LEGACY_BIG_CHAINS}", **lc_rec,
                    "card": card}))
    log(json.dumps({"path": "mesh_chains", "it_per_s": paths["mesh_chains"],
                    **mc_rec, "card": card}))
    log(json.dumps({"path": "legacy_mesh", "it_per_s": paths["legacy_mesh"],
                    **lm_rec, "card": card}))
    log(json.dumps({"phase": "counter_draw", **draw_rec}))
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase 9b, 12b or 13b
        sys.path.insert(0, ROOT)
        sys.exit(mesh_rank(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--chunk-rows"]:  # a checkout's chunk of phase 14b
        sys.exit(chunk_rows(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--parent"]:
        sys.exit(main(parent=sys.argv[2]))
    sys.exit(main())
