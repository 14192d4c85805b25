"""Per-family timing of the iteration: the analogue of the reference's
method timers (RECORD_METHOD_TIMES, src/MultiCoreUtils.h:30 and
src/utils.c:233-326, printMethodTimes), twin of gphocs_tpu/profiling.py.

`kernel_times(sampler, reps)` times each update family in isolation on
the sampler's current state and returns {family: seconds per call}.  The
families are gphocs_tpu's: pruning (a full rebuild of the conditionals
and the data likelihood), full_stats, node_age, spr, theta, tau, mixing
and, where the model has migration bands, mig_age.  Each calls what the
port's iteration calls (sampler/bucketed.py), over every pattern bucket:
the kernel wrappers of ops/sweeps.py in the fast mode (the kernels on
CUDA tensors, their plain versions on CPU tensors), the plain sweeps
(ops/sweeps.*_plain) in the legacy mode.  On a CUDA device a family is
timed with CUDA events around `reps` calls after one warm call; on the
CPU by the wall clock.

Timing leaves the chain alone: every call takes the state's tensors and
returns new ones, which are dropped, and the launch counts of
ops/sweeps.LAUNCHES and PLANS are put back as they were.  On a loci mesh
each rank times its own loci, without collectives.

`span(name)` marks where the same families run inside the iteration
(sampler/bucketed.py, the kernel wrappers' argument blocks in
ops/sweeps.py, the counter RNG's hash in rng_fast.py): while a
torch.profiler runs, a range named "gphocs.<name>" among the trace's host
events, on the clock the device's operations share; otherwise nothing.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable, Dict

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range "gphocs.<name>" while a profiler
    runs, else the one shared null context: off, a span costs one check of
    the profiler's state and keeps nothing.

    The range is an operator-like host event (_RecordFunctionFast), not
    torch.profiler.record_function's user annotation: on CUDA the profiler
    mirrors each annotation onto the device's timeline as an event as long
    as the range, which a trace's device time would count as busy."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast("gphocs." + name)
    return _OFF


def _families(s) -> Dict[str, Callable[[], object]]:
    """The families' calls on sampler s's current state."""
    from gphocs_tpu_torch.kernels.common import full_stats
    from gphocs_tpu_torch.kernels.mixing import update_mixing_buckets
    from gphocs_tpu_torch.kernels.scalar_params import update_thetas
    from gphocs_tpu_torch.kernels.tau import update_taus_buckets
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.ops.coalstats import CoalStats
    from gphocs_tpu_torch.ops.likelihood_cache import full_rebuild_and_lnld

    legacy = s.rng_mode == "legacy"
    node_age = sweeps.node_age_sweep_plain if legacy else sweeps.node_age_sweep
    mig_age = sweeps.mig_age_sweep_plain if legacy else sweeps.mig_age_sweep
    spr = sweeps.spr_sweep_plain if legacy else sweeps.spr_sweep
    ft, ctx, tree = s.ft, s.ctx, s.tree
    buckets = list(zip(s.gens, s.seqs, s.lrngs, s.lnlds, s.lnps, s.conds))
    stats_list = [full_stats(g, s.params, ctx) for g in s.gens]
    stats = CoalStats(*(torch.cat(f) for f in zip(*stats_list)))
    lnp = torch.cat(list(s.lnps))

    def each(fn):
        return lambda: [fn(*b) for b in buckets]

    cases = {
        "pruning": each(lambda g, sq, *_: full_rebuild_and_lnld(g, sq)),
        "full_stats": each(lambda g, *_: full_stats(g, s.params, ctx)),
        "node_age": each(lambda g, sq, r, ld, lp, c: node_age(
            g, s.params, sq, r, ctx, ft.coal_time, ld, lp, c)),
        "spr": each(lambda g, sq, r, ld, lp, c: spr(
            g, s.params, sq, r, ctx, ld, c)),
        "theta": lambda: update_thetas(s.gens[0], s.params, s.grng, ctx,
                                       ft.theta, lnp, stats),
        "tau": lambda: update_taus_buckets(
            s.gens, s.params, s.seqs, s.grng, ctx, ft.taus, s.lnlds, s.lnps,
            s.conds, tree.num_pops, tree.num_cur_pops),
        "mixing": lambda: update_mixing_buckets(
            s.gens, s.params, s.seqs, s.grng, ctx, ft.mixing, s.lnlds,
            s.lnps, s.conds, stats_list, tree.num_cur_pops),
    }
    if ctx.num_bands > 0:
        cases["mig_age"] = each(lambda g, sq, r, ld, lp, c: mig_age(
            g, s.params, r, ctx, ft.mig_time, lp))
    return cases


def _seconds(fn, reps: int, device: torch.device) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def kernel_times(sampler, reps: int = 3) -> Dict[str, float]:
    """Seconds per call of each family on the sampler's current state (the
    module's docstring)."""
    from gphocs_tpu_torch.ops import sweeps

    launches = dict(sweeps.LAUNCHES)
    plans = {k: dict(v) for k, v in sweeps.PLANS.items()}
    try:
        return {name: _seconds(fn, reps, sampler.device)
                for name, fn in _families(sampler).items()}
    finally:
        sweeps.LAUNCHES.update(launches)
        for k, v in plans.items():
            sweeps.PLANS[k].update(v)


def print_kernel_times(sampler, reps: int = 3):
    """Print each family's time to stderr, slowest first, with its share
    of the total; returns the times."""
    times = kernel_times(sampler, reps)
    total = sum(times.values())
    for name, t in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"{name:<12} {t * 1e3:9.2f} ms  {100 * t / total:5.1f}%",
              file=sys.stderr)
    return times
