"""Time the four sweep wrappers of one or two checkouts on one CUDA card.

    python gphocs_tpu_torch/tools/kernel_times.py [--loci 1000] [--bp 1000]
        [--reps 20] [--roots DIR [DIR ...]]

Without --roots it measures the package it finds on sys.path (run it from
the root of a checkout).  On the standard workload (SAMPLE_CTL, data
simulated with seed 20260817, f32, the sampler warmed for 5 iterations) it
reports for each wrapper of ops/sweeps.py (node age, migration age, the
rubber band in tau mode on the root population, SPR):

  ms           CUDA events around `reps` wrapper calls (best of two runs):
               the stream time of a call, host work of the wrapper included;
  kernel_ms    the hand-written kernel's own device time per launch, from
               torch.profiler (device events whose name holds the kernel's);
  device_ops   device operations (kernels, copies, fills) of one wrapper
               call besides that kernel, from the same profile, and
               `other_ops`, their names with their counts over the calls;
  host_us      the host's time for one wrapper call, by its own clock over
               `reps` calls with the device drained before and after (the
               device keeps up, so this is what the call costs a host-bound
               iteration), and of that `prepare_us`, the checks, the
               argument struct and the output allocations
               (ops/sweeps.prepare_*), and `launch_us`, the ctypes call
               that launches the kernel; the rest is the wrapper's tensor
               operations after the launch;

and prints one JSON line with them, the card's name and its power limit.

With --roots it runs itself once per directory in a process of its own,
with that directory first on the module path and as the working directory,
in turns (A B B A for two), so that two checkouts (say, this commit and
its parent unpacked from `git archive`) are timed within one run on one
card; each checkout builds its own kernels under its own build/.  It
uses only what the wrappers had from the start of the port: their names,
arguments and results; the split of host_us also needs ops/sweeps.prepare_*
and is left out for a checkout without them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

KERNELS = {"node_age": "node_age_kernel", "mig_age": "mig_age_kernel",
           "rubber_band": "rubber_band_kernel", "spr": "spr_kernel"}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _host_us(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _profiled(fn, kernel: str, reps: int):
    """(the kernel's device ms per launch, other device operations per
    call, their names and counts) over `reps` calls of fn under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in dev if kernel in e.name]
    # the profiler now and then drops an event: divide by what it kept
    if not 0 < len(mine) <= reps:
        raise RuntimeError(f"{kernel}: {len(mine)} launches in the profile, "
                           f"{reps} calls")
    us = sum(e.time_range.end - e.time_range.start for e in mine)
    names = {}
    for e in dev:
        if kernel not in e.name:
            short = e.name.split("(")[0].split("<")[0][-60:]
            names[short] = names.get(short, 0) + 1
    return (us / 1e3 / len(mine), (len(dev) - len(mine)) / len(mine),
            names)


def measure(loci: int, bp: int, reps: int) -> dict:
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.io.simulate import simulate_seq_file
    from gphocs_tpu_torch.model import build_poptree
    from gphocs_tpu_torch.ops import sweeps
    from gphocs_tpu_torch.sampler.driver import Sampler

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workload.txt")
        cfg = parse_control_text(SAMPLE_CTL)
        simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=loci,
                          seq_len=bp, seed=20260817)
        cfg = parse_control_text(SAMPLE_CTL)
        cfg.mcmc.random_seed = 111
        cfg.mcmc.start_mig = 0
        s = Sampler(cfg, seq_path=path, dtype=torch.float32, device="cuda")
    s.initialize()
    s.step_chunk(5, do_migrate=True)
    torch.cuda.synchronize()

    g, pr, sq, c = s.gen, s.params, s.seq, s.ctx
    pop = s.tree.num_pops - 1            # the root population's tau
    s0, s1 = c.pop_sons[pop, 0], c.pop_sons[pop, 1]
    taub0 = torch.maximum(torch.maximum(pr.tau[s0], pr.tau[s1]),
                          torch.maximum(pr.sample_age[s0],
                                        pr.sample_age[s1]))
    taub1 = torch.full_like(taub0, c.oldage)
    tauold = pr.tau[pop]
    taunew = tauold + 0.3 * (tauold - taub0)
    calls = {
        "node_age": lambda: sweeps.node_age_sweep(
            g, pr, sq, s.lrng, c, s.ft.coal_time, s.lnld, s.lnp, s.cond),
        "mig_age": lambda: sweeps.mig_age_sweep(
            g, pr, s.lrng, c, s.ft.mig_time, s.lnp),
        "rubber_band": lambda: sweeps.rubber_band_eval(
            g, pr, sq, c, pop, False, taub0, taub1, tauold, taunew, s.cond),
        "spr": lambda: sweeps.spr_sweep(g, pr, sq, s.lrng, c, s.lnld,
                                        s.cond),
    }
    prepares = {
        "node_age": lambda: sweeps.prepare_node_age(
            g, pr, sq, s.lrng, c, s.ft.coal_time, s.lnld, s.lnp, s.cond),
        "mig_age": lambda: sweeps.prepare_mig_age(
            g, pr, s.lrng, c, s.ft.mig_time, s.lnp),
        "rubber_band": lambda: sweeps.prepare_rubber_band(
            g, pr, sq, c, pop, False, taub0, taub1, tauold, taunew, s.cond),
        "spr": lambda: sweeps.prepare_spr(g, pr, sq, s.lrng, c, s.lnld,
                                          s.cond),
    }
    dev = s.cond.device
    out = {}
    for name, fn in calls.items():
        ms = min(_events_ms(fn, reps), _events_ms(fn, reps))
        kernel_ms, ops, names = _profiled(fn, KERNELS[name], reps)
        out[name] = {"ms": ms, "kernel_ms": kernel_ms, "device_ops": ops,
                     "other_ops": names,
                     "host_us": min(_host_us(fn, reps), _host_us(fn, reps))}
        if hasattr(sweeps, "prepare_" + name):
            prep = prepares[name]
            p = prep()
            out[name]["prepare_us"] = min(_host_us(prep, reps),
                                          _host_us(prep, reps))
            out[name]["launch_us"] = min(
                _host_us(lambda: p.launch(dev), reps),
                _host_us(lambda: p.launch(dev), reps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loci", type=int, default=1000)
    ap.add_argument("--bp", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--roots", nargs="+", default=None,
                    help="checkouts to time in turns, each in its own "
                         "process")
    a = ap.parse_args(argv)

    if a.roots:
        roots = [os.path.abspath(r) for r in a.roots]
        for root in roots + roots[::-1]:
            env = dict(os.environ, PYTHONPATH=root)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--loci",
                 str(a.loci), "--bp", str(a.bp), "--reps", str(a.reps)],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr)
                return proc.returncode
            print(proc.stdout.strip().splitlines()[-1], flush=True)
        return 0

    # the package of the working directory (or of PYTHONPATH), not the one
    # this file lies in
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device")
        return 1
    import gphocs_tpu_torch

    res = measure(a.loci, a.bp, a.reps)
    print(json.dumps({
        "root": os.path.dirname(os.path.dirname(
            os.path.abspath(gphocs_tpu_torch.__file__))),
        "card": _card(), "loci": a.loci, "bp": a.bp, "dtype": "float32",
        "wrappers": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
