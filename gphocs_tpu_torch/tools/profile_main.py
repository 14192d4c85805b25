"""Time and profile the port's main path on one CUDA card.

    python -m gphocs_tpu_torch.tools.profile_main [--loci 1000] [--bp 1000]
        [--iters 25] [--rounds 2] [--profile-iters 5] [--trace PATH]
        [--paths | --roots DIR [DIR ...]]

On the standard workload (SAMPLE_CTL, data simulated with seed 20260817)
it builds one f32 and one f64 Sampler, warms each for 5 iterations, and
times step_chunk(iters) on them in turns, f32 f64 f64 f32, `rounds` times,
so that drift in the host's speed falls on both dtypes alike.  Every
reading is printed, and so is the card's name and power limit.

Then it runs `--profile-iters` f32 iterations under torch.profiler and
prints the wall time, the device's busy time (the union of the device
kernels' time ranges), the idle share 1 - busy / wall, the count and
host time of cudaLaunchKernel, and the top ops by device and by host
time.  The profiler's own overhead is inside that wall time.  `--trace`
writes the Chrome trace.

With `--paths` it compares configurations instead of dtypes, all at f32:
the standard workload (SAMPLE_CTL), the ancient-sample path
(SAMPLE_AGE_CTL) and the same with VAR locus rates (SAMPLE_AGE_VAR_CTL) on
the same data, the ragged workload (config/samples.py RAGGED_*) in 4
pattern buckets and dense, and the standard workload as 4 chains side by
side (its it/s is iterations of all four: chain-it/s is 4x), timed in
turns (a b c d e e d c b a, `rounds`
times); then each is profiled for `--profile-iters` iterations, so that
the launches and the wall time that each path adds per iteration can be
read off.

With `--roots` it runs `python -m gphocs_tpu_torch.tools.profile_main`
(the f32/f64 mode, `rounds` rounds) once per directory, in a process of
its own with that directory first on the module path and as the working
directory, in turns (A B B A for two), so that the standard path of two
checkouts (say, this commit and its parent unpacked from `git archive`)
is timed and profiled within one run on one card; each checkout runs its
own copy of this tool and builds its own kernels under its own build/.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _sampler(path, dtype, ctl=None, buckets=1, chains=1):
    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import SAMPLE_CTL
    from gphocs_tpu_torch.sampler.driver import Sampler

    cfg = parse_control_text(ctl or SAMPLE_CTL)
    cfg.mcmc.random_seed = 111
    cfg.mcmc.start_mig = 0
    s = Sampler(cfg, seq_path=path, dtype=dtype, device="cuda",
                buckets=buckets, chains=chains)
    s.initialize()
    s.step_chunk(5, do_migrate=True)
    torch.cuda.synchronize()
    return s


def _its(s, iters) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.step_chunk(iters, do_migrate=True)
    torch.cuda.synchronize()
    return iters / (time.perf_counter() - t0)


def _busy_ms(events) -> float:
    """Union of the device kernels' time ranges, in ms.  (Summing the ops'
    self device time would count each kernel twice: once under its aten
    op and once under its own name.)"""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _profile(s, label, iters, card, tables=True, trace=None):
    """Run `iters` iterations of sampler s under torch.profiler and print
    the wall time, busy time, idle share and launch count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.step_chunk(iters, do_migrate=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    busy_ms = _busy_ms(prof.events())
    launch = [e for e in ka if e.key == "cudaLaunchKernel"]
    n_launch = launch[0].count if launch else 0
    launch_ms = launch[0].cpu_time_total / 1e3 if launch else 0.0
    print(f"profiled {label}: {iters} iterations in {wall_ms:.1f} ms "
          f"(profiler on); device busy {busy_ms:.1f} ms; idle share "
          f"{1 - busy_ms / wall_ms:.3f}; cudaLaunchKernel x{n_launch} "
          f"({n_launch / iters:.0f} per iteration) taking "
          f"{launch_ms:.1f} ms of host time; on {card}", flush=True)
    if tables:
        print(ka.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=25,
                       max_name_column_width=60))
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loci", type=int, default=1000)
    ap.add_argument("--bp", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile-iters", type=int, default=5)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--paths", action="store_true",
                    help="compare the standard, sample-age, sample-age + "
                         "VAR, ragged (bucketed, dense) and 4-chain paths "
                         "at f32 instead of f32/f64")
    ap.add_argument("--roots", nargs="+", default=None,
                    help="time the standard path of each checkout in a "
                         "process of its own, in turns")
    a = ap.parse_args(argv)
    if a.roots:
        child = [sys.executable, "-m", "gphocs_tpu_torch.tools.profile_main",
                 "--loci", str(a.loci), "--bp", str(a.bp), "--iters",
                 str(a.iters), "--rounds", str(a.rounds), "--profile-iters",
                 str(a.profile_iters)]
        roots = [os.path.abspath(r) for r in a.roots]
        for root in roots + roots[::-1]:
            print(f"== {root}", flush=True)
            rc = subprocess.run(child, cwd=root, timeout=1800,
                                env=dict(os.environ, PYTHONPATH=root)
                                ).returncode
            if rc:
                return rc
        return 0

    import torch
    from gphocs_tpu_torch.config import parse_control_text
    from gphocs_tpu_torch.config.samples import (SAMPLE_AGE_CTL,
                                                 SAMPLE_AGE_VAR_CTL,
                                                 SAMPLE_CTL)
    from gphocs_tpu_torch.io.simulate import (simulate_ragged_file,
                                              simulate_seq_file)
    from gphocs_tpu_torch.model import build_poptree

    if not torch.cuda.is_available():
        print("profile_main: no CUDA device")
        return 1
    card = _card()
    print(f"card: {card}  torch {torch.__version__}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workload.txt")
        cfg = parse_control_text(SAMPLE_CTL)
        simulate_seq_file(cfg, build_poptree(cfg), path, num_loci=a.loci,
                          seq_len=a.bp, seed=20260817)
        if a.paths:
            ragged = os.path.join(tmp, "ragged.txt")
            simulate_ragged_file(ragged)
            samplers = {
                name: _sampler(data, torch.float32, ctl, buckets, chains)
                for name, ctl, data, buckets, chains in (
                    ("standard", SAMPLE_CTL, path, 1, 1),
                    ("sample_age", SAMPLE_AGE_CTL, path, 1, 1),
                    ("sample_age_var", SAMPLE_AGE_VAR_CTL, path, 1, 1),
                    ("ragged_buckets", SAMPLE_CTL, ragged, 4, 1),
                    ("ragged_dense", SAMPLE_CTL, ragged, 1, 1),
                    ("chains4", SAMPLE_CTL, path, 1, 4))}
            order = list(samplers) + list(samplers)[::-1]
        else:
            samplers = {"f32": _sampler(path, torch.float32),
                        "f64": _sampler(path, torch.float64)}
            order = ["f32", "f64", "f64", "f32"]

    readings = {name: [] for name in samplers}
    for _ in range(a.rounds):
        for name in order:
            r = _its(samplers[name], a.iters)
            readings[name].append(r)
            print(f"{name} step_chunk({a.iters}): {r:.3f} it/s", flush=True)
    for name, rs in readings.items():
        print(f"{name}: readings {[round(r, 3) for r in rs]} it/s, "
              f"median {sorted(rs)[len(rs) // 2]:.3f}, on {card}")

    if a.paths:
        for name, s in samplers.items():
            last = name == order[-1 - len(samplers)]
            _profile(s, name, a.profile_iters, card, tables=last,
                     trace=a.trace if last else None)
    else:
        _profile(samplers["f32"], "f32", a.profile_iters, card,
                 trace=a.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
