"""One run of one cell of the benchmark (run.py is the command).

A cell is a configuration (configs/<name>.json: the control file, the
loci, their length or the range it is drawn from, the dtype, the limits of
`correct`) under a traffic mix (traffic/<name>.json: chains, iterations
per chunk, warm-up and traced chunks); both are found by the names in
BENCHMARK.json, and so is each per-layer metric's reader (metrics/<name>.py,
a `read(ctx)` that returns a number or None).  Either file may hold a
`sampler` object of further keyword arguments of the program's Sampler
(rng_mode, buckets, legacy_rng, loci_multiple; the traffic's win), so a
cell on another route of the program is a new file.  A run:

 1. simulates the sequence file from the seed (datagen.py) under TMPDIR;
 2. set-up, timed as `setup_s` from just before the program is first
    imported: the kernels' library, `Sampler(cfg, seq_path=...)` (the
    ingest span), `initialize()` (the init span), then the warm-up as
    `Sampler.run` starts a chain with start-mig 0: one iteration without
    migration, the migration rates drawn, then the warm-up chunks;
 3. with --trace 0, the window: chunks of `Sampler.step_chunk(chunk,
    do_migrate=True)`, each chunk's trace and totals copied to the host,
    until --seconds have passed; `chain_it_per_s` is chains x iterations
    over the window's wall time, ending in a synchronize;
    with --trace 1, the traced chunks under torch.profiler instead, read
    by the per-layer metrics;
 4. reads the device's peak memory, hands the program's final state to
    the plain reference (reference/judge.py) once the program is freed,
    and decides `correct`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gphocs_tpu")
C_REFERENCE_IT_S = 67  # the serial C program, CPU, BASELINE_MEASURED.json


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_info() -> dict:
    import torch

    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        info["power_limit"] = out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def chain_seed(seed: int, chains: int) -> int:
    """The program's random-seed for chain 0 (chain c takes + 7919 c): the
    run's seed folded into 31 bits with room for the chains."""
    return seed % (2 ** 31 - 1 - 7919 * chains)


def loci_rows(s, per_bucket):
    """A per-locus field of the sampler (one tensor per pattern bucket) as
    one numpy array of every chain's loci in the data's order, chain-major,
    with the padding loci left out."""
    import numpy as np

    parts = [t.detach().cpu().numpy() for t in per_bucket]
    if s.bucket_perm is not None:   # one chain; each bucket padded at its end
        x = np.concatenate([p[:len(p) - pad]
                            for p, pad in zip(parts, s.bucket_pads)])
        return x[np.argsort(s.bucket_perm)]
    x = parts[0].reshape(s.chains, -1, *parts[0].shape[1:])
    return x[:, :x.shape[1] - s.pad_loci].reshape(-1, *x.shape[2:])


def chain_params(s) -> dict:
    """Each chain's theta, tau, migration rates and sample ages, [C, -]."""
    import numpy as np

    out = {}
    for f in ("theta", "tau", "mig_rate", "sample_age"):
        x = getattr(s.params, f)
        out[f] = (np.zeros((s.chains, 0)) if x is None
                  else x.detach().cpu().numpy().reshape(s.chains, -1))
    return out


def window_start(s) -> dict:
    """What the window has to move, as it stands when the window opens:
    every locus's ages, migration ages and topology, every chain's
    parameters (reference/judge.py: unmoved, kept_topology,
    frozen_params)."""
    snap = {f + "0": loci_rows(s, [getattr(g, f) for g in s.gens])
            for f in ("age", "mig_age", "father")}
    snap.update({f + "0": x for f, x in chain_params(s).items()})
    return snap


def program_state(s, start, last_row) -> dict:
    """The program's outputs that the reference judges, as numpy arrays."""
    import numpy as np

    prog = {f: loci_rows(s, [getattr(g, f) for g in s.gens])
            for f in s.gens[0]._fields}
    prog.update(chain_params(s))
    C = s.chains
    prog["lnld"], prog["lnp"] = loci_rows(s, s.lnlds), loci_rows(s, s.lnps)
    prog["lnld_sum"] = np.asarray(last_row[0], np.float64).reshape(C)
    prog["lnp_sum"] = np.asarray(last_row[1], np.float64).reshape(C)
    prog.update(start)
    return prog


def sampler_options(config: dict, traffic: dict) -> dict:
    """Sampler keyword arguments beyond the chains: the configuration's
    `sampler` object, then the traffic mix's."""
    return {**config.get("sampler", {}), **traffic.get("sampler", {})}


def _profile_chunks(s, chunk, n, readback, sync):
    """Run n chunks under torch.profiler (the host's activity, and the
    device's on a card); returns (events, iters, wall_s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if s.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            readback(s.step_chunk(chunk, do_migrate=True))
        sync()
        wall = time.perf_counter() - t0
    events = [(e.name(), e.device_type() == DeviceType.CUDA,
               e.start_ns() / 1e3, e.end_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()]
    return events, n * chunk, wall


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, metrics=(), device: str = "cuda",
             controls=()) -> dict:
    """One run; returns the result's fields (see run.py).  controls: dtypes
    in which the reference is also put in the program's place (the
    control of `correct`); their checks go to "control_checks"."""
    import torch

    from benchmark import datagen, opmodels, trace_reduce
    from benchmark.reference import control, judge, patterns

    ctl_text = open(os.path.join(HERE, "configs", config["control"])).read()
    ctl = control.parse(ctl_text)
    C = int(traffic["chains"])
    chunk = int(traffic["chunk"])
    on_cuda = device == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="gphocs_bench_")
    try:
        data = os.path.join(tmp, "seqs.txt")
        t = time.perf_counter()
        datagen.write_seq_file(data, ctl, config["num_loci"],
                               config["locus_length"], seed)
        log(f"data: {config['num_loci']} loci of {config['locus_length']} "
            f"bp from seed {seed} in {time.perf_counter() - t:.1f} s")

        # -- set-up --
        t0 = time.perf_counter()
        from gphocs_tpu_torch.config import parse_control_text
        from gphocs_tpu_torch.sampler.driver import Sampler

        if on_cuda:
            from gphocs_tpu_torch.ops import cuda_lib

            cuda_lib.build()
        cfg = parse_control_text(ctl_text)
        cfg.mcmc.random_seed = chain_seed(seed, C)
        cfg.mcmc.start_mig = int(config["start_mig"])
        dtype = getattr(torch, config["dtype"])
        spans = {}
        t = time.perf_counter()
        s = Sampler(cfg, seq_path=data, dtype=dtype, device=device,
                    chains=C, **sampler_options(config, traffic))
        spans["ingest_s"] = time.perf_counter() - t
        t = time.perf_counter()
        s.initialize()
        sync()
        spans["init_s"] = time.perf_counter() - t

        last = {}

        def readback(out):
            st, tr = out
            host = [x.cpu() for x in tr]
            for x in st:
                x.cpu()
            last["row"] = (host[4][-1], host[5][-1])

        # as Sampler.run starts a chain: iteration 0 without migration
        # (start-mig 0), the migration rates drawn, then on
        readback(s.step_chunk(1, do_migrate=False))
        s._sample_mig_rates_device()
        for _ in range(int(traffic["warmup_chunks"])):
            readback(s.step_chunk(chunk, do_migrate=True))
        sync()
        setup_s = time.perf_counter() - t0
        log(f"set-up {setup_s:.2f} s (ingest {spans['ingest_s']:.2f} s, "
            f"initialize {spans['init_s']:.2f} s)")

        start = window_start(s)
        out = {"metrics": {}}
        if not trace:
            iters, ends = 0, []
            t1 = time.perf_counter()
            while True:
                readback(s.step_chunk(chunk, do_migrate=True))
                iters += chunk
                ends.append(time.perf_counter())
                if ends[-1] - t1 >= seconds:
                    break
            sync()
            window = time.perf_counter() - t1
            ms = sorted(1e3 * (b - a) for a, b in zip([t1] + ends, ends))
            log(f"window: {iters} iterations x {C} chains in {window:.3f} s; "
                f"chunk ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} "
                f"max {ms[-1]:.1f}")
            out["metrics"]["chain_it_per_s"] = {
                "value": C * iters / window, "unit": "it/s"}
            out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        else:
            events, iters, wall = _profile_chunks(
                s, chunk, int(traffic["trace_chunks"]), readback, sync)
        # the peak before anything but the program has used the card
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if on_cuda else 0)
        out["attempted"] = C * iters
        if trace:
            summ = trace_reduce.summarize(events, iters, wall)
            models = {}
            for b in zip(s.gens, s.seqs, s.lrngs, s.lnlds, s.conds):
                for k, v in opmodels.models(*b, s.params, ctl).items():
                    models.setdefault(k, []).append(v)
            ctx = {"spans": spans, "trace": summ, "models": models,
                   "dtype": config["dtype"]}
            for name in metrics:
                v = metric_reader(name)(ctx)
                if v is not None:
                    out["metrics"][name] = v
            out["busy_s"], out["window_s"] = summ.busy_s, wall
            out["breakdown"] = {"device_ops": summ.device_ops,
                                "idle_gaps": summ.idle_gaps}
            log(f"traced: {iters} iterations x {C} chains in {wall:.3f} s, "
                f"{summ.device_events} device operations, "
                f"{summ.launches} launches, {summ.syncs} syncs")
        prog = program_state(s, start, last["row"])
        del s
        if on_cuda:
            torch.cuda.empty_cache()

        # -- the plain reference, once the program is freed --
        t = time.perf_counter()
        pats = patterns.build(data, ctl)
        ref = judge.reference_values(prog, pats, ctl, device)
        nums = judge.numbers(prog, ref)
        out["correct"], out["checks"] = judge.verdict(nums,
                                                      config["limits"])
        out["failed"] = sum(v > lim for _, v, lim in out["checks"])
        out["control_checks"] = {
            name: judge.verdict(judge.numbers(judge.control_values(
                prog, pats, ctl, device, getattr(torch, name)), ref),
                config["limits"]) for name in controls}
        log(f"reference: {time.perf_counter() - t:.1f} s")
        out["forbidden"] = forbidden_modules()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(args) -> int:
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 3
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    metrics = [m["name"] for m in bench["per_layer"]
               if args.workload in m.get("workloads", [args.workload])]
    card = card_info()
    log(f"card: {card['kind']} x{card['count']}, power limit "
        f"{card['power_limit']}; torch {torch.__version__}; the serial C "
        f"reference does {C_REFERENCE_IT_S} it/s on sample_1k (CPU)")
    torch.cuda.reset_peak_memory_stats()
    res = run_cell(config, traffic, args.seed, args.seconds, bool(args.trace),
                   metrics)
    if res["forbidden"]:
        log(f"loaded after the window: {res['forbidden']}: no result")
        return 4
    log(f"peak memory {res['memory_peak_bytes']} bytes")
    for name, value, limit in res["checks"]:
        log(f"check {name}: {value!r} (limit {limit!r})")
    device = {"platform": "gpu", "kind": card["kind"],
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
        line["breakdown"] = res["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in res["checks"]}
    print(json.dumps(line), flush=True)
    return 0
