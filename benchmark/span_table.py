"""The program's spans in one traced run of a cell: the run that
`run.py --trace 1` makes (harness.run_cell), with the profiler's events
kept whole (correlation ids included) and reduced by span_reduce.py.

    python benchmark/span_table.py --workload <cell> --seed <n>

Prints the span table to standard error and, as the last line of standard
output, one JSON object: `correct`, the card, the run's metrics (the
cell's per-layer metrics of BENCHMARK.json and the span metrics below),
the rows, and `checks`, how far the partition rows account for the
trace: their launches and syncs against `launches_per_iter` and
`host_syncs_per_iter`, their device ms against the trace's busy time,
the iteration spans' self share of their host time, the syncs made in
that self part, and the hand-written kernels' device ms inside the five
family groups against all of it.

The span metrics are read from `ctx["program"]`, which harness.run_cell
does not fill: this command stands in for it until the harness hands the
span rows to its readers.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness, span_reduce  # noqa: E402
from benchmark.metrics._spans import GROUPS  # noqa: E402

SPAN_METRICS = ("sweeps.host_ms", "sweeps.device_ms", "full_stats.host_ms",
                "full_stats.device_ms", "scalars.host_ms",
                "scalars.device_ms", "tau.host_ms", "tau.device_ms",
                "mixing.host_ms", "mixing.device_ms", "rng_hash.host_ms",
                "rng_hash.device_ms", "prepare.host_ms")
FAMILY_GROUPS = ("sweeps", "full_stats", "scalars", "tau", "mixing")


def traced_spans(config, traffic, seed, metrics=(), device="cuda"):
    """harness.run_cell with --trace 1, keeping the profiler's events;
    returns (the run's result, span_reduce's program, the checks)."""
    kept = {}

    def profile_chunks(s, chunk, n, readback, sync):
        # harness._profile_chunks, with the events' correlation ids
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
        kept["events"] = span_reduce.events(prof)
        return [e[:4] for e in kept["events"]], n * chunk, wall

    orig = harness._profile_chunks
    harness._profile_chunks = profile_chunks
    try:
        out = harness.run_cell(config, traffic, seed, 0.0, True, metrics,
                               device)
    finally:
        harness._profile_chunks = orig
    iters = out["attempted"] // int(traffic["chains"])
    program = span_reduce.reduce(kept["events"], iters)
    for name in SPAN_METRICS:
        v = harness.metric_reader(name)({"program": program})
        if v is not None:
            out["metrics"][name] = v
    return out, program, checks(kept["events"], program, out)


def checks(events, program, out) -> dict:
    rows, tot = program["rows"], span_reduce.totals(program)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    iteration_ms = sum(b - a for n, d, a, b, _ in events
                       if not d and n == "gphocs.iteration") / 1e3
    groups = sum(rows[n]["kernel_ms"] for g in FAMILY_GROUPS
                 for n in GROUPS[g] if n in rows)
    iters = program["iters"]
    return {
        "launches": [tot["launches"], m.get("launches_per_iter")],
        "syncs": [tot["syncs"], m.get("host_syncs_per_iter")],
        "device_ms": [tot["device_ms"], out["busy_s"] * 1e3 / iters],
        "iteration_self_share": (rows.get("iteration", {}).get("host_ms", 0)
                                 * iters / iteration_ms
                                 if iteration_ms else None),
        "iteration_self_syncs": rows.get("iteration", {}).get("syncs", 0),
        "kernel_ms_in_groups": [groups, tot["kernel_ms"]],
        "matched": program["matched"],
        "annotations": program["annotations"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA card: no result")
        return 3
    config = harness.load_json(harness.HERE, "configs",
                               cell["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                cell["traffic"] + ".json")
    metrics = [m["name"] for m in bench["per_layer"]
               if args.workload in m.get("workloads", [args.workload])]
    card = harness.card_info()
    torch.cuda.reset_peak_memory_stats()
    out, program, chk = traced_spans(config, traffic, args.seed, metrics)
    harness.log(span_reduce.table(program))
    harness.log(f"checks: {json.dumps(chk)}")
    print(json.dumps({"correct": out["correct"], "card": card,
                      "window_s": out["window_s"], "busy_s": out["busy_s"],
                      "metrics": out["metrics"], "checks": chk,
                      "program": program}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
