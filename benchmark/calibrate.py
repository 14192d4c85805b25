"""Readings for the limits of `correct`: one process runs a cell on
several seeds, each with a short window, and prints, for each seed, the
numbers that the program gives and those that the control gives (the
reference in the configuration's `control_dtype`, in the program's place).

    python benchmark/calibrate.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--out chiprun_out/calibrate.jsonl]

The limits in configs/<name>.json are set between the largest program
reading and the smallest control reading (PERF.md says how).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.log("calibrate: no CUDA device")
        return 3
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[a.workload]
    config = harness.load_json(harness.HERE, "configs",
                               cell["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                cell["traffic"] + ".json")
    card = harness.card_info()
    harness.log(f"card: {card}")
    for seed in a.seeds:
        res = harness.run_cell(config, traffic, seed, a.seconds, False,
                               controls=(config["control_dtype"],))
        row = {"workload": a.workload, "seed": seed, "card": card,
               "correct": res["correct"],
               "program": {n: v for n, v, _ in res["checks"]},
               "control": {d: {"correct": ok,
                               "numbers": {n: v for n, v, _ in rows}}
                           for d, (ok, rows) in
                           res["control_checks"].items()},
               "metrics": res["metrics"],
               "memory_peak_bytes": res["memory_peak_bytes"]}
        print(json.dumps(row), flush=True)
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
