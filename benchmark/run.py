"""The benchmark of gphocs_tpu_torch on one CUDA card: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cells, metrics and bounds are in BENCHMARK.json at the repository's
root; harness.py says what a run does.  The last line of standard output
is one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the checks of `correct`, each number beside
its limit); the checks are also the last lines of standard error.  With
no CUDA card, or fewer than the cell asks for, it prints no result and
exits with a code other than 0.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from benchmark import harness

    return harness.main(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
