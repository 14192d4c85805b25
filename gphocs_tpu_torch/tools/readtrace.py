"""readTrace: block-averaged trace summaries (a copy of
gphocs_tpu/tools/readtrace.py on the port's trace reader).

Mirrors the reference bin/readTrace (src/readTrace.c): discards `-d`
burn-in rows, then prints per-block averages of every parameter column
with block size `-b`.

    python -m gphocs_tpu_torch.tools.readtrace trace.out [-d burnin] [-b block]
"""

from __future__ import annotations

import argparse

import numpy as np

from gphocs_tpu_torch.io.trace import read_trace


def summarize(path: str, discard: int = 0, block: int = 0):
    cols, rows = read_trace(path)
    rows = rows[discard:]
    if block <= 0:
        block = len(rows)
    out = []
    for start in range(0, len(rows), block):
        chunk = rows[start:start + block]
        if len(chunk) == 0:
            break
        out.append(chunk[:, 1:].mean(axis=0))
    return cols[1:], np.asarray(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="readtrace")
    ap.add_argument("trace_file")
    ap.add_argument("-d", "--discard", type=int, default=0,
                    help="number of burn-in rows to discard")
    ap.add_argument("-b", "--block", type=int, default=0,
                    help="block size for averaging (0 = whole trace)")
    args = ap.parse_args(argv)
    cols, blocks = summarize(args.trace_file, args.discard, args.block)
    print("\t".join(cols))
    for row in blocks:
        print("\t".join(f"{v:9.6f}" for v in row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
